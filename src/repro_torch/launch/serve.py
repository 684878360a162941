"""Serving launcher: batched requests with per-request model-slot routing.

The reference launcher's flags, defaults and printed lines, plus
``--device`` (the card unless ``cpu`` is asked for)::

    python -m repro_torch.launch.serve                       # the card
    python -m repro_torch.launch.serve --device cpu --arch mamba2-130m

Weights are random, drawn from a ``torch.Generator`` seeded 0, so the
served tokens are not the reference's.  ``--arch seamless-m4t-medium``
fails as the reference's does: the engine's prefill feeds tokens only, and
the encoder-decoder needs frame embeddings.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serve.engine import Request, ServeEngine


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m",
                    choices=[a for a in ARCH_IDS if a != "boundswitch-h32"])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced(remat="none")
    params = api.init(0, cfg, device=dev)
    engine = ServeEngine(params, cfg, max_batch=args.max_batch,
                         max_seq=args.max_seq, device=dev)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(args.requests):
        prompt = list(rng.integers(0, cfg.vocab_size, int(rng.integers(4, 48))))
        slot = int(rng.integers(0, args.slots)) if cfg.bank_mode != "none" else 0
        engine.submit(Request(rid=i, prompt=prompt, slot_id=slot,
                              max_new_tokens=args.max_new_tokens))
    finished = engine.run_until_done()
    dt = time.perf_counter() - t0
    tokens = sum(len(f.output) for f in finished)
    print(f"served {len(finished)} requests, {tokens} tokens in {dt:.2f}s "
          f"({tokens/dt:.1f} tok/s), {engine.ticks} ticks, "
          f"rejected {engine.rejected_count}")
    lat = sorted(f.latency_s for f in finished if not f.rejected)
    if lat:
        print(f"latency p50={lat[len(lat)//2]*1e3:.1f}ms "
              f"p99={lat[int(len(lat)*0.99)]*1e3:.1f}ms")


if __name__ == "__main__":
    main()
