"""End-to-end serving example on the PyTorch/CUDA port (the paper's kind:
serve a small model with batched requests) — BoundSwitch's technique lifted
to LLM serving.

A smollm-family model carries a K=2 resident adapter bank; each request's
metadata selects its slot, and the engine routes every prefill/decode step
through the bank at request granularity with zero engine reconfiguration.
The weights are random, drawn from ``torch.Generator``s seeded 0 and 7, so
the tokens are not the reference example's (which draws from
``jax.random``).

Run:  PYTHONPATH=src python examples/serve_bank_torch.py             # CUDA
      PYTHONPATH=src python examples/serve_bank_torch.py --device cpu
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    dev = resolve_device(ap.parse_args(argv).device)

    cfg = get_config("smollm-360m").reduced(
        bank_mode="adapter", bank_slots=2, remat="none", dtype="float32",
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256)
    params = api.init(0, cfg, device=dev)

    # give slot 1 a distinct behavior (in production: per-tenant finetuned deltas)
    gen = torch.Generator(device=dev).manual_seed(7)
    with torch.no_grad():
        for name, p in params.named_parameters():
            if name.endswith("adapter.b"):
                p[1] = torch.randn(p.shape[1:], generator=gen, device=dev) * 0.3

    engine = ServeEngine(params, cfg, max_batch=4, max_seq=128,
                         prefill_buckets=(16, 64), device=dev)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(12):
        engine.submit(Request(
            rid=i,
            prompt=list(rng.integers(0, cfg.vocab_size, int(rng.integers(4, 16)))),
            slot_id=i % 2,                    # the reg0 analogue
            max_new_tokens=8,
        ))
    finished = engine.run_until_done()
    dt = time.perf_counter() - t0

    tokens = sum(len(f.output) for f in finished)
    print(f"served {len(finished)} requests / {tokens} tokens in {dt:.2f}s "
          f"({engine.ticks} engine ticks) on {dev}")
    by_slot = {0: [], 1: []}
    for f in sorted(finished, key=lambda f: f.rid):
        by_slot[f.rid % 2].append(tuple(f.output[:4]))
        print(f"  rid={f.rid} slot={f.rid % 2} out={f.output}")
    print("\ndistinct slot behaviors on the shared engine:",
          set(by_slot[0]) != set(by_slot[1]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
