"""Training launcher: the reference launcher's flags, defaults and printed
lines, plus ``--device`` (the card unless ``cpu`` is asked for)::

    python -m repro_torch.launch.train                  # the card
    python -m repro_torch.launch.train --device cpu --steps 20

Reduced configs (the default) train end to end on the CPU.  Weights are
random, drawn from a ``torch.Generator`` seeded 0, so the losses are not
the reference's; the token stream is the same.  The default checkpoint
directory lies under the temporary directory.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data.tokens import SyntheticTokens, TokenPipelineConfig
from repro_torch.device import resolve_device
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.train.optimizer import OptimizerConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m",
                    choices=[a for a in ARCH_IDS if a != "boundswitch-h32"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-gradients", action="store_true")
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_train"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--preempt-flag-file", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(remat="none")
    opt_cfg = OptimizerConfig(
        learning_rate=args.lr, warmup_steps=min(20, args.steps // 5),
        total_steps=args.steps,
        moments_dtype=cfg.moments_dtype, master_weights=cfg.master_weights,
    )
    data = SyntheticTokens(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch))
    trainer = Trainer(
        cfg, opt_cfg,
        TrainerConfig(
            total_steps=args.steps, checkpoint_every=args.checkpoint_every,
            checkpoint_dir=args.checkpoint_dir,
            preempt_flag_file=args.preempt_flag_file,
            num_microbatches=args.microbatches,
            compress_gradients=args.compress_gradients,
        ),
        data, device=dev,
    )
    if args.resume and trainer.try_restore():
        print(f"resumed at step {int(trainer.state['step'])}")
    out = trainer.run()
    print(out)
    for m in trainer.metrics_log:
        print({k: round(v, 4) for k, v in m.items()})


if __name__ == "__main__":
    main()
