"""Train a small LM end-to-end on the PyTorch/CUDA port with the full
production loop: AdamW, microbatched grad accumulation, checkpointing,
preemption-safe resume (the port of ``examples/train_lm.py``).

Run:  PYTHONPATH=src python examples/train_lm_torch.py               # CUDA
      PYTHONPATH=src python examples/train_lm_torch.py --device cpu
"""

import argparse
import tempfile

from repro_torch.configs.registry import get_config
from repro_torch.data.tokens import SyntheticTokens, TokenPipelineConfig
from repro_torch.device import resolve_device
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.train.optimizer import OptimizerConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("smollm-360m").reduced(
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab_size=1024, remat="none")
    print(f"model: {cfg.name}, {cfg.param_count()/1e6:.2f}M params")

    opt = OptimizerConfig(learning_rate=1e-3, warmup_steps=20, total_steps=args.steps)
    data = SyntheticTokens(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=64, global_batch=16))

    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(
            cfg, opt,
            TrainerConfig(total_steps=args.steps, checkpoint_every=100, log_every=25,
                          checkpoint_dir=ckpt_dir, num_microbatches=2),
            data, device=dev,
        )
        out = trainer.run()
        print(out)
        first, last = trainer.metrics_log[0], trainer.metrics_log[-1]
        print(f"loss: {first['loss']:.3f} (step {first['step']}) -> "
              f"{last['loss']:.3f} (step {last['step']})")
        if not last["loss"] < first["loss"]:
            raise SystemExit("training did not reduce loss")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
