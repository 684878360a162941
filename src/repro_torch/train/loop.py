"""Fault-tolerant training loop (torch port of the reference's
``repro.train.loop``).

* periodic checkpointing through ``repro_torch.checkpoint.store`` (atomic
  commit, keep-last-N GC), in the reference's tree and leaf names, so a
  checkpoint written by either package's trainer resumes in the other,
* preemption: SIGTERM or a flag file triggers an immediate checkpoint and
  a return with status ``"preempted"``,
* exact resume: optimizer state, step counter and the data-pipeline cursor
  are part of the checkpoint; restart reproduces the identical stream,
* straggler monitor: per-step wall times feed an EWMA; hosts slower than
  ``factor`` x the fleet median are flagged for data-shard reassignment.

The trainer runs on its device (``device=None``: the card).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokens import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts_lib


# ---------------------------------------------------------------------------
# straggler monitoring
# ---------------------------------------------------------------------------

class StragglerMonitor:
    def __init__(self, n_hosts: int, factor: float = 1.5, alpha: float = 0.3):
        self.ewma = np.zeros(n_hosts)
        self.factor = factor
        self.alpha = alpha
        self.initialized = False

    def observe(self, per_host_seconds: np.ndarray) -> list[int]:
        """Update with one step's per-host times; returns flagged host ids."""
        if not self.initialized:
            self.ewma = per_host_seconds.astype(float).copy()
            self.initialized = True
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * per_host_seconds
        med = np.median(self.ewma)
        return [int(i) for i in np.nonzero(self.ewma > self.factor * med)[0]]

    def reassignment_plan(self, flagged: list[int], n_shards: int) -> dict[int, int]:
        """Move one data shard from each flagged host to the fastest host."""
        if not flagged:
            return {}
        fastest = int(np.argmin(self.ewma))
        return {h: fastest for h in flagged if h != fastest}


def n_hosts() -> int:
    """The ``torch.distributed`` world size where a group is initialised,
    else 1."""
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    keep_last: int = 3
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    preempt_flag_file: Optional[str] = None
    log_every: int = 10
    num_microbatches: int = 1
    compress_gradients: bool = False


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        opt_cfg: opt_lib.OptimizerConfig,
        tcfg: TrainerConfig,
        data: SyntheticTokens,
        *,
        seed: int = 0,
        make_batch: Optional[Callable] = None,
        device=None,
    ):
        self.cfg, self.opt_cfg, self.tcfg, self.data = cfg, opt_cfg, tcfg, data
        self.device = resolve_device(device)
        self._preempted = False
        self.make_batch = make_batch or (lambda b: {
            k: torch.from_numpy(np.asarray(v)).to(self.device) for k, v in b.items()})
        self.step_fn = ts_lib.make_train_step(
            cfg, opt_cfg,
            num_microbatches=tcfg.num_microbatches,
            compress_gradients=tcfg.compress_gradients,
        )
        self.state = ts_lib.init_train_state(seed, cfg, opt_cfg, device=self.device)
        self.metrics_log: list[dict] = []
        self.monitor = StragglerMonitor(n_hosts=n_hosts())

    # ------------------------------------------------------------------
    def _install_signal_handler(self):
        def handler(signum, frame):
            self._preempted = True
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not on the main thread (tests)

    def _should_preempt(self) -> bool:
        if self._preempted:
            return True
        f = self.tcfg.preempt_flag_file
        return bool(f and os.path.exists(f))

    # ------------------------------------------------------------------
    def save(self):
        store.save(
            self.tcfg.checkpoint_dir, int(self.state["step"]),
            ts_lib.state_tree(self.state),
            extra={"data_cursor": self.data.cursor, "model": self.cfg.name},
            keep_last=self.tcfg.keep_last,
        )

    def try_restore(self) -> bool:
        latest = store.latest_step(self.tcfg.checkpoint_dir)
        if latest is None:
            return False
        tree, extra = store.restore(self.tcfg.checkpoint_dir, latest,
                                    ts_lib.state_tree(self.state), device=self.device)
        ts_lib.load_state(self.state, tree)
        self.data.restore(extra["data_cursor"])
        return True

    # ------------------------------------------------------------------
    def run(self) -> dict:
        """Returns {"status": "done"|"preempted", "steps_run": n}."""
        self._install_signal_handler()
        steps_run = 0
        while int(self.state["step"]) < self.tcfg.total_steps:
            if self._should_preempt():
                self.save()
                return {"status": "preempted", "steps_run": steps_run}
            t0 = time.perf_counter()
            batch = self.make_batch(next(self.data))
            self.state, metrics = self.step_fn(self.state, batch)
            step = int(self.state["step"])
            m = {k: float(v) for k, v in metrics.items()}  # waits for the step
            dt = time.perf_counter() - t0
            self.monitor.observe(np.array([dt]))
            steps_run += 1
            if step % self.tcfg.log_every == 0 or step == 1:
                m["step"] = step
                m["sec_per_step"] = dt
                self.metrics_log.append(m)
            if step % self.tcfg.checkpoint_every == 0:
                self.save()
        self.save()
        return {"status": "done", "steps_run": steps_run}
