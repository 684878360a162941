"""Online switching harnesses (paper §III-D, §III-E), torch port.

* ``replay_trace`` — replay with optional pacing; records timestamps /
  slots / verdicts to evaluate boundary continuity (Table IV).
  ``stream=True`` overlaps device work with host emission through a
  bounded window of in-flight batches, each retired by waiting on a CUDA
  event recorded after its results were queued for the host.
* ``control_plane_replay`` — the heavyweight baseline: only slot 0 is
  resident; slot 1's weights are "delivered" through a simulated control
  channel after the boundary is detected (Table V wrong-packet window).

Both paths share the identical executor; only the residency discipline
differs.
"""

from __future__ import annotations

import collections
import dataclasses
import io
import time

import numpy as np
import torch

from repro_torch.core import executor, packet as pkt, pipeline
from repro_torch.device import synchronize


# ---------------------------------------------------------------------------
# trace construction
# ---------------------------------------------------------------------------

def boundary_trace(
    n_packets: int,
    payload_words: np.ndarray,
    *,
    slot_a: int = 0,
    slot_b: int = 1,
) -> np.ndarray:
    """First half selects slot_a, second half slot_b — the paper's
    deterministic boundary stream (64-packet and 8192-packet runs)."""
    slots = np.where(np.arange(n_packets) < n_packets // 2, slot_a, slot_b)
    if payload_words.shape[0] != n_packets:
        reps = -(-n_packets // payload_words.shape[0])
        payload_words = np.tile(payload_words, (reps, 1))[:n_packets]
    return pkt.make_packets(slots, payload_words)


def access_trace(kind: str, n_packets: int, num_slots: int, seed: int = 0) -> np.ndarray:
    """Slot-access traces for the slot-scaling microbenchmark."""
    rng = np.random.default_rng(seed)
    if kind == "fixed":
        return np.zeros(n_packets, np.int64)
    if kind == "round_robin":
        return np.arange(n_packets) % num_slots
    if kind == "random":
        return rng.integers(0, num_slots, n_packets)
    if kind == "hotspot":  # 90% slot 0, rest uniform over the others
        hot = rng.random(n_packets) < 0.9
        cold = rng.integers(1, max(num_slots, 2), n_packets)
        return np.where(hot, 0, cold)
    raise ValueError(f"unknown access trace {kind!r}")


# ---------------------------------------------------------------------------
# continuity replay (Table IV)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ReplayResult:
    timestamps_us: np.ndarray   # (N,) completion time per packet
    slots: np.ndarray           # (N,) resolved slot
    verdicts: np.ndarray        # (N,) bool
    actions: np.ndarray         # (N,)
    wrong_slot: int
    wrong_verdict: int
    boundary_index: int

    def gap_stats_us(self) -> dict:
        gaps = np.diff(self.timestamps_us)
        b = self.boundary_index
        return {
            "median_gap_us": float(np.median(gaps)),
            "boundary_gap_us": float(gaps[b - 1]) if 0 < b <= len(gaps) else float("nan"),
            "max_gap_us": float(gaps.max()),
        }

    def rate_kpps(self, window: int = 512) -> dict:
        """Forwarding rate in a window before and after the boundary."""
        b = self.boundary_index
        t = self.timestamps_us

        def rate(lo, hi):
            if hi - lo < 2:
                return float("nan")
            return (hi - lo - 1) / (t[hi - 1] - t[lo]) * 1e3  # kpps

        return {
            "before_kpps": rate(max(0, b - window), b),
            "after_kpps": rate(b, min(len(t), b + window)),
        }


def _bank_device(bank) -> torch.device:
    return next(iter(bank.values())).device


def _expected(bank, packets_np: np.ndarray, num_slots: int) -> tuple[np.ndarray, np.ndarray]:
    """Ground truth (slot, verdict) for every packet under correct resolution."""
    res = pipeline.packet_step(
        bank, pkt.to_device(packets_np, _bank_device(bank)),
        num_slots=num_slots, strategy="take")
    return res.slots.cpu().numpy(), res.verdicts.cpu().numpy()


def replay_trace(
    bank,
    packets_np: np.ndarray,
    *,
    num_slots: int,
    pacing_us: float = 0.0,
    batch: int = 1,
    strategy: str = "take",
    stream: bool = False,
    stream_window: int = 8,
) -> ReplayResult:
    """Replay a packet trace through the resident-switching pipeline on the
    bank's device.

    ``pacing_us`` spaces emissions (the paper paces its 8192-run at 10 us).

    ``stream=True`` dispatches each batch without waiting: its results are
    copied to the host asynchronously and a CUDA event is recorded behind
    them; a batch is retired (its event waited on) only once more than
    ``stream_window`` batches are in flight.  Timestamps record when each
    batch's result was observed, the honest completion time under overlap.
    On the CPU every batch is complete when it returns.
    """
    dev = _bank_device(bank)
    n = packets_np.shape[0]
    exp_slots, exp_verd = _expected(bank, packets_np, num_slots)

    def step(lo: int):
        res = pipeline.packet_step(
            bank, pkt.to_device(packets_np[lo: lo + batch], dev),
            num_slots=num_slots, strategy=strategy)
        host = [t.to("cpu", non_blocking=True)
                for t in (res.slots, res.verdicts, res.actions)]
        event = None
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return host, event

    # warm up the path so the boundary is clean
    _, ev = step(0)
    if ev is not None:
        ev.synchronize()

    ts = np.empty(n)
    slots = np.empty(n, np.int64)
    verdicts = np.empty(n, bool)
    actions = np.empty(n, np.int64)
    t0 = time.perf_counter()
    next_emit = t0
    inflight: collections.deque = collections.deque()

    def retire(i: int, host, event) -> None:
        if event is not None:
            event.synchronize()
        now = (time.perf_counter() - t0) * 1e6
        j = min(i + batch, n)
        ts[i:j] = now
        slots[i:j] = host[0].numpy()[: j - i]
        verdicts[i:j] = host[1].numpy()[: j - i]
        actions[i:j] = host[2].numpy()[: j - i]

    for i in range(0, n, batch):
        if pacing_us:
            while time.perf_counter() < next_emit:
                pass
            next_emit += pacing_us * 1e-6 * batch
        host, event = step(i)
        if stream:
            inflight.append((i, host, event))
            while len(inflight) > stream_window:
                retire(*inflight.popleft())
        else:
            retire(i, host, event)
    while inflight:
        retire(*inflight.popleft())

    boundary = int(np.argmax(exp_slots != exp_slots[0])) if n else 0
    return ReplayResult(
        timestamps_us=ts,
        slots=slots,
        verdicts=verdicts,
        actions=actions,
        wrong_slot=int((slots != exp_slots).sum()),
        wrong_verdict=int((verdicts != exp_verd).sum()),
        boundary_index=boundary,
    )


# ---------------------------------------------------------------------------
# control-plane replacement baseline (Table V)
# ---------------------------------------------------------------------------

def _serialize(params: dict) -> bytes:
    """Weight file as shipped over the control socket."""
    buf = io.BytesIO()
    np.savez(buf, **{k: v.detach().cpu().numpy() for k, v in params.items()})
    return buf.getvalue()


def _deserialize(blob: bytes, device: torch.device) -> dict:
    with np.load(io.BytesIO(blob)) as z:
        return {k: torch.from_numpy(z[k]).to(device) for k in z.files}


def measure_update_latency_us(new_params: dict) -> float:
    """One control-plane update: serialize -> deliver -> deserialize ->
    copy to the device -> ready.  Median of several trials."""
    dev = _bank_device(new_params)
    blob = _serialize(new_params)
    trials = []
    for _ in range(5):
        t0 = time.perf_counter()
        _deserialize(blob, dev)
        synchronize(dev)
        trials.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(trials))


@dataclasses.dataclass
class ControlPlaneResult:
    switch_latency_us: float          # update send start -> effective
    boundary_to_effective_us: float   # detection-triggered window
    wrong_model_packets: int
    wrong_verdict_packets: int
    n_packets: int


def control_plane_replay(
    slot0_params: dict,
    slot1_params: dict,
    packets_np: np.ndarray,
    *,
    pacing_us: float = 10.0,
) -> ControlPlaneResult:
    """Replay the boundary trace with ONLY slot 0 resident.

    The control plane starts delivering slot-1 weights when the first
    boundary packet is observed.  Until the update is effective,
    post-boundary packets are processed by the stale model; each one whose
    verdict differs from the correct model's verdict is a wrong-verdict
    event.  Each packet runs alone through the single-slot executor.
    """
    dev = _bank_device(slot0_params)
    n = packets_np.shape[0]
    want_slots = np.asarray(packets_np[:, pkt.SLOT_WORD], np.int64)
    boundary = int(np.argmax(want_slots != want_slots[0]))

    payload = pkt.to_device(packets_np[:, pkt.META_WORDS:], dev)
    # verdicts under each model, precomputed (numerics only; timing below)
    v0 = (executor.forward(slot0_params, payload)[:, 0] > 0).cpu().numpy()
    v1 = (executor.forward(slot1_params, payload)[:, 0] > 0).cpu().numpy()

    update_us = measure_update_latency_us(slot1_params)

    active = slot0_params
    executor.forward(active, payload[:1])
    synchronize(dev)
    t0 = time.perf_counter()
    detect_t = None
    effective_t = None
    wrong_model = 0
    wrong_verdict = 0
    next_emit = t0
    for i in range(n):
        while time.perf_counter() < next_emit:
            pass
        next_emit += pacing_us * 1e-6
        now = time.perf_counter()
        if detect_t is None and want_slots[i] != want_slots[0]:
            detect_t = now  # boundary observed -> control plane starts sending
        if detect_t is not None and effective_t is None:
            if (now - detect_t) * 1e6 >= update_us:
                active = slot1_params  # swap becomes effective
                effective_t = now
        stale = i >= boundary and effective_t is None
        executor.forward(active, payload[i: i + 1])
        synchronize(dev)
        if stale:
            wrong_model += 1
            if v0[i] != v1[i]:
                wrong_verdict += 1
    if effective_t is None:
        effective_t = time.perf_counter()
    if detect_t is None:
        detect_t = effective_t
    return ControlPlaneResult(
        switch_latency_us=update_us,
        boundary_to_effective_us=(effective_t - detect_t) * 1e6,
        wrong_model_packets=wrong_model,
        wrong_verdict_packets=wrong_verdict,
        n_packets=n,
    )


def resident_switch_cost_us(bank, packets_np: np.ndarray, num_slots: int,
                            iters: int = 200) -> float:
    """Operation-level resident switching cost per packet: the time of
    slot resolution alone (the same definition as the slot-selection
    microbenchmark)."""
    dev = _bank_device(bank)
    x = pkt.to_device(packets_np, dev)

    def f():
        pipeline.slot_select_only(x, num_slots)
        synchronize(dev)

    f()
    t0 = time.perf_counter()
    for _ in range(iters):
        f()
    per_call_us = (time.perf_counter() - t0) / iters * 1e6
    return per_call_us / packets_np.shape[0]
