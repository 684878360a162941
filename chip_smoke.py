#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` for ``sm_90a``, one compiler process per source, all at once;
3. holds each kernel against its plain PyTorch version at the paper's full
   H32 width (d = 8192, H = 32, C = 1) with K in {2, 16} slots and B = 8192
   packets: the fused kernel in gather mode with ``meta_words=16`` and
   actions, in gather mode with ``meta_words=0``, and in contiguous mode;
   ``xnor_matmul`` at B in {1, 8192}.  Integers and actions must be equal,
   scores within atol 1e-5 (layer 2 sums in another order);
4. drives the port's main path through its entry points, each part with the
   launch counts set to 0 just before it and read just after:
   ``repro_torch.launch.packetpath`` on an 8192-packet K = 2 boundary trace
   (must give wrong_slot = wrong_verdict = 0), ``packet_step`` with the
   fused, grouped and grouped_staged strategies on K = 2 and K = 16 random
   access traces (slots, verdicts and actions equal to the take strategy's),
   ``inference_only`` on 8192 payloads and the single-packet control-plane
   replay.  Every kernel must have been launched in its part;
5. profiles one fused ``packet_step`` (K = 2, B = 8192): device time by
   operator and the device's idle share.

The second-to-last line of output is one JSON object listing every kernel
with its launches, error, time, plain-version time and bound; the last line
is ``{"ok": true, "device": {...}}``.  A kernel's ``ms`` is its device time,
from CUDA events around calls queued behind a busy-wait kernel; ``call_ms``
(the wrapper call, host overhead included) and ``plain_ms`` are CUDA-event
medians over back-to-back calls.
Inputs stay in the 50 MB L2 cache between calls.  A ``design_ceilings``
line before it gives the POPC-issue ceiling of the kernels' design,
computed from the row count and the card's clock, not measured.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the peak rate of their type.
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12   # a binary dot product is an int8 MAC per bit
FP32_OPS_PER_S = 67e12
POPC_PER_CLOCK_PER_SM = 16        # compute capability 9.0 instruction throughput
N, BLOCK_B = 8192, 256
ATOL, RTOL = 1e-5, 1e-6


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi(query: str, extra: str = "") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format=csv,noheader{extra}"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def kernel_device_ms(call, iters: int = 20, repeats: int = 5) -> float:
    """Device time per call of ``call``, which launches one kernel and no
    other device work: the median over ``repeats`` of CUDA events around
    ``iters`` calls.  A busy-wait kernel holds the stream while the host
    queues the calls, so the events see the kernels back to back and none
    of the wrapper's host time.  Where the busy-wait ended before the host
    had queued them all, it is doubled and that repeat is made again."""
    import numpy as np
    import torch

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    cycles, times = 1 << 24, []
    while len(times) < repeats:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            call()
        end.record()
        queued_ahead = not start.query()
        end.synchronize()
        if queued_ahead:
            times.append(start.elapsed_time(end) / iters)
        elif cycles >= 1 << 32:
            fail("the host could not queue the calls ahead of the device")
        else:
            cycles *= 2
    return float(np.median(times))


def profile_step(step, iters: int = 20, top: int = 8) -> dict:
    """Where one call of ``step`` spends device time: each device activity
    (kernel, copy, memset) from ``torch.profiler``, and the device's idle
    share of the step's wall time, the wall time taken without the
    profiler (its host overhead would inflate the idle share)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6 / iters
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
    acts = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in acts) / iters
    return {
        "wall_us_per_step": wall_us,
        "device_busy_us_per_step": busy_us,
        "device_idle_share": 1 - busy_us / wall_us,
        "top_device_activities": [
            {"name": e.key[:90], "calls_per_step": e.count / iters,
             "device_us_per_step": e.self_device_time_total / iters}
            for e in acts[:top]],
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    from repro_torch.core import bank as bank_lib
    from repro_torch.core import executor, packet as pkt, pipeline, switching
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import bnn_xnor, fused_forward as ff
    from repro_torch.launch import packetpath

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = executor.H32
    H, C, W, D = cfg.hidden, cfg.n_out, cfg.words, cfg.d_bits

    # -- 1. the card ----------------------------------------------------------
    print(nvidia_smi("name,power.limit"), flush=True)
    clock_mhz = float(nvidia_smi("clocks.max.sm", ",nounits"))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{name}]: {line.strip()}")
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s", flush=True)

    def time_ms(fn, iters: int, repeats: int = 5) -> float:
        """Median over ``repeats`` of the mean time of ``iters`` calls."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / iters)
        return float(np.median(times))

    def bound(nbytes: int, int8_ops: float, fp32_ops: float) -> tuple[float, str]:
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = int8_ops / INT8_TENSOR_OPS_PER_S + fp32_ops / FP32_OPS_PER_S
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"

    ceilings = []

    def popc_ceiling(name: str, rows: int) -> None:
        """The warp-per-row design's POPC-issue ceiling: computed from the
        row count and the card's clock, not measured, so it is printed on
        a line of its own and kept out of the ``kernels`` line."""
        ceilings.append({"name": name, "rows": rows, "popc_ceiling_ms": rows * H * W / (
            POPC_PER_CLOCK_PER_SM * n_sm * clock_mhz * 1e6) * 1e3})

    def nbytes(*ts) -> int:
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    # -- 3. each kernel against its plain version at full width ---------------
    # Bring the clocks up from idle before the first timing.
    a = torch.randn(4096, 4096, device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        a @ a
        torch.cuda.synchronize()
    entries = {}

    def record(key, name, source, replaces, err, run_k, run_p, b_ms, b_by):
        """Time the kernel (device time) and its plain version (CUDA events
        around whole calls), and keep the kernel's line entry."""
        ms = kernel_device_ms(run_k)
        call_ms, plain_ms = time_ms(run_k, 20), time_ms(run_p, 3)
        entries[key] = {"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": 0,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                        "call_ms": call_ms}
        print(f"check {name}: max_abs_err={err:.3g} ms={ms:.5f} call_ms={call_ms:.5f} "
              f"plain_ms={plain_ms:.5f} bound_ms={b_ms:.5f} ({b_by})", flush=True)

    def packets_for(rng, k):
        payload = rng.integers(0, 2**32, (N, pkt.PAYLOAD_WORDS), dtype=np.uint32)
        p = pkt.make_packets(rng.integers(0, k, N), payload)
        p[:, pkt.CONTROL_WORD_LO] = rng.integers(0, 2, N, dtype=np.uint32)
        return pkt.to_device(p, dev)

    fused_src = "src/repro_torch/kernels/csrc/fused_forward.cu"
    fused_tpu = "src/repro/kernels/fused_forward.py:229"
    banks = {}
    for k in (2, 16):
        rng = np.random.default_rng(k)
        bank = executor.init_bank(rng, k, device=dev)
        x = packets_for(rng, k)
        banks[k] = (bank, x)
        g = bank_lib.group_by_slot_padded(pkt.slot_of(x, k), k, BLOCK_B)
        payload = pkt.payload_of(x)
        x_pad = bank_lib.scatter_padded(payload, g)
        bank_args = (bank["w1p"], bank["b1"], bank["w2"], bank["b2"])
        cases = [
            ("gather/meta16/actions", x, g.row_ids, 16, True),
            ("gather/meta0", payload, g.row_ids, 0, False),
            ("contiguous/meta0", x_pad, None, 0, False),
        ]
        for variant, xin, rows, meta, act in cases:
            kw = dict(block_b=BLOCK_B, meta_words=meta, with_actions=act)
            run_k = lambda: ff.fused_forward(xin, *bank_args, g.block_slots, rows, **kw)  # noqa: E731
            run_p = lambda: ff.fused_forward_ref(xin, *bank_args, g.block_slots, rows, **kw)  # noqa: E731
            got, want = run_k(), run_p()
            torch.cuda.synchronize()
            if act:
                if not torch.equal(got[1], want[1]):
                    fail(f"{variant} K={k}: actions differ in "
                         f"{int((got[1] != want[1]).sum())} rows")
                got, want = got[0], want[0]
            if not torch.allclose(got, want, atol=ATOL, rtol=RTOL):
                fail(f"{variant} K={k}: scores differ by {float((got - want).abs().max())}")
            n_rows = g.b_pad
            # With metadata, a packet's bytes read are its payload and the
            # one 32-byte sector holding the control word, not the whole row.
            x_bytes = xin.shape[0] * (W * 4 + 32) if meta else nbytes(xin)
            b_ms, b_by = bound(
                x_bytes + nbytes(rows, g.block_slots, *bank_args)
                + n_rows * C * 4 + (n_rows * 4 if act else 0),
                2.0 * n_rows * H * D, 2.0 * n_rows * H * C)
            name = f"fused_forward {variant} K={k}"
            record(f"{variant}/K{k}", name, fused_src, fused_tpu,
                   float((got - want).abs().max()), run_k, run_p, b_ms, b_by)
            popc_ceiling(name, n_rows)

    bank, x = banks[2]
    w = bank["w1p"][0]
    for b in (1, N):
        xin = pkt.payload_of(x)[:b]
        run_k = lambda: bnn_xnor.xnor_matmul(xin, w)  # noqa: E731
        run_p = lambda: ref.xnor_matmul_ref(xin, w)  # noqa: E731
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"xnor_matmul B={b}: {int((got != want).sum())} dot products differ")
        b_ms, b_by = bound(nbytes(xin, w) + b * H * 4, 2.0 * b * H * D, 0.0)
        record(f"xnor/B{b}", f"xnor_matmul B={b}",
               "src/repro_torch/kernels/csrc/xnor_matmul.cu",
               "src/repro/kernels/bnn_xnor.py:79", 0.0, run_k, run_p, b_ms, b_by)
        popc_ceiling(f"xnor_matmul B={b}", b)

    # -- 4. the main path, each part with the counts set to 0 around it --------
    def counted(part):
        """Run ``part`` with every launch count set to 0 just before it;
        return its result and the counts read just after."""
        ff.fused_forward.launches.clear()
        bnn_xnor.xnor_matmul.launches = 0
        result = part()
        torch.cuda.synchronize()
        return result, dict(ff.fused_forward.launches), bnn_xnor.xnor_matmul.launches

    end_to_end = {}

    def boundary_replay():
        res = packetpath.run(packetpath.build_parser().parse_args(
            ["--packets", str(N), "--slots", "2", "--seed", "0",
             "--strategy", "fused", "--stream"]))
        if res["wrong_slot"] or res["wrong_verdict"]:
            fail(f"boundary replay: wrong_slot={res['wrong_slot']} "
                 f"wrong_verdict={res['wrong_verdict']}")
        end_to_end["packetpath_fused_K2_mpps"] = res["mpps"]

    _, fused_launches, _ = counted(boundary_replay)
    entries["gather/meta16/actions/K2"]["launches"] = fused_launches.get(
        "gather/meta16/actions", 0)

    strategy_variant = {"fused": "gather/meta16/actions", "grouped": "gather/meta0",
                        "grouped_staged": "contiguous/meta0"}
    for k in (2, 16):
        bank, _ = banks[k]
        rng = np.random.default_rng(100 + k)
        slots = switching.access_trace("random", N, k, seed=k)
        payload = rng.integers(0, 2**32, (N, pkt.PAYLOAD_WORDS), dtype=np.uint32)
        p = pkt.make_packets(slots, payload)
        p[:, pkt.CONTROL_WORD_LO] = rng.integers(0, 2, N, dtype=np.uint32)
        xk = pkt.to_device(p, dev)
        base = pipeline.packet_step(bank, xk, num_slots=k, strategy="take")
        for strategy, variant in strategy_variant.items():
            res, launches, _ = counted(lambda: pipeline.packet_step(
                bank, xk, num_slots=k, strategy=strategy))
            for field in ("slots", "verdicts", "actions"):
                if not torch.equal(getattr(res, field), getattr(base, field)):
                    fail(f"packet_step {strategy} K={k}: {field} differ from take")
            if not torch.allclose(res.scores, base.scores, atol=ATOL, rtol=RTOL):
                fail(f"packet_step {strategy} K={k}: scores differ from take")
            key = f"{variant}/K{k}"
            if key != "gather/meta16/actions/K2":
                entries[key]["launches"] = launches.get(variant, 0)
            ms = time_ms(lambda: pipeline.packet_step(
                bank, xk, num_slots=k, strategy=strategy), 20)
            end_to_end[f"packet_step_{strategy}_K{k}_mpps"] = N / ms / 1e3
            print(f"packet_step {strategy} K={k}: {N / ms / 1e3:.3f} Mpps "
                  f"({ms:.4f} ms per {N}-packet batch)", flush=True)

    bank, x = banks[2]
    slot0, slot1 = bank_lib.select_slot(bank, 0), bank_lib.select_slot(bank, 1)
    y, _, n = counted(lambda: pipeline.inference_only(slot0, pkt.payload_of(x)))
    want = executor.forward(slot0, pkt.payload_of(x), backend="ref")
    if not torch.allclose(y, want, atol=ATOL, rtol=RTOL):
        fail("inference_only differs from its plain version")
    entries[f"xnor/B{N}"]["launches"] = n

    trace = switching.boundary_trace(256, pkt.payload_of(x)[:256].cpu().numpy().view(np.uint32))
    cp, _, n = counted(lambda: switching.control_plane_replay(slot0, slot1, trace))
    if not 0 <= cp.wrong_verdict_packets <= cp.wrong_model_packets <= 128:
        fail(f"control-plane replay counts out of range: {cp}")
    entries["xnor/B1"]["launches"] = n
    end_to_end["control_plane_switch_latency_us"] = cp.switch_latency_us

    for e in entries.values():
        if e["launches"] < 1:
            fail(f"{e['name']} was not launched on the main path")

    # -- 5. where the time of one fused packet_step goes (K = 2, B = 8192) ----
    bank, x = banks[2]
    print(json.dumps({"profile": profile_step(
        lambda: pipeline.packet_step(bank, x, num_slots=2, strategy="fused"))}))
    print(json.dumps({"end_to_end": end_to_end}))
    print(json.dumps({"design_ceilings": ceilings}))
    print(json.dumps({"kernels": list(entries.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
