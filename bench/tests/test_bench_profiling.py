"""The trace reduction on a hand-built trace: device busy is the union of
device activities, a host span's device mirror is no device work, and each
idle gap is named by the span and the innermost host operation in it."""

from types import SimpleNamespace as NS

import pytest
from torch.autograd import DeviceType

from benchkit import profiling


def ev(name, start, end, device=False, annotation=False):
    return NS(name=name, time_range=NS(start=start, end=end),
              device_type=DeviceType.CUDA if device else DeviceType.CPU,
              is_user_annotation=annotation)


def test_summarize():
    trace = [
        ev("bench.tick", 0, 100), ev("bench.tick", 0, 100, device=True,
                                     annotation=True),
        ev("aten::copy_", 10, 20), ev("cudaStreamSynchronize", 60, 90),
        ev("void k<1>(int)", 5, 15, device=True),
        ev("void k<2>(float)", 12, 30, device=True),    # overlaps the first
        ev("Memcpy HtoD (Pageable -> Device)", 70, 80, device=True),
        ev("bench.dispatch", 100, 200), ev("aten::unique", 110, 190),
        ev("void k<1>(int)", 195, 205, device=True),
    ]
    out = profiling.summarize(NS(events=lambda: trace))
    assert out["busy_s"] == pytest.approx((25 + 10 + 10) * 1e-6)
    assert dict(out["device_ops"]) == pytest.approx(
        {"k": 38e-6, "Memcpy HtoD (Pageable -> Device)": 10e-6})
    assert dict(out["idle_gaps"]) == pytest.approx(
        {"bench.tick": 40e-6,                      # 30..70: in the span alone
         "bench.dispatch>aten::unique": 115e-6})   # 80..195


def test_busy_within():
    # device work inside two decode spans, one outside any, one straddling
    trace = [
        ev("bench.decode_step", 0, 100), ev("bench.decode_step", 0, 100, device=True,
                                            annotation=True),
        ev("void k<1>(int)", 10, 30, device=True),
        ev("void k<2>(int)", 20, 40, device=True),       # overlaps: 10..40
        ev("bench.admit_step", 100, 200),
        ev("void k<1>(int)", 120, 150, device=True),     # another span's
        ev("bench.decode_step", 200, 300),
        ev("void k<1>(int)", 290, 320, device=True),     # 290..300 inside
    ]
    busy, n = profiling.busy_within(NS(events=lambda: trace), "decode_step")
    assert n == 2
    assert busy == pytest.approx((30 + 10) * 1e-6)
