"""The roofline and packet_mfu arithmetic against values worked by hand."""

import pytest

from benchkit import roofline


def test_slot_param_bytes():
    # 32 x 256 words of W1, 32 b1, 32 W2, 1 b2: 4 bytes each
    assert roofline.slot_param_bytes(8192, 32, 1) == 4 * (8192 + 32 + 32 + 1)


def test_fused_work_and_least_time():
    nbytes, macs = roofline.fused_work(8192, 1, d_bits=8192, hidden=32,
                                       n_out=1, num_slots=16)
    assert nbytes == 8192 * 1096 + 16 * 33028
    assert macs == 8192 * 8192 * 32
    # 9.507e6 bytes at 3.35e12 B/s beat 2.147e9 MACs at 4.9495e15/s
    assert roofline.least_seconds(nbytes, macs) == pytest.approx(
        (8192 * 1096 + 16 * 33028) / 3.35e12)
    assert roofline.least_seconds(0, 4.9495e15) == pytest.approx(1.0)


def test_packet_mfu_percent():
    # 500,000 packets in one second: 1.31072e11 MACs of 4.9495e15
    v = roofline.packet_mfu_percent(500_000, 1.0, d_bits=8192, hidden=32)
    assert v == pytest.approx(100 * 500_000 * 262144 / 4.9495e15)
    assert v == pytest.approx(2.6481e-3, rel=1e-4)
