"""Port parity, switching harnesses: trace construction against
``repro.core.switching``, boundary replay continuity (with and without
the streaming window), the control-plane baseline, and the port's
packet-path driver on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import banks, words, one_torch_thread  # noqa: F401
from repro.core import pipeline as jpipe
from repro.core import switching as jsw
from repro_torch.core import bank as tbank
from repro_torch.core import switching as tsw
from repro_torch.launch import packetpath


@pytest.mark.parametrize("kind", ["fixed", "round_robin", "random", "hotspot"])
def test_access_trace_matches_reference(kind):
    np.testing.assert_array_equal(tsw.access_trace(kind, 200, 16, seed=3),
                                  jsw.access_trace(kind, 200, 16, seed=3))


def test_boundary_trace_matches_reference():
    payload = words(np.random.default_rng(0), (24, 256))
    np.testing.assert_array_equal(tsw.boundary_trace(64, payload),
                                  jsw.boundary_trace(64, payload))


@pytest.mark.parametrize("strategy", ["fused", "take"])
@pytest.mark.parametrize("stream", [False, True])
def test_replay_boundary_trace_is_continuous(strategy, stream):
    """Zero wrong slots and verdicts across the boundary, and the same
    verdicts as the reference pipeline on the same bank."""
    jb, tb = banks(2, seed=0)
    payload = words(np.random.default_rng(0), (64, 256))
    tr = tsw.boundary_trace(64, payload)
    res = tsw.replay_trace(tb, tr, num_slots=2, batch=8, strategy=strategy,
                           stream=stream, stream_window=4)
    assert res.wrong_slot == 0
    assert res.wrong_verdict == 0
    assert res.boundary_index == 32
    assert np.all(np.diff(res.timestamps_us) >= 0)  # retire order is monotone
    want = jpipe.packet_step(jb, jnp.asarray(tr), num_slots=2, strategy="take")
    np.testing.assert_array_equal(res.verdicts, np.asarray(want.verdicts))
    np.testing.assert_array_equal(res.actions, np.asarray(want.actions))


def test_control_plane_replay_counts_stale_window():
    _, tb = banks(2, seed=1)
    payload = words(np.random.default_rng(1), (16, 256))
    tr = tsw.boundary_trace(16, payload)
    s0, s1 = tbank.select_slot(tb, 0), tbank.select_slot(tb, 1)
    res = tsw.control_plane_replay(s0, s1, tr, pacing_us=0.0)
    assert res.n_packets == 16
    assert 0 <= res.wrong_verdict_packets <= res.wrong_model_packets <= 8
    assert res.switch_latency_us > 0
    assert tsw.resident_switch_cost_us(tb, tr, 2, iters=3) > 0


def test_packetpath_driver_on_cpu(tmp_path, capsys):
    """The driver runs end to end on the CPU, from a seed and from a bank
    file saved by the reference."""
    args = ["--device", "cpu", "--packets", "128", "--batch", "32"]
    assert packetpath.main(args) == 0
    jb, _ = banks(2, seed=2)
    path = tmp_path / "bank.npz"
    np.savez(path, **{k: np.asarray(v) for k, v in jb.items()})
    res = packetpath.run(packetpath.build_parser().parse_args(
        args + ["--bank", str(path), "--stream", "--strategy", "grouped"]))
    assert (res["wrong_slot"], res["wrong_verdict"], res["slots"]) == (0, 0, 2)
    assert "wrong_slot=0 wrong_verdict=0" in capsys.readouterr().out
