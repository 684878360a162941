"""Helpers shared by the port's parity tests (``test_torch_*.py``): the
same NumPy inputs go through the JAX reference and the torch port."""

import jax
import numpy as np
import pytest
import torch

from repro.core import executor as jexecutor
from repro_torch.core import bank as tbank
from repro_torch.core import packet as tpkt

CPU = torch.device("cpu")

# Layer 2 sums its H products in another order in each implementation, so
# f32 scores agree to a few ulps, not bit for bit.
SCORE_ATOL = 1e-5
SCORE_RTOL = 1e-6
# Rows whose |score| is above this cannot flip a verdict by summation order.
MARGIN = 1e-4


def banks(num_slots: int, cfg=jexecutor.H32, seed: int = 0):
    """A reference bank from ``executor.init_bank`` and the same bank
    carried into the port with ``from_jax_bank``."""
    jb = jexecutor.init_bank(jax.random.PRNGKey(seed), num_slots, cfg)
    return jb, tbank.from_jax_bank({k: np.asarray(v) for k, v in jb.items()}, CPU)


def words(rng, shape) -> np.ndarray:
    return rng.integers(0, 2**32, shape, dtype=np.uint32)


def to_t(a: np.ndarray) -> torch.Tensor:
    """uint32 words -> int32 CPU tensor with the same bits."""
    return tpkt.to_device(a, CPU)


def packets(rng, b: int, num_slots: int, payload_words: int = tpkt.PAYLOAD_WORDS):
    """Random packets with random slots and a random monitor-only bit.

    Payloads shorter than the paper's 256 words (small test configs) are
    zero-extended into the fixed packet layout and sliced back by
    ``payload_words``."""
    payload = np.zeros((b, tpkt.PAYLOAD_WORDS), np.uint32)
    payload[:, :payload_words] = words(rng, (b, payload_words))
    p = tpkt.make_packets(rng.integers(0, num_slots, b), payload)
    p[:, tpkt.CONTROL_WORD_LO] = rng.integers(0, 2, b, dtype=np.uint32)
    return p[:, :tpkt.META_WORDS + payload_words]


def assert_scores(got: torch.Tensor, want) -> None:
    """Scores agree within the stated tolerance, and every row is far
    enough from 0 that its verdict cannot depend on summation order."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=SCORE_ATOL,
                               rtol=SCORE_RTOL)
    assert np.all(np.abs(want) > MARGIN), "a row sits on the decision boundary"


def numpy_bank(bank: dict) -> dict:
    """A port bank as the reference's NumPy arrays (``w1p`` as uint32)."""
    out = {}
    for name, leaf in bank.items():
        arr = leaf.cpu().numpy()
        out[name] = arr.view(np.uint32) if arr.dtype == np.int32 else arr
    return out


def assert_equal(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run a test's torch work on one intra-op thread: the port's CPU work
    in the parity tests is many small operations, and parallel test workers
    that each spin a thread per core oversubscribe the machine.  Autouse in
    every test module that imports it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# Wall-clock fields of epoch records, never compared across packages.
TIME_FIELDS = ("apply_latency_us", "apply_us")


def untimed(log):
    """Epoch records without their wall-clock fields."""
    return [{k: v for k, v in e.items() if k not in TIME_FIELDS} for e in log]


def mesh_state(mesh) -> dict:
    """Everything a mesh run decides, for equality across packages:
    completion streams, drops, RETA, conservation, the epoch log and its
    barrier stamps, health, fault events and the mesh counters."""
    snap = mesh.snapshot()
    return dict(
        seq=mesh.completed_seq, verdicts=mesh.completed_verdicts,
        slots=mesh.completed_slots, dropped=mesh.dropped_seq,
        reta=np.asarray(mesh.reta).tolist(), failed=sorted(mesh.failed_queues),
        audit=mesh.audit_conservation(), log=untimed(mesh.control.command_log()),
        continuity=mesh.control.continuity_audit(), barrier=mesh.barrier_log,
        health=mesh.health.snapshot(), events=snap["fault_events"],
        counters=(mesh.telemetry.slot_swaps, mesh.telemetry.reta_updates,
                  mesh.telemetry.degraded_commits, mesh.telemetry.wrong_verdict),
        failover=list(mesh.failover_epochs), restore=list(mesh.restore_epochs),
        shard_ticks=[s._tick_count for s in mesh.shards],
        completed_total=snap["completed_total"])
