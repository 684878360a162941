"""The port's dry-run cell (``repro_torch.launch.dryrun.run_cell``, a
256-rank fake process group in this process) against the reference's
(``repro.launch.dryrun.run_cell``, 512 host devices, run in a subprocess
so that its ``XLA_FLAGS`` stay out of this process) on one reduced cell:
smollm-360m's ``train_4k`` on the 16 x 16 mesh with the widths cut and
``d_ff`` 200 (indivisible by 16, so the MLP's shardings drop).  The shared
fields are equal; the ratio of the port's per-rank matrix FLOPs to the
reference's ``analyze`` is printed, recorded as a property of the test and
held to the dry-run's aim (``_torch_fidelity.check_cell``: 0.95-1.05; 4
heads in 2 groups on 16 ranks, which the port tiles as GSPMD does, the
heads 4 ways and the tokens 4).  A reduced glm4-9b
``prefill_32k`` cell, whose two kv groups the 16-way "model" axis does not
divide, holds that ratio within 0.95-1.05: the port shards the q heads as
GSPMD does."""

import json
import os
import subprocess
import sys
import textwrap

import torch.distributed as dist

from _torch_fidelity import check_cell
from repro_torch.launch import dryrun

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCH, SHAPE = "smollm-360m", "train_4k"
OVERRIDES = dict(n_layers=3, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
                 d_ff=200, vocab_size=4096)


HEADS_ARCH, HEADS_SHAPE = "glm4-9b", "prefill_32k"
HEADS_OVERRIDES = dict(n_layers=2, d_model=512, n_heads=32, n_kv_heads=2, head_dim=64,
                       d_ff=1024, vocab_size=4096)


def reference_cell(tmp_path, arch=ARCH, shape=SHAPE, overrides=OVERRIDES) -> dict:
    script = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
        import sys, json; sys.path.insert(0, {SRC!r})
        from repro.launch import dryrun
        res = dryrun.run_cell({arch!r}, {shape!r}, False, overrides={overrides!r})
        json.dump(res, open({str(tmp_path / "ref.json")!r}, "w"))
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(tmp_path / "ref.json") as f:
        return json.load(f)


def test_reduced_cell_matches_reference(tmp_path, record_property):
    got = dryrun.run_cell(ARCH, SHAPE, False, overrides=OVERRIDES)
    assert not dist.is_initialized()  # the fake group is gone
    want = reference_cell(tmp_path)
    assert got["status"] == want["status"] == "ok"
    assert got["dropped_shardings"]
    for key in ("cell", "fsdp", "dropped_shardings", "params", "active_params",
                "model_flops_global"):
        assert got[key] == want[key], key
    assert got["memory"]["argument_bytes"] == want["memory"]["argument_bytes"]
    assert got["xla_cost"] is None
    ratio = got["analysis"]["dot_flops"] / want["analysis"]["dot_flops"]
    assert check_cell(ARCH, SHAPE, OVERRIDES, record_property,
                      got=got)["dot_flops_ratio"] == ratio
    for key in ("compute_s", "memory_s", "collective_s", "step_s_lower_bound"):
        assert got["roofline"][key] > 0, key


def test_head_sharded_prefill_cell_matches_reference(tmp_path, record_property):
    """32 q heads in 2 kv groups on a 16-way "model" axis: each rank takes
    two heads of one group, and the per-rank matrix FLOPs stay within
    0.95-1.05 of the reference's (attention whole on every rank would be
    about 16 times them)."""
    got = dryrun.run_cell(HEADS_ARCH, HEADS_SHAPE, False, overrides=HEADS_OVERRIDES)
    want = reference_cell(tmp_path, HEADS_ARCH, HEADS_SHAPE, HEADS_OVERRIDES)
    assert got["status"] == want["status"] == "ok"
    for key in ("cell", "fsdp", "dropped_shardings", "params", "active_params",
                "model_flops_global"):
        assert got[key] == want[key], key
    assert got["memory"]["argument_bytes"] == want["memory"]["argument_bytes"]
    ratio = got["analysis"]["dot_flops"] / want["analysis"]["dot_flops"]
    print(f"dot_flops port / reference = {ratio:.4f}")
    record_property("dot_flops_ratio", ratio)
    assert dryrun.AIM[0] <= ratio <= dryrun.AIM[1], ratio


def test_a_cell_that_raises_is_recorded_as_an_error(tmp_path, monkeypatch, capsys):
    """The CLI records a cell that raises as ``status: error`` with its
    message, never skips it, and exits 1."""
    def no_strategy(*args, **kwargs):
        raise RuntimeError("no sharding strategy")

    monkeypatch.setattr(dryrun, "run_cell", no_strategy)
    assert dryrun.main(["--arch", ARCH, "--shape", SHAPE, "--out", str(tmp_path)]) == 1
    with open(tmp_path / f"{ARCH}_{SHAPE}_single_baseline.json") as f:
        res = json.load(f)
    assert res["status"] == "error" and "no sharding strategy" in res["error"]
    assert '"status": "error"' in capsys.readouterr().out
