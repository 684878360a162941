"""The port stands alone: no module of ``repro_torch``, not its quickstart,
not ``chip_smoke.py`` and no script of ``benchmarks_torch`` imports JAX, the
JAX package or ``msgpack`` (the card's machine lacks it); entry points refuse to
fall back to the CPU when CUDA is absent; the chip smoke script fails
without a card or outside the repo; every kernel source is wired to its
ctypes signature."""

import ast
import importlib.util
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import bank as tbank
from repro_torch.core import executor as texecutor
from repro_torch.kernels import _build
from repro_torch.dataplane import MeshDataplane, workloads
from repro_torch.launch import packetpath
from repro_torch.train import bnn

ROOT = pathlib.Path(__file__).resolve().parents[1]
QUICKSTART = ROOT / "examples" / "quickstart_torch.py"
PIPELINE_EXAMPLE = ROOT / "examples" / "packet_pipeline_torch.py"
FIG8M = ROOT / "benchmarks_torch" / "fig8m_megastep.py"
FIG10 = ROOT / "benchmarks_torch" / "fig10_mesh.py"
FIG12 = ROOT / "benchmarks_torch" / "fig12_faults.py"
FIG13 = ROOT / "benchmarks_torch" / "fig13_obs.py"
FIG14 = ROOT / "benchmarks_torch" / "fig14_deploy.py"
PAPER_FIGURES = [ROOT / "benchmarks_torch" / f"{name}.py" for name in (
    "fig4_runtime", "fig5_scaling", "fig6_slot_behavior", "fig7_fused",
    "table4_continuity", "table5_controlplane")]
DATAPLANE_FIGURES = [ROOT / "benchmarks_torch" / f"{name}.py" for name in (
    "fig8_dataplane", "fig9_control", "fig11_workloads", "fig15_swap", "run")]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", QUICKSTART, PIPELINE_EXAMPLE] + sorted(
    (ROOT / "benchmarks_torch").glob("*.py"))


def _imported_modules(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_imports_neither_jax_nor_reference(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "msgpack"), f"{path.name} imports {name}"


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_entry_points_raise_without_cuda(no_cuda):
    rng = np.random.default_rng(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        texecutor.init_bank(rng, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        texecutor.init_params(rng)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbank.from_jax_bank({"b1": np.zeros((2, 4), np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        texecutor.pack_real_weights(np.ones((2, 32)), np.zeros(2),
                                    np.zeros((1, 2)), np.zeros(1))
    with pytest.raises(RuntimeError, match="CUDA"):
        packetpath.main(["--packets", "16"])
    with pytest.raises(RuntimeError, match="CUDA"):
        bnn.train_slot_pair(epochs=1, samples_per_group=8)
    trace = workloads.synthesize(workloads.emergency_phases(2), num_slots=2,
                                 num_queues=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        workloads.make_runtime(trace)
    cpu_bank = texecutor.init_bank(rng, 2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        MeshDataplane(cpu_bank, hosts=2, num_queues=2)
    two_hosts = workloads.synthesize(
        workloads.make_workload("chaos-host-failover", num_slots=2, num_queues=2,
                                hosts=2).phases, num_slots=2, num_queues=4)
    two_hosts.meta.update(hosts=2, queues_per_host=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        workloads.make_runtime(two_hosts)
    for path in (QUICKSTART, FIG8M, FIG10, FIG12, *PAPER_FIGURES):
        spec = importlib.util.spec_from_file_location(path.stem, path)
        script = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(script)
        with pytest.raises(RuntimeError, match="CUDA"):
            script.main([])
    # an explicit CPU request is honoured
    assert texecutor.init_bank(rng, 2, device="cpu")["w1p"].device.type == "cpu"


def test_observability_and_deploy_raise_without_cuda(no_cuda, tmp_path):
    """The new entry points default to the card too: the trainer, the
    checkpoint restore and the fig13/fig14 scripts."""
    from repro_torch.checkpoint import store
    from repro_torch.deploy import OnlineTrainer

    with pytest.raises(RuntimeError, match="CUDA"):
        OnlineTrainer()
    store.save(str(tmp_path), 0, {"x": torch.ones(2)})
    with pytest.raises(RuntimeError, match="CUDA"):
        store.restore(str(tmp_path), 0, {"x": torch.ones(2)}, device=None)
    assert store.restore(str(tmp_path), 0, {"x": torch.ones(2)},
                         device="cpu")[0]["x"].device.type == "cpu"
    for path in (FIG13, FIG14):
        spec = importlib.util.spec_from_file_location(path.stem, path)
        script = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(script)
        with pytest.raises(RuntimeError, match="CUDA"):
            script.main([])


def test_cli_figures_and_suite_raise_without_cuda(no_cuda):
    """The data-plane CLI, the four data-plane figures, the suite runner
    and the pipeline example default to the card too."""
    from repro_torch.launch import dataplane

    with pytest.raises(RuntimeError, match="CUDA"):
        dataplane.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        dataplane.main(["--trace", "replay", "missing.bswt"])
    for path in (*DATAPLANE_FIGURES, FIG8M, PIPELINE_EXAMPLE):
        spec = importlib.util.spec_from_file_location(path.stem, path)
        script = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(script)
        with pytest.raises(RuntimeError, match="CUDA"):
            script.main([])


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(no_cuda, tmp_path, alone):
    """Exits non-zero and prints no result: here for want of CUDA, and in a
    directory that holds chip_smoke.py and nothing else of the repo."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_every_kernel_source_has_a_signature():
    sources = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert sources == set(_build.SIGNATURES)
    for name in sources:
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR
        assert path == _build.library_path(name)  # stable across calls
        symbol, _ = _build.SIGNATURES[name]
        assert f'extern "C" int {symbol}(' in (_build.CSRC / f"{name}.cu").read_text()
