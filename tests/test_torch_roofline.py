"""The port's roofline counter (``repro_torch.distributed.roofline``): a
Python loop of products counted exactly (the counterpart of
``test_distributed.py::test_roofline_analyzer_counts_loops``), per-rank
FLOPs of a sharded weight, the H100 terms and their dominance, and the
dry-run's per-layer scaling equal to the whole count on reduced configs of
the dense, MoE and SSM families (the hybrid and the encoder-decoder:
``test_torch_dryrun_depth.py``)."""

import dataclasses

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.distributed import roofline as rf
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import _build


@pytest.fixture
def fake_group():
    """A fake process group of 16 ranks in this process, destroyed after."""
    def make(world):
        dist.init_process_group("fake", rank=0, world_size=world, store=FakeStore())
    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def test_counts_a_python_loop_of_products_exactly():
    x = torch.randn(64, 64)
    ws = torch.randn(12, 64, 64)

    def looped(x, ws):
        for w in ws:
            x = x @ w
        return x

    out, res = rf.count_step(looped, x, ws)
    assert res["dot_flops"] == 2 * 64 * 64 * 64 * 12
    assert torch.equal(out, looped(x, ws))
    assert res["collective_bytes_total"] == 0
    # 12 products, each reading two (64, 64) f32 operands and writing one;
    # unbind's views move nothing
    assert res["hbm_bytes"] == 12 * 3 * 64 * 64 * 4


def test_per_rank_flops_of_a_sharded_weight(fake_group):
    fake_group(16)
    mesh = _build((16,), ("model",), "cpu")
    x = torch.empty(128, 960, device="meta")
    w = torch.empty(960, 2560, device="meta")
    _, whole = rf.count_step(torch.matmul, x, w)
    xd = distribute_tensor(x, mesh, [Replicate()], src_data_rank=None)
    wd = distribute_tensor(w, mesh, [Shard(1)], src_data_rank=None)
    _, local = rf.count_step(torch.matmul, xd, wd)
    assert whole["dot_flops"] == 2 * 128 * 960 * 2560
    assert local["dot_flops"] == whole["dot_flops"] / 16


def test_roofline_terms_and_dominance():
    a = {"dot_flops": 989e12, "hbm_bytes": 3.35e12 / 2,
         "collective_bytes": {}, "collective_bytes_total": 50e9 * 2}
    t = rf.roofline_terms(a)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(0.5)
    assert t["collective_s"] == pytest.approx(2.0)
    assert t["dominant"] == "collective"
    assert t["step_s_lower_bound"] == pytest.approx(2.0)
    t = rf.roofline_terms(dict(a, hbm_bytes=3.35e12 * 3))
    assert t["dominant"] == "memory" and t["step_s_lower_bound"] == pytest.approx(3.0)


@pytest.mark.parametrize("arch,depth,kind", [
    ("smollm-360m", {"n_layers": 4}, "train"),
    ("olmoe-1b-7b", {"n_layers": 4}, "train"),
    ("mamba2-130m", {"n_layers": 4}, "prefill"),
    ("glm4-9b", {"n_layers": 4}, "decode"),
])
def test_per_layer_scaling_equals_the_whole_count(fake_group, arch, depth, kind):
    """The dry-run counts a cell at two layers of each kind and at one more
    and scales the difference; on a reduced config that equals counting
    the step at its whole depth."""
    fake_group(16)
    mesh = _build((4, 4), ("data", "model"), "cuda")
    cfg = dataclasses.replace(get_config(arch).reduced(remat="full"), **depth)
    shape = ShapeConfig("t", 32, 4, kind)
    rules = dryrun.rules_for(cfg, kind, mesh)
    scaled = dryrun.count_cell(cfg, shape, rules, mesh)
    whole = dryrun._count(cfg, shape, rules, mesh, False)
    for key in ("dot_flops", "hbm_bytes", "collective_bytes", "output_bytes"):
        assert scaled[key] == whole[key], key
    assert scaled["dot_flops"] > 0
