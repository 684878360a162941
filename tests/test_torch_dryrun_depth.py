"""The dry-run's per-layer scaling (``dryrun.count_cell``) equal to the
whole count for the families with two kinds of layer: the hybrid (groups
of mamba layers with the shared attention block, and trailing mamba
layers) and the encoder-decoder (encoder and decoder layers), on reduced
configs over a 16-rank fake process group."""

import dataclasses

import pytest
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import _build


@pytest.fixture
def mesh():
    dist.init_process_group("fake", rank=0, world_size=16, store=FakeStore())
    yield _build((4, 4), ("data", "model"), "cuda")
    dist.destroy_process_group()


@pytest.mark.parametrize("arch,depth", [
    ("zamba2-7b", {"n_layers": 9}),       # 4 groups of 2 mamba layers, 1 trailing
    ("seamless-m4t-medium", {"n_enc_layers": 3, "n_dec_layers": 3}),
])
def test_per_layer_scaling_of_two_kinds(mesh, arch, depth):
    cfg = dataclasses.replace(get_config(arch).reduced(remat="full"), **depth)
    shape = ShapeConfig("t", 32, 4, "train")
    rules = dryrun.rules_for(cfg, "train", mesh)
    assert len(dryrun._depth_fields(cfg)) == 2
    scaled = dryrun.count_cell(cfg, shape, rules, mesh)
    whole = dryrun._count(cfg, shape, rules, mesh, False)
    for key in ("dot_flops", "hbm_bytes", "collective_bytes", "output_bytes"):
        assert scaled[key] == whole[key], key
