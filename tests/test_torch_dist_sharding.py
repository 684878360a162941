"""The port's sharding rules (``repro_torch.distributed.sharding``)
against the reference's: for every arch that
``tests/test_distributed.py::test_param_rules_cover_all_archs`` covers, in
both styles, with FSDP off and on, each port parameter's spec is the
reference leaf's spec without its stacked leading entries, every reference
leaf is covered, and ``legalize`` drops the same (path, dim, axis) entries
on the 16 x 16 mesh (the reference's own mock-mesh trick); and the
placements a spec gives on a (2, 2) mesh of four gloo ranks."""

import unittest.mock as mock

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from _torch_dist import placements_rank, run_ranks
from repro.configs.registry import get_config as jget
from repro.distributed import sharding as jsh
from repro.launch import specs as jspecs
from repro_torch.configs.registry import get_config as tget
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import specs as tspecs

ARCHS = ("smollm-360m", "olmoe-1b-7b", "zamba2-7b", "seamless-m4t-medium",
         "mamba2-130m", "llava-next-34b")


def fake_mesh(shape=(16, 16), names=("data", "model")):
    mesh = mock.Mock()
    mesh.axis_names = names
    mesh.devices = np.empty(shape)
    return mesh


def reference_leaves(params, specs) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    sflat = jax.tree_util.tree_structure(params).flatten_up_to(specs)
    return {jsh._path_str(path): (leaf, spec) for (path, leaf), spec in zip(flat, sflat)}


@pytest.mark.parametrize("style", ["1d", "2d"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_dropped_match_reference(arch, style):
    model = tspecs.param_shape_specs(tget(arch))
    jparams = jspecs.param_shape_specs(jget(arch))
    for fsdp in (None, "data"):
        trules = tsh.ShardingRules(fsdp_axis=fsdp, style=style)
        jrules = jsh.ShardingRules(fsdp_axis=fsdp, style=style)
        tspecs_ = tsh.param_specs(model, trules)
        ref = reference_leaves(jparams, jsh.param_specs(jparams, jrules))
        seen = set()
        for name, spec in tspecs_.items():
            path, lead = tsh.ref_path(name)
            leaf, jspec = ref[path]
            seen.add(path)
            want = (tuple(jspec) + (None,) * leaf.ndim)[:leaf.ndim][lead:]
            ndim = leaf.ndim - lead
            assert (spec + (None,) * ndim)[:ndim] == want, (name, spec, jspec)
        assert seen == set(ref)
        _, jdropped = jsh.legalize(jsh.param_specs(jparams, jrules), jparams, fake_mesh())
        _, tdropped = tsh.legalize(tspecs_, dict(model.named_parameters()), fake_mesh())
        assert tdropped == [tuple(d) for d in jdropped]


def test_legalize_drops_indivisible():
    """The reference's synthetic case: a dim of 15 over 16-way "model"."""
    import torch
    legal, dropped = tsh.legalize({"w": (None, "model")},
                                  {"w": torch.empty(4, 15, device="meta")},
                                  fake_mesh((16,), ("model",)))
    jlegal, jdropped = jsh.legalize(
        {"w": P(None, "model")}, {"w": jax.ShapeDtypeStruct((4, 15), np.float32)},
        fake_mesh((16,), ("model",)))
    assert legal["w"] == tuple(jlegal["w"]) + (None,) * (2 - len(jlegal["w"]))
    assert dropped == [tuple(d) for d in jdropped] == [("w", 1, "model")]


def test_batch_and_cache_specs_match_reference():
    cfg = tget("zamba2-7b").reduced()
    import torch
    from repro.models import api as japi
    from repro_torch.models import api as tapi
    trules, jrules = (tsh.ShardingRules(dp_axes=("pod", "data")),
                      jsh.ShardingRules(dp_axes=("pod", "data")))
    tcache = tapi.init_cache(cfg, 4, 16, device="meta")
    jcache = jax.eval_shape(lambda: japi.init_cache(jget("zamba2-7b").reduced(), 4, 16))
    want = {jsh._path_str(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                jsh.cache_specs(jcache, jrules),
                is_leaf=lambda x: isinstance(x, P))[0]}
    assert tsh.cache_specs(tcache, trules) == want
    batch = {"tokens": torch.empty(4, 16, device="meta"), "step": torch.empty(())}
    jbatch = {"tokens": jax.ShapeDtypeStruct((4, 16), np.int32),
              "step": jax.ShapeDtypeStruct((), np.int32)}
    jspec = jsh.batch_specs(jbatch, jrules)
    assert tsh.batch_specs(batch, trules) == {k: tuple(v) for k, v in jspec.items()}


def test_placements_on_a_gloo_mesh(tmp_path):
    specs = [(), ("data",), (None, "model"), ("model", "data"), (("data", "model"),)]
    want = [
        ("[Replicate(), Replicate()]", (4, 6)),
        ("[Shard(dim=0), Replicate()]", (2, 6)),
        ("[Replicate(), Shard(dim=1)]", (4, 3)),
        ("[Shard(dim=1), Shard(dim=0)]", (2, 3)),
        ("[Shard(dim=0), Shard(dim=0)]", (1, 6)),
    ]
    full = np.arange(24.0).reshape(4, 6)
    for per_rank in run_ranks(placements_rank, 4, tmp_path, specs):
        for (placements, local, whole), (wp, wl) in zip(per_rank, want):
            assert (placements, local) == (wp, wl)
            np.testing.assert_array_equal(whole, full)
