"""The port's train step on a sharded state: reduced smollm-360m,
olmoe-1b-7b, glm4-9b, mamba2-130m (its heads split over "model") and a
dense model of 6 q heads in 2 kv groups on a (1, 4) mesh (4 divides
neither: attention shards its tokens) in f32, the state sharded by the
dry-run's rules over ("data", "model") meshes of four gloo ranks on the
CPU, one step under ``implicit_replication``, against the reference's
single-device step from the same weights and batch (the reference's
multi-device step fails on the installed JAX: ROADMAP Queue 3) and against
the port's unsharded step.  Tolerances as ``test_torch_lm_train_step.py``'s:
loss and grad norm within 1e-5 relative, params within a tenth of the
learning rate.  A sharded forward pass's logits are within 1e-5 of the
unsharded ones, relative to their largest magnitude.  Also: the sharded state really is sharded, and
``flash_remat`` is bit-equal to no remat."""

import jax
import numpy as np
import pytest
import torch

from _torch_dist import prefill_rank, run_ranks, train_rank
from _torch_parity import one_torch_thread  # noqa: F401
from repro_torch.models import api as tapi
from repro_torch.train import train_step as tts
from test_torch_lm_train_step import LR, PARAM_ATOL, RTOL, leaves, run_port, run_ref, setup


@pytest.mark.parametrize("arch,flags", [
    # the port's attention tokens sharded over "model" (seq_shard_attention;
    # the reference's flag needs a mesh, and changes no number off one)
    ("smollm-360m", {"seq_shard_attention": True}),
    ("olmoe-1b-7b", {}),                  # two kv groups: "model" shards them
])
def test_sharded_step_matches_reference_single_device(arch, flags, tmp_path):
    check_sharded_step(arch, {}, flags, tmp_path)


def test_head_sharded_step_matches_reference_single_device(tmp_path):
    """One kv group of four heads: "model" (2) divides no group count, so
    it shards the heads, two per rank, as GSPMD shards the q heads."""
    check_sharded_step("glm4-9b", {"n_kv_heads": 1}, {}, tmp_path)


@pytest.mark.parametrize("arch,shared,mesh", [
    # 4 heads of 32 over "model" (2): two each, B and C projected in halves
    ("mamba2-130m", {}, (2, 2)),
    # 3 heads of 32 over "model" (2): d_inner's 96 channels 48 each, so the
    # norm and the out-projection cut head 1; the heads 2 and 1
    ("mamba2-130m", {"d_model": 48}, (2, 2)),
    # 6 q heads in 2 groups over "model" (4): no group or head split, so
    # the attention tiles "model" as GSPMD does, the groups 2 ways and the
    # 16 tokens 2 ways
    ("glm4-9b", {"n_heads": 6, "n_kv_heads": 2}, (1, 4)),
])
def test_repaired_layouts_match_reference_and_unsharded(arch, shared, mesh, tmp_path):
    check_sharded_step(arch, shared, {}, tmp_path, mesh=mesh, unsharded=True)


@pytest.mark.parametrize("arch,shared,mesh", [
    ("mamba2-130m", {}, (2, 2)),
    ("mamba2-130m", {"d_model": 48}, (2, 2)),
    ("glm4-9b", {"n_heads": 6, "n_kv_heads": 2}, (1, 4)),
])
def test_sharded_prefill_logits_match_unsharded(arch, shared, mesh, tmp_path):
    """The forward pass of the prefill layout (heads, vocabulary and
    tokens split as the dry-run splits them) against the unsharded one."""
    jstate, tstate, (_, tcfg, _, _), b = setup(arch, batch=4, seq=16, **shared)
    params_np = jax.tree_util.tree_map(np.asarray, jstate["params"])
    batch = {k: v for k, v in b.items() if k not in ("labels", "loss_mask")}
    over = {"remat": "none", "dtype": "float32", **shared}
    with torch.no_grad():
        want, _ = tapi.apply(tstate["params"], {k: torch.from_numpy(v)
                                                for k, v in batch.items()}, tcfg)
    want = want.numpy()
    for got in run_ranks(prefill_rank, 4, tmp_path, arch, over, params_np, batch, mesh):
        # f32 sums in other orders (the row-parallel products' partial
        # sums, the norm's sum over d_inner): within 1e-5 of the logits'
        # scale (in f64 the mamba2 case agrees to 3e-14)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def check_sharded_step(arch, shared, flags, tmp_path, mesh=(2, 2), unsharded=False):
    """The sharded step of ``arch`` on four ranks (reduced by ``shared`` in
    both packages, by ``flags`` in the port only) against the reference's
    single-device step and, with ``unsharded``, the port's."""
    jstate, tstate, (jcfg, tcfg, jo, to), b = setup(arch, batch=4, seq=16, **shared)
    params_np = jax.tree_util.tree_map(np.asarray, jstate["params"])
    opt_kw = dict(warmup_steps=1, total_steps=10, learning_rate=LR,
                  moments_dtype=jcfg.moments_dtype, master_weights=jcfg.master_weights)
    over = {"remat": "none", "dtype": "float32", **shared, **flags}
    js, jm = run_ref(jstate, jcfg, jo, b)
    results = run_ranks(train_rank, 4, tmp_path, arch, over, params_np, opt_kw, b, mesh)
    want = leaves(jax.tree_util.tree_map(np.asarray, js))
    plain = None
    if unsharded:
        ps, pm = run_port(tstate, tcfg, to, b)
        plain = leaves(tts.state_tree(ps))
    for metrics, got, sharded in results:
        assert sharded > 0
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(metrics[k], float(jm[k]), rtol=RTOL, err_msg=k)
            if plain is not None:
                np.testing.assert_allclose(metrics[k], float(pm[k]), rtol=RTOL, err_msg=k)
        assert sorted(got) == sorted(want)
        for name in want:
            if name.startswith(("/params", "/opt/master")):
                np.testing.assert_allclose(got[name], want[name], rtol=0,
                                           atol=PARAM_ATOL, err_msg=name)
                if plain is not None:
                    np.testing.assert_allclose(got[name], plain[name], rtol=0,
                                               atol=PARAM_ATOL, err_msg=name)
    # every rank holds the same whole state
    for _, got, _ in results[1:]:
        for name, arr in got.items():
            np.testing.assert_array_equal(arr, results[0][1][name])


@pytest.mark.parametrize("arch", ["smollm-360m", "olmoe-1b-7b"])
def test_flash_remat_is_bit_equal(arch):
    """Recomputing the flash kv loop in the backward pass changes no bit."""
    _, plain, (_, tcfg, _, to), b = setup(arch, seq=16)
    _, remat, (_, rcfg, _, _), _ = setup(arch, seq=16, flash_remat=True)
    assert rcfg.flash_remat and not tcfg.flash_remat
    ps, pm = run_port(plain, tcfg, to, b)
    rs, rm = run_port(remat, rcfg, to, b)
    for k in ("loss", "grad_norm"):
        assert torch.equal(pm[k], rm[k]), k
    for p, r in zip(ps["params"].parameters(), rs["params"].parameters()):
        assert torch.equal(p, r)
