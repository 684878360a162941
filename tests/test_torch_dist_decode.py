"""The port's decode step on a sharded model and cache: a batch of one
(the ``long_500k`` layout, "data" idle) on a (2, 2) mesh of four gloo
ranks on the CPU, one step from a random cache against the unsharded step
from the same weights (the reference's, reduced): the logits within 1e-5 of
their largest magnitude, as the prefill logits of
``test_torch_dist_train_step.py``, and the written cache likewise.  In
zamba2-7b the adapters' outputs scatter the residual's features over the
idle "data" dim, so the mamba block splits its in-projection's
contraction and its out-projection's columns there; mamba2-130m with 3
heads cuts a head between the ranks."""

import jax
import numpy as np
import pytest
import torch

from _torch_dist import decode_rank, run_ranks
from _torch_parity import one_torch_thread  # noqa: F401
from repro_torch.distributed import sharding
from repro_torch.models import api as tapi
from test_torch_lm_train_step import setup


@pytest.mark.parametrize("arch,shared", [
    # the adapters' outputs scatter the residual's features over the idle
    # "data" dim: the mamba block splits its in-projection's contraction
    # and its out-projection's columns there
    ("zamba2-7b", {}),
    ("mamba2-130m", {"d_model": 48}),
])
def test_sharded_decode_matches_unsharded(arch, shared, tmp_path):
    """One decode step of a batch of one (the ``long_500k`` layout: "data"
    idle) from a random cache on a (2, 2) mesh against the unsharded step:
    the logits and the written cache."""
    jstate, tstate, (_, tcfg, _, _), _ = setup(arch, **shared)
    params_np = jax.tree_util.tree_map(np.asarray, jstate["params"])
    rng = np.random.default_rng(1)
    cache = tapi.init_cache(tcfg, 1, 16, device="cpu")
    cache_np = sharding.tree_unflatten(
        {k: (rng.standard_normal(v.shape) * 0.5).astype(np.float32)
         for k, v in sharding.tree_paths(cache).items()})
    tokens, slots, cache_len = np.array([[7]], np.int32), np.array([1], np.int32), 5
    plain = sharding.tree_unflatten({k: torch.from_numpy(v.copy()) for k, v in
                                     sharding.tree_paths(cache_np).items()})
    with torch.no_grad():
        want, plain = tapi.decode_step(tstate["params"], torch.from_numpy(tokens), plain,
                                       cache_len, tcfg, torch.from_numpy(slots))
    want = want.numpy()
    over = {"remat": "none", "dtype": "float32", **shared}
    for got, written in run_ranks(decode_rank, 4, tmp_path, arch, over, params_np, tokens,
                                  cache_np, cache_len, slots, (2, 2)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
        for k, v in sharding.tree_paths(plain).items():
            np.testing.assert_allclose(written[k], v.numpy(), rtol=0,
                                       atol=1e-5 * max(1.0, np.abs(v.numpy()).max()),
                                       err_msg=k)
