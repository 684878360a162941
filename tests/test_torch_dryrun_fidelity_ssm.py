"""Dry-run fidelity (``_torch_fidelity.check_cell``) of the head-sharded
mamba layout: reduced mamba2-130m and zamba2-7b ``prefill_32k`` cells on
the 16 x 16 mesh (the tied head over the vocabulary's shards, the SSD on
each rank's heads, 24 heads over 16 ranks in ``torch.chunk``'s split)."""

import pytest

from _torch_fidelity import check_cell


@pytest.mark.parametrize("arch,shape,overrides", [
    ("mamba2-130m", "prefill_32k", dict(n_layers=2)),
    ("zamba2-7b", "prefill_32k", dict(n_layers=2, attn_every=2, d_model=1024, n_heads=16,
                                      n_kv_heads=16, head_dim=64, d_ff=2048,
                                      vocab_size=4096)),
])
def test_ssm_prefill_matches_reference(arch, shape, overrides, record_property):
    check_cell(arch, shape, overrides, record_property)
