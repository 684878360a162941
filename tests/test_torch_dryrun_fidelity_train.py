"""Dry-run fidelity (``_torch_fidelity.check_cell``) of training cells:
reduced olmoe-1b-7b and arctic-480b ``train_4k`` cells (the experts'
products and their backward on local shards; arctic's 56 heads in 8
groups)."""

import pytest

from _torch_fidelity import check_cell


@pytest.mark.parametrize("arch,shape,overrides", [
    ("olmoe-1b-7b", "train_4k", dict(n_layers=2, d_model=512, n_heads=16, n_kv_heads=16,
                                     head_dim=32, d_ff=256, n_experts=64, vocab_size=4096)),
    ("arctic-480b", "train_4k", dict(n_layers=2, d_model=896, n_heads=56, n_kv_heads=8,
                                     head_dim=16, d_ff=512, n_experts=16, vocab_size=4096)),
])
def test_train_cells_match_reference(arch, shape, overrides, record_property):
    check_cell(arch, shape, overrides, record_property)
