"""Dry-run fidelity (``_torch_fidelity.check_cell``) of attention's
layouts: a llava-shaped ``prefill_32k`` cell (56 q heads in 8 kv groups,
narrow heads: 16 ranks split neither, so attention tiles "model" as GSPMD
does, the groups 8 ways and the tokens 2) and
an h2o-shaped ``long_500k`` cell (a decode batch of one leaves "data"
idle: the products split their contraction over it, the q heads split
over it)."""

import pytest

from _torch_fidelity import check_cell


@pytest.mark.parametrize("arch,shape,overrides", [
    ("llava-next-34b", "prefill_32k", dict(n_layers=1, d_model=896, n_heads=56, n_kv_heads=8,
                                           head_dim=16, d_ff=1024, vocab_size=4096)),
    ("h2o-danube-3-4b", "long_500k", dict(n_layers=2, d_model=512, n_heads=32, n_kv_heads=8,
                                          head_dim=16, d_ff=1024, vocab_size=4096)),
])
def test_attention_layouts_match_reference(arch, shape, overrides, record_property):
    check_cell(arch, shape, overrides, record_property)
