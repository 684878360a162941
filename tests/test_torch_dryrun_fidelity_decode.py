"""Dry-run fidelity (``_torch_fidelity.check_cell``) of the banked head and
the reads: a reduced seamless-m4t-medium ``decode_32k`` cell (the banked
head keeps the bank's vocabulary shards; the unread encoder, cross
projections and ``head`` count no argument bytes) and a reduced
mamba2-130m ``decode_32k`` cell (its unread ``cache_len``)."""

import pytest

from _torch_fidelity import check_cell


@pytest.mark.parametrize("arch,shape,overrides", [
    ("seamless-m4t-medium", "decode_32k", dict(n_enc_layers=1, n_dec_layers=2, d_model=256,
                                               n_heads=16, n_kv_heads=16, head_dim=16,
                                               d_ff=512, vocab_size=8192)),
    ("mamba2-130m", "decode_32k", dict(n_layers=2)),
])
def test_decode_cells_match_reference(arch, shape, overrides, record_property):
    check_cell(arch, shape, overrides, record_property)
