"""Dry-run fidelity (``_torch_fidelity.check_cell``) of an FSDP training
cell: glm4-9b ``train_4k`` at four layers, past the 2e9 parameters that
turn FSDP on (its weights gathered over "data", the adapters' bf16 copies
unread with master weights; the reference runs attention on the global
batch on every "data" rank, so the products other than attention's are
held to the band)."""

from _torch_fidelity import check_cell


def test_fsdp_train_cell_matches_reference(record_property):
    check_cell("glm4-9b", "train_4k", dict(n_layers=4), record_property)
