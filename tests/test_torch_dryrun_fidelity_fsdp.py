"""Dry-run fidelity (``_torch_fidelity.check_cell``) of an FSDP training
cell: glm4-9b ``train_4k`` at four layers, past the 2e9 parameters that
turn FSDP on (its weights gathered over "data", the adapters' bf16 copies
unread with master weights; the reference runs attention on the global
batch on every "data" rank, so the products other than attention's are
held to the band, and attention from both sides to its share of what the
reference repeats: ``attention_repeat`` 12.5, where the reference's HLO
computes two of the backward's eight products with ``head_dim`` split 8
ways over "data")."""

from _torch_fidelity import check_cell
from repro_torch.launch import dryrun


def test_fsdp_train_cell_matches_reference(record_property):
    fid = check_cell("glm4-9b", "train_4k", dict(n_layers=4), record_property)
    assert fid["dot_flops_ratio"] < dryrun.AIM[0]       # the exemption's path
    assert dryrun.AIM[0] <= fid["rest_ratio"] <= dryrun.AIM[1]
    assert dryrun.AIM[0] <= fid["attention_share"] <= dryrun.AIM[1]
