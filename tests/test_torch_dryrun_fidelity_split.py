"""Dry-run fidelity (``_torch_fidelity.check_cell``) of the mamba block's
uneven split, at the aim of 0.95-1.05: reduced mamba2-130m cells, whose 24
heads "model" (16) does not divide (the in-projection's 3352 columns 210
per rank, the conv's channels 112, the heads 2, the out-projection's rows
96, as GSPMD pads and splits them): ``train_4k`` and ``long_500k`` here,
``prefill_32k`` in ``test_torch_dryrun_fidelity_ssm.py`` and
``decode_32k`` in ``test_torch_dryrun_fidelity_decode.py``; the FSDP
attention share's two-sided bound on a glm4-9b cell is in
``test_torch_dryrun_fidelity_fsdp.py``.  Also ``dryrun.fidelity`` on
results built by hand: the band, the FSDP exemption's two-sided share, and
equal argument bytes."""

import pytest

from _torch_fidelity import check_cell
from repro_torch.launch import dryrun


@pytest.mark.parametrize("shape", ["train_4k", "long_500k"])
def test_uneven_ssm_split_matches_reference(shape, record_property):
    fid = check_cell("mamba2-130m", shape, dict(n_layers=2), record_property)
    assert dryrun.AIM[0] <= fid["dot_flops_ratio"] <= dryrun.AIM[1]


def _result(kind, fsdp, dot_flops):
    return {"cell": "x|y|single", "kind": kind, "fsdp": fsdp,
            "analysis": {"dot_flops": dot_flops}, "memory": {"argument_bytes": 10}}


# the reference: 100 dot FLOPs per rank, 60 of them other than attention's,
# its attention repeated 16 times over the FSDP ranks
_REF = {"status": "ok", "dot_flops": 100.0, "rest_dot_flops": 60.0, "argument_bytes": 10,
        "attention_repeat": 16.0}


@pytest.mark.parametrize("attention_share,in_aim", [
    (1.0, True),      # its share of the attention: in the aim
    (1.3, False),     # 1.3 times its share: too much work, out of the aim
    (0.5, False),     # half its share: out of the aim too
])
def test_fsdp_attention_share_is_held_from_both_sides(attention_share, in_aim):
    attention = 40.0 / 16 * attention_share
    got = dryrun.fidelity(_result("train", True, 60.0 + attention), 60.0, ref=_REF)
    assert got["dot_flops_ratio"] < dryrun.AIM[0]
    assert got["rest_ratio"] == 1.0
    assert got["attention_share"] == pytest.approx(attention_share)
    assert got["in_aim"] is in_aim


@pytest.mark.parametrize("ratio,in_aim", [(1.0, True), (1.04, True), (1.06, False),
                                          (0.94, False)])
def test_non_fsdp_cell_is_held_to_the_band(ratio, in_aim):
    assert dryrun.AIM == (0.95, 1.05)
    got = dryrun.fidelity(_result("prefill", False, 100.0 * ratio), ref=_REF)
    assert got["in_aim"] is in_aim
    # the exemption is for a training step under FSDP only
    got = dryrun.fidelity(_result("train", False, 100.0 * ratio), 60.0, ref=_REF)
    assert got["in_aim"] is in_aim


def test_argument_bytes_must_be_equal():
    res = _result("prefill", False, 100.0)
    res["memory"]["argument_bytes"] = 11
    got = dryrun.fidelity(res, ref=_REF)
    assert got["argument_bytes_extra"] == 1 and not got["in_aim"]
