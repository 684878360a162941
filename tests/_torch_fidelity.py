"""The dry-run fidelity check of ``test_torch_dryrun_fidelity*.py``: a
reduced cell's per-rank dot FLOPs and argument bytes, the port's
(``repro_torch.launch.dryrun.run_cell``) against the reference's (run in a
subprocess by ``dryrun_reference.reference_entries``, as the table is
written), held to the dry-run's own aim (``dryrun.fidelity``: equal
argument bytes; dot FLOPs at most 1.25 times the reference's and at least
0.8 times, or, for a training cell under FSDP only, the products other
than attention's within 0.8-1.25 and attention at least 0.8 of the
reference's share per FSDP rank)."""

from dryrun_reference import reference_entries
from repro_torch.launch import dryrun


def check_cell(arch: str, shape: str, overrides: dict, record_property,
               got: dict | None = None) -> float:
    """Asserts the aim on one single-mesh cell (``got``: the port's
    ``run_cell`` result, if the caller has it); returns the dot-FLOP
    ratio."""
    ref = reference_entries(arch, [shape], ("single",), overrides=overrides,
                            timeout=600)[f"{arch}|{shape}|single"]
    got = got or dryrun.run_cell(arch, shape, False, overrides=overrides)
    assert got["status"] == ref["status"] == "ok"
    fid = dryrun.fidelity(got, ref=ref)
    if fid["dot_flops_ratio"] < dryrun.AIM[0]:
        with dryrun.no_attention():
            rest = dryrun.run_cell(arch, shape, False, overrides=overrides)
        fid = dryrun.fidelity(got, rest["analysis"]["dot_flops"], ref=ref)
    for key, value in fid.items():
        record_property(key, value)
    print(f"{arch} {shape}: {fid}")
    assert fid["argument_bytes_extra"] == 0, fid
    assert fid["in_aim"], fid
    return fid["dot_flops_ratio"]
