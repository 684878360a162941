"""The dry-run fidelity check of ``test_torch_dryrun_fidelity*.py``: a
reduced cell's per-rank dot FLOPs and argument bytes, the port's
(``repro_torch.launch.dryrun.run_cell``) against the reference's (run in a
subprocess by ``dryrun_reference.reference_entries``, as the table is
written), held to the dry-run's own aim (``dryrun.fidelity``: equal
argument bytes; dot FLOPs within 0.95-1.05 of the reference's, or, for a
training cell under FSDP only, the products other than attention's within
0.95-1.05 and attention within 0.95-1.05 of the reference's share per rank:
its attention over ``attention_repeat``, the times the reference repeats it
over the FSDP ranks)."""

from dryrun_reference import reference_entries
from repro_torch.launch import dryrun


def check_cell(arch: str, shape: str, overrides: dict, record_property,
               got: dict | None = None) -> dict:
    """Asserts the aim on one single-mesh cell (``got``: the port's
    ``run_cell`` result, if the caller has it); returns its
    ``dryrun.fidelity``."""
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
    return fid
