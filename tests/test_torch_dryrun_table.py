"""The reference's table (``src/repro_torch/launch/dryrun_reference.json``,
which the port's dry-run and ``chip_smoke.py`` read) is current: one cheap
cell regenerated from the JAX package (``dryrun_reference``) equals its
entry, and the table holds every (arch x shape x mesh) cell."""

import json

from dryrun_reference import ARCHS, MESHES, TABLE, reference_entries
from repro_torch.configs.base import SHAPES


def test_table_entry_is_current():
    with open(TABLE) as f:
        table = json.load(f)
    assert sorted(table) == sorted(f"{a}|{s}|{m}" for a in ARCHS for s in SHAPES
                                   for m in MESHES)
    got = reference_entries("mamba2-130m", ["decode_32k"], ("single",), timeout=600)
    assert got == {k: table[k] for k in got}
