"""The port's docs lint (``repro_torch.launch.doclint``) is clean on the
committed tree, and catches what it is for: a dead port path, a dead
``repro_torch`` module name, a missing DESIGN.md section, CLI drift."""

import pathlib
import shutil

from repro_torch.launch import doclint

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_doclint_clean():
    problems = doclint.run()
    assert problems == [], "\n".join(problems)


def test_doclint_catches_rot(tmp_path):
    for name in ("DESIGN.md", "docs"):
        src = ROOT / name
        (shutil.copytree if src.is_dir() else shutil.copy)(src, tmp_path / name)
    (tmp_path / "README.md").write_text(
        "see src/repro_torch/nope.py, benchmarks_torch/gone.py,\n"
        "examples/missing_torch.py, repro_torch.launch.nope and §99\n")
    with open(tmp_path / "docs" / "cli.md", "a") as f:
        f.write("\n`--no-such-flag`\n")
    problems = "\n".join(doclint.run(str(tmp_path)))
    for needle in ("src/repro_torch/nope.py", "benchmarks_torch/gone.py",
                   "examples/missing_torch.py", "repro_torch.launch.nope",
                   "§99", "--no-such-flag"):
        assert needle in problems, needle
