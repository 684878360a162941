"""Docs lint for the port: keep the prose wired to the port's code (torch
port of the reference's ``launch/doclint.py``, for the port's names).

Checks, over README.md / DESIGN.md / ROADMAP.md / PERF.md / docs/*.md
and the ``repro_torch`` source tree:

  * **dead file paths** — every ``src/repro_torch/...``,
    ``benchmarks_torch/...`` or ``examples/*_torch.py`` path mentioned in
    the docs must exist in the repo;
  * **dead module refs** — every dotted ``repro_torch.x.y`` reference must
    resolve to a real module or package under ``src/``;
  * **broken intra-repo links** — relative markdown link targets must
    exist, and ``#anchor`` fragments must match a heading slug in the
    target file;
  * **DESIGN section anchors** — every ``§N`` referenced from markdown
    *or from a port source docstring/comment* must be a real DESIGN.md
    section;
  * **CLI reference parity** — the flags of the port's
    ``repro_torch.launch.dataplane.build_parser()`` must be exactly those
    documented in docs/cli.md plus ``--device`` (the one flag the port
    adds, documented in the README's port section);
  * **public API docstrings** — every public method of the port's
    ``DataplaneRuntime`` / ``ControlPlane`` / ``MeshDataplane`` must carry
    a docstring.

Run as ``PYTHONPATH=src python -m repro_torch.launch.doclint``; exits
nonzero listing every violation.
"""

from __future__ import annotations

import importlib
import os
import re
import sys

#: Markdown files linted (relative to the repo root); docs/*.md join in.
DOC_FILES = ("README.md", "DESIGN.md", "ROADMAP.md", "PERF.md")

#: Classes whose public surface must be documented.
API_SURFACE = (
    ("repro_torch.dataplane.runtime", "DataplaneRuntime"),
    ("repro_torch.control.plane", "ControlPlane"),
    ("repro_torch.dataplane.mesh", "MeshDataplane"),
)

#: Flags the port's CLI has beyond docs/cli.md.
PORT_FLAGS = {"--device"}

_PATH_RE = re.compile(
    r"\b((?:src/repro_torch|benchmarks_torch)/[\w./-]*\w|examples/[\w-]*_torch\.py)")
_MODULE_RE = re.compile(r"\brepro_torch(?:\.[a-z_][a-z_0-9]*)+\b")
_LINK_RE = re.compile(r"\[[^\]]+\]\(([^)\s]+)\)")
_SECTION_RE = re.compile(r"§(\d+)")
_HEADING_RE = re.compile(r"^(#{1,6})\s+(.*)$", re.M)


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def _doc_paths(root: str) -> list[str]:
    out = [p for p in DOC_FILES if os.path.exists(os.path.join(root, p))]
    docs_dir = os.path.join(root, "docs")
    if os.path.isdir(docs_dir):
        out += sorted("docs/" + f for f in os.listdir(docs_dir)
                      if f.endswith(".md"))
    return out


def _slugify(heading: str) -> str:
    """GitHub-style heading anchor: lower, spaces to dashes, drop
    everything but word chars and dashes."""
    s = heading.strip().lower().replace(" ", "-")
    return re.sub(r"[^\w\-]", "", s)


def _design_sections(root: str) -> set[int]:
    try:
        text = _read(os.path.join(root, "DESIGN.md"))
    except OSError:
        return set()
    return {int(m.group(1)) for m in re.finditer(r"^## §(\d+)\b", text, re.M)}


def check_paths(root: str, doc: str, text: str, problems: list[str]) -> None:
    for m in _PATH_RE.finditer(text):
        path = m.group(1).rstrip(".")
        if not os.path.exists(os.path.join(root, path)):
            problems.append(f"{doc}: dead path {path!r}")


def check_modules(root: str, doc: str, text: str, problems: list[str]) -> None:
    for m in _MODULE_RE.finditer(text):
        parts = m.group(0).split(".")
        # accept the longest prefix that is a package or module — the
        # tail may name a function/class attribute (pipeline.packet_step)
        ok = False
        for i in range(len(parts), 0, -1):
            base = os.path.join(root, "src", *parts[:i])
            if os.path.exists(base + ".py"):
                ok = True
                break
            if os.path.isdir(base):
                ok = i == len(parts)  # bare package ref is fine; a
                break                 # missing submodule below it is not
        if not ok:
            problems.append(f"{doc}: dead module ref {m.group(0)!r}")


def check_links(root: str, doc: str, text: str, problems: list[str]) -> None:
    base = os.path.dirname(os.path.join(root, doc))
    for m in _LINK_RE.finditer(text):
        target = m.group(1)
        if target.startswith(("http://", "https://", "mailto:")):
            continue
        path, _, frag = target.partition("#")
        full = (os.path.normpath(os.path.join(base, path)) if path
                else os.path.join(root, doc))
        if path and not os.path.exists(full):
            problems.append(f"{doc}: broken link target {target!r}")
            continue
        if frag and full.endswith(".md"):
            try:
                slugs = {_slugify(h) for _, h in _HEADING_RE.findall(_read(full))}
            except OSError:
                slugs = set()
            if frag not in slugs:
                problems.append(f"{doc}: broken anchor {target!r}")


def check_sections(sections: set[int], doc: str, text: str,
                   problems: list[str]) -> None:
    for m in _SECTION_RE.finditer(text):
        if int(m.group(1)) not in sections:
            problems.append(f"{doc}: reference to missing DESIGN.md §{m.group(1)}")


def check_source_sections(root: str, sections: set[int],
                          problems: list[str]) -> None:
    src = os.path.join(root, "src", "repro_torch")
    for dirpath, _, files in os.walk(src):
        for f in files:
            if not f.endswith(".py"):
                continue
            full = os.path.join(dirpath, f)
            rel = os.path.relpath(full, root)
            for m in re.finditer(r"DESIGN\.md\s+§(\d+)", _read(full)):
                if int(m.group(1)) not in sections:
                    problems.append(f"{rel}: docstring references missing "
                                    f"DESIGN.md §{m.group(1)}")


def check_cli_parity(root: str, problems: list[str]) -> None:
    cli_md = os.path.join(root, "docs", "cli.md")
    if not os.path.exists(cli_md):
        problems.append("docs/cli.md: missing (CLI reference required)")
        return
    from repro_torch.launch.dataplane import build_parser
    live = {opt for a in build_parser()._actions
            for opt in a.option_strings if opt.startswith("--")}
    live.discard("--help")
    documented = set(re.findall(r"`(--[\w-]+)[^`]*`", _read(cli_md))) | PORT_FLAGS
    for flag in sorted(live - documented):
        problems.append(f"docs/cli.md: flag {flag} of the port's CLI undocumented")
    for flag in sorted(documented - live):
        problems.append(f"docs/cli.md: documents a flag the port's CLI lacks: {flag}")


def check_api_docstrings(problems: list[str]) -> None:
    for mod_name, cls_name in API_SURFACE:
        cls = getattr(importlib.import_module(mod_name), cls_name)
        if not (cls.__doc__ or "").strip():
            problems.append(f"{mod_name}.{cls_name}: missing class docstring")
        for name, attr in vars(cls).items():
            if name.startswith("_"):
                continue
            fn = getattr(attr, "fget", attr)  # unwrap properties
            if not callable(fn):
                continue
            if not (getattr(fn, "__doc__", None) or "").strip():
                problems.append(f"{mod_name}.{cls_name}.{name}: public API "
                                "method missing docstring")


def run(root: str | None = None) -> list[str]:
    """All doc-lint checks; returns the list of problems (empty = clean)."""
    root = root or _repo_root()
    problems: list[str] = []
    sections = _design_sections(root)
    if not sections:
        problems.append("DESIGN.md: no '## §N' sections found")
    for doc in _doc_paths(root):
        text = _read(os.path.join(root, doc))
        check_paths(root, doc, text, problems)
        check_modules(root, doc, text, problems)
        check_links(root, doc, text, problems)
        check_sections(sections, doc, text, problems)
    check_source_sections(root, sections, problems)
    check_cli_parity(root, problems)
    check_api_docstrings(problems)
    return problems


def main(argv=None) -> int:
    problems = run()
    for p in problems:
        print(f"doclint: {p}")
    if problems:
        print(f"doclint: {len(problems)} problem(s)")
        return 1
    print("doclint: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
