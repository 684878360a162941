"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
the harness finds

* the configuration in the file its ``configs`` entry names, and the plain
  reference that file names under ``reference`` beside it
  (``configs/<reference>.py``);
* the configuration's hooks, the modules it names under ``attach`` beside
  it (``configs/<hook>.py``, each with ``attach(runtime)``): an observer or
  a cache put onto the data plane once it is built, before the warm-up;
* the configuration's runner, the module it names under ``runner``
  (``runners/<runner>.py``, with a ``run_cell`` of ``benchkit.runner``'s
  signature and result): a configuration without the key runs the data
  plane's ``benchkit.runner.run_cell``;
* the mix in ``traffic/<traffic>.json``, and its generator: the general one
  (``benchkit.traffic.build``), or the module the mix names under
  ``generator`` (``traffic/<generator>.py``, with a ``build`` of the same
  signature) where a mix needs new code;
* each metric's reader in ``metrics/<metric name>.py``, a module with a
  function ``read(ctx)`` that returns a number, or None where it finds
  nothing to read.  Where that file is missing, the reader of the name's
  base (the name without its last ``.`` part) serves: one quantity split by
  the end-to-end metric it moves (``tick_us_per_kpkt.sat``, ``.lat``) has
  one reader.

So a later cell, configuration, mix, metric or runner is added by adding
files and entries; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

from benchkit import traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


class SpecError(ValueError):
    """``BENCHMARK.json`` or a file it names breaks the contract."""


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    workloads: tuple | None
    moves: str | None = None      # None for an end-to-end metric
    reader: object = None

    def applies(self, cell: str, e2e_of_cell=None) -> bool:
        if self.workloads is not None:
            return cell in self.workloads
        if self.moves is None:          # an end-to-end metric of every cell
            return True
        return e2e_of_cell is not None and self.moves in e2e_of_cell


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    reference: object
    runner: object            # the runner's module, None for the data plane
    generator: object
    hooks: list
    end_to_end: list
    per_layer: list


def _module(path: Path, name: str):
    if not path.is_file():
        raise SpecError(f"missing {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod       # a dataclass in the module looks itself up
    spec.loader.exec_module(mod)
    return mod


def _ident(name: str) -> str:
    return re.sub(r"\W", "_", name)


def _json(path: Path) -> dict:
    if not path.is_file():
        raise SpecError(f"missing {path}")
    return json.loads(path.read_text())


class Spec:
    """The parsed ``BENCHMARK.json`` of a checkout rooted at ``root``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        doc = _json(self.root / "BENCHMARK.json")
        for key in ("command", "paths", "run_seconds", "configs", "workloads",
                    "end_to_end", "per_layer"):
            if key not in doc:
                raise SpecError(f"BENCHMARK.json lacks {key!r}")
        self.home = self.root / doc["paths"][0]
        names = set()
        for group in ("configs", "workloads", "end_to_end", "per_layer"):
            for entry in doc[group]:
                n = entry["name"]
                if not NAME.match(n):
                    raise SpecError(f"bad name {n!r}")
                if group in ("end_to_end", "per_layer"):
                    if n in names:
                        raise SpecError(f"metric {n!r} twice")
                    names.add(n)
        self.configs = {c["name"]: c for c in doc["configs"]}
        self.cells = {w["name"]: w for w in doc["workloads"]}
        if len(self.configs) != len(doc["configs"]) or \
                len(self.cells) != len(doc["workloads"]):
            raise SpecError("two configurations or two cells share a name")
        self.e2e = [self._metric(m, e2e=True) for m in doc["end_to_end"]]
        self.layer = [self._metric(m, e2e=False) for m in doc["per_layer"]]
        e2e_names = {m.name for m in self.e2e}
        if "setup_s" not in e2e_names:
            raise SpecError("no setup_s")
        for m in self.layer:
            if m.moves not in e2e_names:
                raise SpecError(f"{m.name} moves unknown {m.moves!r}")

    def _metric(self, m: dict, *, e2e: bool) -> Metric:
        if not UNIT.match(m["unit"]) or m["better"] not in ("lower", "higher"):
            raise SpecError(f"metric {m['name']}: bad unit or better")
        if m["source"] not in (SOURCES_E2E if e2e else SOURCES):
            raise SpecError(f"metric {m['name']}: bad source {m['source']!r}")
        wl = m.get("workloads")
        for w in wl or ():
            if w not in self.cells:
                raise SpecError(f"metric {m['name']} names unknown cell {w!r}")
        return Metric(name=m["name"], unit=m["unit"],
                      workloads=tuple(wl) if wl is not None else None,
                      moves=m.get("moves"))

    def cell(self, name: str) -> Cell:
        """Resolve a cell to its configuration, mix, reference and readers."""
        if name not in self.cells:
            raise SpecError(f"no workload {name!r} in BENCHMARK.json")
        w = self.cells[name]
        if w["config"] not in self.configs:
            raise SpecError(f"cell {name}: unknown config {w['config']!r}")
        centry = self.configs[w["config"]]
        cfile = self.root / centry["file"]
        config = _json(cfile)
        ref = _module(cfile.parent / f"{config['reference']}.py",
                      f"bench_reference_{config['reference']}")
        hooks = [_module(cfile.parent / f"{h}.py", f"bench_hook_{_ident(h)}")
                 for h in config.get("attach", ())]
        for h, mod in zip(config.get("attach", ()), hooks):
            if not callable(getattr(mod, "attach", None)):
                raise SpecError(f"hook {h}.py has no attach(runtime)")
        runner = None
        if "runner" in config:
            runner = _module(self.home / "runners" / f"{config['runner']}.py",
                             f"bench_runner_{_ident(config['runner'])}")
            if not callable(getattr(runner, "run_cell", None)):
                raise SpecError(f"runners/{config['runner']}.py has no run_cell()")
        mix = _json(self.home / "traffic" / f"{w['traffic']}.json")
        generator = traffic.build
        if "generator" in mix:
            gen = _module(self.home / "traffic" / f"{mix['generator']}.py",
                          f"bench_traffic_{_ident(mix['generator'])}")
            if not callable(getattr(gen, "build", None)):
                raise SpecError(f"traffic/{mix['generator']}.py has no build()")
            generator = gen.build
        e2e = [m for m in self.e2e if m.applies(name)]
        e2e_names = {m.name for m in e2e}
        layer = [m for m in self.layer if m.applies(name, e2e_names)]
        if len(e2e) < 2 or not layer:
            raise SpecError(f"cell {name} reports setup_s, another end-to-end "
                            "metric and a per-layer metric")
        for m in e2e + layer:
            m.reader = self._reader(m.name)
        return Cell(name=name, chips=int(w["chips"]), config=config, mix=mix,
                    reference=ref, runner=runner, generator=generator, hooks=hooks,
                    end_to_end=e2e, per_layer=layer)

    def _reader(self, name: str):
        """``metrics/<name>.py``, else the reader of the name's base."""
        path = self.home / "metrics" / f"{name}.py"
        if not path.is_file() and "." in name:
            path = self.home / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
        if not path.is_file():
            raise SpecError(f"no reader metrics/{name}.py for {name}")
        mod = _module(path, "bench_metric_" + _ident(path.stem))
        if not callable(getattr(mod, "read", None)):
            raise SpecError(f"{path.name} has no read(ctx)")
        return mod
