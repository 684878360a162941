"""Lists one dry-run cell's matrix products per rank, the reference's and
the port's, to read a layout from:

    PYTHONPATH=src python tests/dryrun_dots.py mamba2-130m prefill_32k single '{"n_layers": 2}'

The reference's: its ``repro.launch.dryrun.run_cell`` in a subprocess with
512 host devices, each ``dot`` of the optimized HLO with its operand and
result shapes, contracting dims and source line, and its FLOPs times the
trip counts of the loops around it (their sum is ``analyze``'s
``dot_flops``).  The port's: ``repro_torch.launch.dryrun.run_cell`` with
every product op that ``roofline.StepCounter`` counts at the base depth
(at most two layers of each kind; the reference compiles the full depth
as one loop), its operand shapes and FLOPs summed over equal ones."""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import textwrap

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
sys.path.insert(0, SRC)

_SCRIPT = textwrap.dedent("""
    import collections, os, re, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    sys.path.insert(0, {src!r})
    from repro.distributed import roofline as rf
    from repro.launch import dryrun

    texts = []
    analyze = rf.analyze
    rf.analyze = lambda text: (texts.append(text), analyze(text))[1]
    dryrun.run_cell({arch!r}, {shape!r}, {multi!r}, overrides={overrides!r})
    text = texts[0]
    comps = {{id(c): c for c in rf.parse_hlo(text).values()}}
    by_name = {{c.name: c for c in comps.values()}}
    for c in comps.values():
        rf._analyze_locals(c, by_name)
    # source lines: StackFrames -> FileLocations -> FileNames
    tables, sec = {{}}, None
    for line in text.splitlines():
        if line in ("FileNames", "FileLocations", "StackFrames"):
            sec, tables[line] = line, {{}}
        elif not line.strip():
            sec = None
        elif sec:
            key, rest = line.split(" ", 1)
            tables[sec][int(key)] = rest
    def where(rhs):
        m = re.search(r"stack_frame_id=(\\d+)", rhs)
        if not m or int(m.group(1)) not in tables.get("StackFrames", {{}}):
            return ""
        loc = int(re.search(r"file_location_id=(\\d+)",
                            tables["StackFrames"][int(m.group(1))]).group(1))
        fields = dict(kv.split("=") for kv in tables["FileLocations"][loc].strip("{{}}").split())
        name = tables["FileNames"][int(fields["file_name_id"])].strip('"')
        return f"{{os.path.basename(name)}}:{{fields['line']}}"
    mult = collections.Counter()
    def walk(name, m, stack=()):
        if name not in by_name or name in stack:
            return
        mult[name] += m
        for callee, k, _ in by_name[name].calls:
            walk(callee, m * k, stack + (name,))
    walk(rf.parse_hlo(text)["__entry__"].name, 1)
    rows = []
    for c in comps.values():
        for op in c.ops:
            if op.opcode != "dot" or not mult[c.name]:
                continue
            names = rf._operand_names(op.rhs, "dot")
            shapes = [c.symbols.get(n, ("?", []))[1] for n in names]
            cm = rf._CONTRACT_RE.search(op.rhs)
            cdims = [int(x) for x in cm.group(1).split(",") if x] if cm else []
            flops = 2.0
            for d in op.result_dims:
                flops *= d
            for d in cdims:
                flops *= shapes[0][d]
            rows.append({{"shapes": shapes, "result": op.result_dims, "contract": cdims,
                         "where": where(op.rhs), "times": mult[c.name],
                         "flops": flops * mult[c.name]}})
    json.dump(rows, sys.stdout)
""")


def reference_dots(arch: str, shape: str, mesh: str, overrides=None) -> list[dict]:
    script = _SCRIPT.format(src=SRC, arch=arch, shape=shape, multi=mesh == "multi",
                            overrides=overrides)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=3600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    if out.returncode != 0:
        raise RuntimeError(f"the reference's dry-run exited {out.returncode}\n"
                           f"{out.stderr[-3000:]}")
    return json.loads(out.stdout)


def port_dots(arch: str, shape: str, mesh: str, overrides=None) -> dict:
    """{(op, operand shapes): FLOPs} of the port's count at the base depth."""
    from repro_torch.distributed import roofline as rf
    from repro_torch.launch import dryrun

    rows, calls = collections.Counter(), []
    dispatch, count = rf.StepCounter.__torch_dispatch__, dryrun._count

    def counted(self, func, types, args=(), kwargs=None):
        before = self.dot_flops
        out = dispatch(self, func, types, args, kwargs)
        if self.dot_flops != before and len(calls) == 1:
            shapes = tuple(tuple(t.shape) for t in rf._tensors((args, kwargs or {})))
            rows[(func.overloadpacket.__name__, shapes)] += self.dot_flops - before
        return out

    def base_first(*args):
        calls.append(None)
        return count(*args)

    rf.StepCounter.__torch_dispatch__, dryrun._count = counted, base_first
    try:
        dryrun.run_cell(arch, shape, mesh == "multi", overrides=overrides)
    finally:
        rf.StepCounter.__torch_dispatch__, dryrun._count = dispatch, count
    return dict(rows)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    arch, shape, mesh = argv[:3]
    overrides = json.loads(argv[3]) if len(argv) > 3 else None
    ref = reference_dots(arch, shape, mesh, overrides)
    print(f"reference: {sum(r['flops'] for r in ref):.6g} dot FLOPs per rank")
    for r in sorted(ref, key=lambda r: -r["flops"]):
        print(f"  {r['flops']:.4g}  x{r['times']}  {r['shapes']} -> {r['result']} "
              f"contract {r['contract']}  {r['where']}")
    port = port_dots(arch, shape, mesh, overrides)
    print(f"port, base depth: {sum(port.values()):.6g} dot FLOPs per rank")
    for (op, shapes), flops in sorted(port.items(), key=lambda kv: -kv[1]):
        print(f"  {flops:.4g}  {op} {list(shapes)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
