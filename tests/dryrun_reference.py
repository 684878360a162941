"""Writes the JAX reference's per-rank dry-run counts into the table the
port reads (``src/repro_torch/launch/dryrun_reference.json``): for every
(arch x shape x mesh) cell, the reference's ``analysis.dot_flops`` and
``memory.argument_bytes`` (``repro.launch.dryrun.run_cell``), and
``rest_dot_flops``, its dot FLOPs with attention's two products (the
``jnp.einsum`` specs ``bghqd,bgkd->bghqk`` and ``bghqk,bgkd->bghqd`` in
``repro.nn.modules`` and ``repro.models.encdec``) and every einsum of
``repro.nn.ssd`` swapped in memory for dot-free stand-ins of their shapes
(the port's ``dryrun.no_attention`` does the same to its own); for a
training cell under FSDP also ``attention_repeat``, its attention's dot
FLOPs per rank (the count less ``rest_dot_flops``) over those of the same
step without FSDP (the threshold raised past the model): how many times
the reference repeats its attention over the FSDP ranks, where it runs
the whole batch on each (16 where it repeats every product, less where
its HLO splits some of them); or the reason it skipped the cell, or the
error it raised.  The port and ``chip_smoke.py`` only read the table (the
card's machine has no JAX); ``tests/test_torch_dryrun_table.py``
regenerates one cell and holds it equal to its entry.

Each arch runs in a subprocess of its own with 512 host devices
(``XLA_FLAGS``) and ``JAX_PLATFORMS=cpu``, ``--jobs`` at a time:

    PYTHONPATH=src python tests/dryrun_reference.py --jobs 4
    PYTHONPATH=src python tests/dryrun_reference.py --arch mamba2-130m --mesh single
    PYTHONPATH=src python tests/dryrun_reference.py --shape train_4k --jobs 4
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")
TABLE = os.path.join(SRC, "repro_torch", "launch", "dryrun_reference.json")
sys.path.insert(0, SRC)

from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS  # noqa: E402

ARCHS = [a for a in ARCH_IDS if a != "boundswitch-h32"]
MESHES = ("single", "multi")

_SCRIPT = textwrap.dedent("""
    import os, sys, json, traceback
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    sys.path.insert(0, {src!r})
    import jax.numpy as jnp
    from repro.launch import dryrun
    from repro.models import encdec
    from repro.nn import modules, ssd

    def einsum_free(spec, *ops, **kw):
        # the einsum's shape without a product (the port's _einsum_free)
        ins, out = spec.replace(" ", "").split("->")
        total = None
        for labels, t in zip(ins.split(","), ops):
            drop = tuple(i for i, c in enumerate(labels) if c not in out)
            t = t.astype(jnp.float32).sum(axis=drop) if drop else t.astype(jnp.float32)
            kept = [c for c in labels if c in out]
            order = sorted(range(len(kept)), key=lambda i: out.index(kept[i]))
            t = t.transpose(order)
            kept = [kept[i] for i in order]
            t = t.reshape([t.shape[kept.index(c)] if c in kept else 1 for c in out])
            total = t if total is None else total + t
        return total

    class NoSSD:
        def __getattr__(self, name):
            return getattr(jnp, name)

        einsum = staticmethod(einsum_free)

    class NoAttention:
        # jax.numpy with attention's two einsums dot-free, gradients kept
        def __getattr__(self, name):
            return getattr(jnp, name)

        def einsum(self, spec, a, b, **kw):
            if spec == "bghqd,bgkd->bghqk":
                return (a.sum(-1)[..., None] + b.sum(-1)[:, :, None, None, :]).astype(jnp.float32)
            if spec == "bghqk,bgkd->bghqd":
                return (a.sum(-1)[..., None] * b.sum(2)[:, :, None, None, :]).astype(jnp.float32)
            return jnp.einsum(spec, a, b, **kw)

    def counts(shape, mesh):
        # the cell's result, and its dot FLOPs with attention dot-free
        res = dryrun.run_cell({arch!r}, shape, mesh == "multi", overrides={overrides!r})
        if res["status"] != "ok":
            return res, None
        modules.jnp = encdec.jnp = NoAttention()
        ssd.jnp = NoSSD()
        try:
            rest = dryrun.run_cell({arch!r}, shape, mesh == "multi", overrides={overrides!r})
        finally:
            modules.jnp = encdec.jnp = ssd.jnp = jnp
        return res, rest["analysis"]["dot_flops"]

    out = {{}}
    for shape, mesh in {cells!r}:
        key = "|".join(({arch!r}, shape, mesh))
        try:
            res, rest = counts(shape, mesh)
            repeat = None
            if res["status"] == "ok" and res["kind"] == "train" and res["fsdp"]:
                # attention per rank over that of the same step without FSDP
                threshold, dryrun.FSDP_TRAIN_THRESHOLD = dryrun.FSDP_TRAIN_THRESHOLD, float("inf")
                try:
                    whole, whole_rest = counts(shape, mesh)
                finally:
                    dryrun.FSDP_TRAIN_THRESHOLD = threshold
                repeat = ((res["analysis"]["dot_flops"] - rest)
                          / (whole["analysis"]["dot_flops"] - whole_rest))
        except Exception as e:
            out[key] = {{"status": "error", "error": f"{{type(e).__name__}}: {{e}}"}}
            continue
        if res["status"] == "ok":
            out[key] = {{"status": "ok",
                        "dot_flops": res["analysis"]["dot_flops"],
                        "rest_dot_flops": rest,
                        "argument_bytes": res["memory"]["argument_bytes"]}}
            if repeat is not None:
                out[key]["attention_repeat"] = repeat
        else:
            out[key] = {{"status": res["status"], "reason": res.get("reason")}}
    json.dump(out, sys.stdout)
""")


def reference_entries(arch: str, shapes=None, meshes=MESHES, overrides=None,
                      timeout: float = 7200) -> dict:
    """{"arch|shape|mesh": entry} of the reference's cells of ``arch`` (its
    config changed by ``overrides``, as ``run_cell`` takes them), run in
    one subprocess."""
    cells = [(s, m) for s in (shapes or list(SHAPES)) for m in meshes]
    script = _SCRIPT.format(src=SRC, arch=arch, cells=cells, overrides=overrides)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=timeout, env=env)
    if out.returncode != 0:
        raise RuntimeError(f"{arch}: the reference's dry-run exited "
                           f"{out.returncode}\n{out.stderr[-3000:]}")
    return json.loads(out.stdout)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", choices=ARCHS,
                    help="only these archs (repeatable); their entries are "
                         "replaced, the others kept")
    ap.add_argument("--shape", action="append", choices=list(SHAPES),
                    help="only these shapes (repeatable); their entries are replaced")
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="both")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--table", default=TABLE)
    args = ap.parse_args(argv)
    meshes = MESHES if args.mesh == "both" else (args.mesh,)
    table = {}
    if os.path.exists(args.table):
        with open(args.table) as f:
            table = json.load(f)
    with ThreadPoolExecutor(args.jobs) as pool:
        for entries in pool.map(lambda a: reference_entries(a, args.shape, meshes),
                                args.arch or ARCHS):
            table.update(entries)
            print(json.dumps(entries), flush=True)
    with open(args.table, "w") as f:
        json.dump(dict(sorted(table.items())), f, indent=1)
        f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
