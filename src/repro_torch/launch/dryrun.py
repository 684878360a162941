"""Multi-pod dry-run: run every (arch x shape x mesh) cell's step once on
meta DTensors over a 256- or 512-rank ``fake`` process group (torch port
of the reference's ``launch/dryrun.py``).

    single-pod:  (16, 16)    ("data", "model")       = 256 GPUs
    multi-pod:   (2, 16, 16) ("pod", "data", "model") = 512 GPUs

The group lives in this one process: rank 0 plays its part, collectives
move nothing, tensors are on ``meta`` (no byte allocated).  For each cell
the state and inputs come from ``launch.specs``, are sharded by the rules
(``distributed.sharding``) and distributed as DTensors, and the step
(train / prefill / serve, from ``train.train_step``) runs under
``implicit_replication`` (tensors the modules make for themselves —
positions, masks, accumulators — count as replicated) and under
``roofline.count_step``, which counts one rank's matrix FLOPs, bytes and
collective bytes.  Python unrolls the layer loop (the reference compiles
one scan body), so each cell counts the step at a depth of two layers of
each kind and at one more, and scales the difference to the full depth;
``tests/test_torch_roofline.py`` holds that product equal to the whole
count.

Usage:
    python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --out build/dryrun_torch
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.distributed import roofline as rf
from repro_torch.distributed import sharding as sh
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.train import train_step as ts_lib

# FSDP thresholds (param count): above these, weights/opt-state shard over
# the data axis too (ZeRO-3 semantics).
FSDP_TRAIN_THRESHOLD = 2e9
FSDP_SERVE_THRESHOLD = 50e9


def rules_for(cfg, kind: str, mesh, style: str = "1d") -> sh.ShardingRules:
    n = cfg.param_count()
    thresh = FSDP_TRAIN_THRESHOLD if kind == "train" else FSDP_SERVE_THRESHOLD
    dp = tuple(a for a in mesh.mesh_dim_names if a != "model")
    return sh.ShardingRules(
        tp_axis="model",
        fsdp_axis="data" if n > thresh else None,
        dp_axes=dp,
        style=style,
    )


# Perf-iteration variants.  "baseline" is the paper-faithful default;
# everything else is a beyond-paper optimization.
VARIANTS = {
    "baseline": {},
    "flashremat": {"cfg": {"flash_remat": True}},
    "seqshard": {"cfg": {"seq_shard_attention": True}},
    "flashremat+seqshard": {"cfg": {"flash_remat": True,
                                    "seq_shard_attention": True}},
    "serve2d": {"style": "2d"},
    "serve2d+seqshard": {"style": "2d", "cfg": {"seq_shard_attention": True}},
    "int8cache": {"cfg": {"cache_dtype": "int8"}},
    # Megatron-style sequence parallelism: the token stream itself is
    # sharded over the TP axis, so per-layer activation collectives move
    # (B, S/16, d) instead of (B, S, d)
    "seqpar": {"style": "2d", "batch_seq_shard": True,
               "cfg": {"seq_shard_attention": True}},
    # + explicit Megatron-SP constraints on the residual stream
    "seqpar2": {"style": "2d", "batch_seq_shard": True,
                "cfg": {"seq_shard_attention": True,
                        "seq_shard_activations": True}},
}


def _legal_batch_specs(batch, rules, mesh):
    return sh.legalize(sh.batch_specs(batch, rules), sh.tree_paths(batch), mesh)


def _decode_cache_specs(cache, rules, mesh):
    """KV caches: batch over dp, kv-heads over model (seq as fallback)."""
    axis_size = dict(zip(mesh.mesh_dim_names, mesh.shape))
    tp = axis_size.get(rules.tp_axis, 1)
    dp = tuple(a for a in rules.dp_axes if a)
    dp_total = 1
    for a in dp:
        dp_total *= axis_size.get(a, 1)
    dp_entry = dp if len(dp) > 1 else (dp[0] if dp else None)

    out = {}
    for name, leaf in sh.tree_paths(cache).items():
        shape = leaf.shape
        nd = len(shape)
        entries = [None] * nd
        if re.search(r"(^|/)(k|v)(_scale)?$", name):
            # (L, B, G, Lc[, hd]) — scales lack the trailing hd dim
            if dp_entry and shape[1] % dp_total == 0:
                entries[1] = dp_entry
            if shape[2] % tp == 0:
                entries[2] = rules.tp_axis
            elif shape[3] % tp == 0:
                entries[3] = rules.tp_axis  # seq-dim fallback (glm/arctic/llava)
        else:
            bdim = nd - 4 if name.endswith("ssm") else nd - 3
            if dp_entry and shape[bdim] % dp_total == 0:
                entries[bdim] = dp_entry
        out[name] = tuple(entries)
    return out


def _local_bytes(tree) -> int:
    """Bytes one rank holds of every tensor in ``tree`` (dicts, lists,
    tuples, modules' parameters; DTensors by their local shard)."""
    if isinstance(tree, torch.nn.Module):
        return _local_bytes(list(tree.parameters()))
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        local = tree.to_local() if hasattr(tree, "to_local") else tree
        return local.numel() * local.element_size()
    return 0


def _depth_fields(cfg) -> list[tuple[str, int]]:
    """The config's layer counts, one per kind of layer: (name, count)."""
    if cfg.family == "encdec":
        return [("n_enc_layers", cfg.n_enc_layers), ("n_dec_layers", cfg.n_dec_layers)]
    if cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.attn_every
        fields = [("groups", groups)]
        if cfg.n_layers - groups * cfg.attn_every:
            fields.append(("trailing", cfg.n_layers - groups * cfg.attn_every))
        return fields
    return [("n_layers", cfg.n_layers)]


def _at_depth(cfg, depth: dict):
    """``cfg`` cut to the given count of each kind of layer."""
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, **depth)
    if cfg.family == "hybrid":
        n = depth["groups"] * cfg.attn_every + depth.get("trailing", 0)
        return dataclasses.replace(cfg, n_layers=n)
    return dataclasses.replace(cfg, **depth)


def _build_cell(cfg, shape, rules, mesh, batch_seq_shard: bool):
    """(step, args, dropped, stateful args updated in place) for one cell,
    sharded and distributed on ``mesh``."""
    cell = specs_lib.input_specs(cfg, shape)
    kind = shape.kind
    if kind == "train":
        state, batch = cell["state"], cell["batch"]
        model = state["params"]
        pspecs, dropped = sh.legalize(sh.param_specs(model, rules),
                                      dict(model.named_parameters()), mesh)
        bspecs, _ = _legal_batch_specs(batch, rules, mesh)
        specs = {"params": pspecs, "opt": sh.opt_state_specs(pspecs, state["opt"]),
                 "batch": bspecs}
        state, batch = sh.distribute_state(state, mesh, specs, batch)
        step = ts_lib.make_train_step(cfg, cell["opt_cfg"])
        return step, (state, batch), dropped, state
    model = cell["params"]
    pspecs, dropped = sh.legalize(sh.param_specs(model, rules),
                                  dict(model.named_parameters()), mesh)
    sh.distribute_state({"params": model, "opt": {}}, mesh, {"params": pspecs, "opt": {}})
    if kind == "prefill":
        batch = cell["batch"]
        bspecs, _ = _legal_batch_specs(batch, rules, mesh)
        if batch_seq_shard:
            for path, leaf in sh.tree_paths(batch).items():
                spec = bspecs[path]
                if leaf.ndim >= 2 and leaf.shape[1] % 16 == 0:
                    bspecs[path] = (spec[0], rules.tp_axis, *spec[2:leaf.ndim])
        batch = sh.distribute_tree(batch, mesh, bspecs)
        return ts_lib.make_prefill_step(cfg), (model, batch), dropped, None
    cache = cell["cache"]
    cspecs, _ = sh.legalize(_decode_cache_specs(cache, rules, mesh),
                            sh.tree_paths(cache), mesh)
    cache = sh.distribute_tree(cache, mesh, cspecs)
    tspec, _ = _legal_batch_specs({"tokens": cell["tokens"]}, rules, mesh)
    tokens = sh.distribute(cell["tokens"], mesh, tspec["tokens"])
    args = [model, tokens, cache, cell["cache_len"]]
    if cell["slot_ids"] is not None:
        sspec, _ = _legal_batch_specs({"slot_ids": cell["slot_ids"]}, rules, mesh)
        args.append(sh.distribute(cell["slot_ids"], mesh, sspec["slot_ids"]))
    return ts_lib.make_serve_step(cfg), tuple(args), dropped, cache


def _count(cfg, shape, rules, mesh, batch_seq_shard) -> dict:
    step, args, _, _ = _build_cell(cfg, shape, rules, mesh, batch_seq_shard)
    with implicit_replication():
        out, analysis = rf.count_step(step, *args)
    analysis["output_bytes"] = _local_bytes(out)
    return analysis


def _scaled(base: dict, steps: list[tuple[dict, int]]) -> dict:
    """base + sum over kinds of (count with one more layer - base) x the
    layers the base lacks, for every number in the analysis."""
    def combine(get):
        return get(base) + sum((get(a) - get(base)) * n for a, n in steps)

    coll = {k: combine(lambda a, k=k: a["collective_bytes"][k])
            for k in base["collective_bytes"]}
    out = {k: combine(lambda a, k=k: a[k])
           for k in ("dot_flops", "hbm_bytes", "peak_live_bytes", "output_bytes")}
    out["collective_bytes"] = coll
    out["collective_bytes_total"] = sum(coll.values())
    return out


def count_cell(cfg, shape, rules, mesh, batch_seq_shard: bool = False):
    """One rank's counts of the cell's step at full depth, and the local
    bytes of its outputs, from the step at a base depth of (at most) 2
    layers of each kind and at the base plus one layer of each kind.  The
    first layer differs from the rest (it meets the embedding's shardings,
    and stacking its cache with the others' reshards it), so the base
    holds two of each."""
    fields = _depth_fields(cfg)
    base_depth = {name: min(n, 2) for name, n in fields}
    base = _count(_at_depth(cfg, base_depth), shape, rules, mesh, batch_seq_shard)
    steps = [(_count(_at_depth(cfg, dict(base_depth, **{name: base_depth[name] + 1})),
                     shape, rules, mesh, batch_seq_shard), n - base_depth[name])
             for name, n in fields if n > base_depth[name]]
    return _scaled(base, steps)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             overrides: dict | None = None, variant: str = "baseline") -> dict:
    """One dry-run cell in a ``fake`` process group of 256 (512) ranks,
    built and destroyed here."""
    cfg = get_config(arch)
    vspec = VARIANTS[variant]
    v_over = dict(vspec.get("cfg", {}))
    if overrides:
        v_over.update(overrides)
    if v_over:
        cfg = dataclasses.replace(cfg, **v_over)
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    cell_id = f"{arch}|{shape_name}|{mesh_name}"
    if variant != "baseline":
        cell_id += f"|{variant}"
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"cell": cell_id, "status": "skipped", "reason": why}
    if dist.is_initialized():
        raise RuntimeError("run_cell builds its own fake process group: "
                           "destroy the default group first")

    from torch.testing._internal.distributed.fake_pg import FakeStore

    t0 = time.time()
    dist.init_process_group("fake", rank=0, world_size=512 if multi_pod else 256,
                            store=FakeStore())
    try:
        return _run_cell(cfg, shape, multi_pod, vspec, cell_id, t0, arch,
                         shape_name, mesh_name, variant)
    finally:
        dist.destroy_process_group()


def _run_cell(cfg, shape, multi_pod, vspec, cell_id, t0, arch, shape_name,
              mesh_name, variant) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod)
    kind = shape.kind
    rules = rules_for(cfg, kind, mesh, style=vspec.get("style", "1d"))
    seq = bool(vspec.get("batch_seq_shard"))
    result = {"cell": cell_id, "arch": arch, "shape": shape_name,
              "mesh": mesh_name, "kind": kind, "variant": variant,
              "fsdp": rules.fsdp_axis is not None}

    # full depth on meta: the arguments, the dropped shardings, the outputs
    _, args, dropped, aliased = _build_cell(cfg, shape, rules, mesh, seq)
    arg_bytes = _local_bytes(args)
    alias_bytes = _local_bytes(aliased)
    del args, aliased
    analysis = count_cell(cfg, shape, rules, mesh, seq)
    out_bytes = analysis.pop("output_bytes")
    temp = analysis.pop("peak_live_bytes")

    result["dropped_shardings"] = [f"{p}[{d}]@{a}" for (p, d, a) in dropped]
    result["memory"] = {
        "argument_bytes": arg_bytes,
        "output_bytes": out_bytes,
        "temp_bytes": temp,
        "alias_bytes": alias_bytes,
        "per_device_total": arg_bytes + out_bytes + temp - alias_bytes,
    }
    result["xla_cost"] = None
    result["analysis"] = analysis
    result["roofline"] = rf.roofline_terms(analysis)
    n_dev = mesh.size()
    mf = rf.model_flops(cfg, shape, kind)
    result["model_flops_global"] = mf
    global_dot = analysis["dot_flops"] * n_dev
    result["useful_flops_ratio"] = mf / global_dot if global_dot else None
    result["params"] = cfg.param_count()
    result["active_params"] = cfg.active_param_count()
    result["compile_seconds"] = time.time() - t0
    result["status"] = "ok"
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=[a for a in ARCH_IDS if a != "boundswitch-h32"])
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="directory for per-cell JSON")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    args = ap.parse_args(argv)

    cells = []
    archs = [a for a in ARCH_IDS if a != "boundswitch-h32"] if args.all else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for a in archs:
        for s in shapes:
            for m in meshes:
                cells.append((a, s, m))

    failed = 0
    for a, s, m in cells:
        try:
            res = run_cell(a, s, multi_pod=(m == "multi"), variant=args.variant)
        except Exception as e:  # recorded, never skipped: the cell is an error
            res = {"cell": f"{a}|{s}|{m}|{args.variant}", "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
        failed += res.get("status") == "error"
        line = {k: res.get(k) for k in ("cell", "status", "reason", "error")}
        print(json.dumps(line), flush=True)
        if res.get("status") == "ok":
            r = res["roofline"]
            print(f"  compute={r['compute_s']*1e3:.3f}ms memory={r['memory_s']*1e3:.3f}ms "
                  f"collective={r['collective_s']*1e3:.3f}ms dominant={r['dominant']} "
                  f"mem/dev={res['memory']['per_device_total']/2**30:.2f}GiB "
                  f"seconds={res['compile_seconds']:.1f}", flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            fname = res["cell"].replace("|", "_") + ".json"
            with open(os.path.join(args.out, fname), "w") as f:
                json.dump(res, f, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
