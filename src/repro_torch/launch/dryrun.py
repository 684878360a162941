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
count.  ``memory.argument_bytes`` counts only the arguments the step reads
(``_ReadTracker``: a parameter the step never reads, as the banked head's
unused ``head`` or, with master weights, an adapter's bf16 copy that no
batch routes through, is no argument), as the reference's ``jit`` drops
unread arguments.

Each cell's per-rank ``dot_flops`` and ``argument_bytes`` are held against
the reference's, read from ``dryrun_reference.json`` beside this module
(written from the JAX package by ``tests/dryrun_reference.py``; this
package never imports it): ``fidelity`` in the cell's result, and a cell
that misses the aim fails the run as an error does.  The aim: equal
argument bytes and dot FLOPs within ``AIM`` (0.95-1.05) of the
reference's.  Only a training step under FSDP may fall below: the
reference runs its attention on the whole batch on every rank of the FSDP
axis, where the port splits the batch there.  Such a cell meets the aim
when its products other than attention's two and the SSD's
(``no_attention``: the count again with them dot-free, the table's
``rest_dot_flops`` the reference's) are within ``AIM``, and so is its
attention times the table's ``attention_repeat`` (how many times the
reference repeats its attention over the FSDP ranks, read from its own
count without FSDP: 16 for deepseek-7b, 12.5 for glm4-9b, whose HLO splits
two of the backward's products over "data"): each rank does its share of
what the reference repeats, bounded from both sides (``PERF.md`` lists
each such cell).

Usage:
    python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --jobs 8 --out build/dryrun_torch
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import multiprocessing
import os
import re
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.overrides import TorchFunctionMode

from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.distributed import roofline as rf
from repro_torch.distributed import sharding as sh
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.nn import modules as nn_modules
from repro_torch.nn import ssd as ssd_lib
from repro_torch.train import train_step as ts_lib

REFERENCE_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "dryrun_reference.json")
# the band of the port's per-rank dot FLOPs over the reference's
AIM = (0.95, 1.05)

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


class _ReadTracker(TorchFunctionMode):
    """Records every tensor the step passes to a torch function, or whose
    DTensor methods ``redistribute``, ``to_local`` or ``full_tensor`` it
    calls (Python methods, which no mode sees: wrapped while the tracker
    is entered), as one that it reads: not the metadata calls (shape,
    ``zeros_like``) nor the destination of a write that reads nothing
    (``copy_``, ``zero_``, ``fill_``, setting ``.grad``)."""

    _METHODS = ("redistribute", "to_local", "full_tensor")

    _METADATA = {"__get__", "__set__", "size", "dim", "numel", "element_size",
                 "zeros_like", "ones_like", "empty_like", "full_like",
                 "new_zeros", "new_ones", "new_empty", "new_full"}
    _WRITE_ONLY = {"copy_", "zero_", "fill_"}

    def __init__(self):
        super().__init__()
        self.read: set[int] = set()
        self._saved: dict = {}

    def __enter__(self):
        for name in self._METHODS:
            method = self._saved[name] = getattr(DTensor, name)

            def wrapped(t, *args, _method=method, **kwargs):
                self.read.add(id(t))
                return _method(t, *args, **kwargs)
            setattr(DTensor, name, wrapped)
        return super().__enter__()

    def __exit__(self, *exc):
        for name, method in self._saved.items():
            setattr(DTensor, name, method)
        return super().__exit__(*exc)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name not in self._METADATA:
            tensors = rf._tensors((args, kwargs))
            if name in self._WRITE_ONLY:
                tensors = tensors[1:]
            self.read.update(id(t) for t in tensors)
        return func(*args, **kwargs)


def _named_leaves(tree, prefix: str = "", names: tuple = ()) -> list:
    """(path, tensor) of every tensor in ``tree`` (dicts, lists, tuples,
    modules' parameters); a list as long as the model's parameters (the
    optimizer's ``m``, ``v``, ``master``) named by them."""
    if isinstance(tree, torch.nn.Module):
        return [(f"{prefix}/{n}", p) for n, p in tree.named_parameters()]
    if isinstance(tree, dict):
        if not names and isinstance(tree.get("params"), torch.nn.Module):
            names = tuple(n for n, _ in tree["params"].named_parameters())
        return [leaf for k, v in tree.items()
                for leaf in _named_leaves(v, f"{prefix}/{k}", names)]
    if isinstance(tree, (list, tuple)):
        labels = names if names and len(tree) == len(names) else range(len(tree))
        return [leaf for k, v in zip(labels, tree)
                for leaf in _named_leaves(v, f"{prefix}/{k}", names)]
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    return []


def _layerless(path: str) -> str:
    """A leaf's path with its layer (and group) indices dropped: every
    layer of a kind reads the same leaves."""
    return re.sub(r"\.\d+(?=\.|$)", "", path)


def _read_bytes(args, read: set, within=None) -> int:
    """Bytes one rank holds of the leaves of ``args`` whose layerless path
    the step read (``read``: ``_count``'s); with ``within``, of those
    leaves that are also in that tree."""
    ids = None if within is None else {id(t) for _, t in _named_leaves(within)}
    return sum(_local_bytes(t) for path, t in _named_leaves(args)
               if _layerless(path) in read and (ids is None or id(t) in ids))


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


def _scores_free(q, k):
    """``modules._qk``'s shape, (B, G, gq, Sq, Sk), without a product."""
    return q.float().sum(-1, keepdim=True) + k.float().sum(-1)[:, :, None, None, :]


def _mix_free(p, v):
    """``modules._pv``'s shape, (B, G, gq, Sq, D), without a product."""
    return p.float().sum(-1, keepdim=True) * v.float().sum(2)[:, :, None, None, :]


def _einsum_free(spec: str, *operands):
    """``torch.einsum(spec, *operands)``'s shape without a product: each
    operand summed over the labels the output lacks, broadcast, added."""
    ins, out = spec.replace(" ", "").split("->")
    total = None
    for labels, t in zip(ins.split(","), operands):
        drop = [i for i, c in enumerate(labels) if c not in out]
        t = t.float().sum(dim=drop) if drop else t.float()
        kept = [c for c in labels if c in out]
        order = sorted(range(len(kept)), key=lambda i: out.index(kept[i]))
        t = t.permute(*order)
        kept = [kept[i] for i in order]
        t = t.reshape([t.shape[kept.index(c)] if c in kept else 1 for c in out])
        total = t if total is None else total + t
    return total


@contextlib.contextmanager
def no_attention():
    """Attention's two products (``modules._qk``, ``_pv``: the flash loop,
    decode, cross-attention) and the SSD's (every ``einsum`` of
    ``nn.ssd``: its chunked dual form, attention's counterpart, and its
    decode recurrence) replaced by dot-free stand-ins of their shapes while
    it is entered; gradients still reach their operands, so every other
    product and its backward pass is unchanged."""
    saved = nn_modules._qk, nn_modules._pv, ssd_lib.torch
    nn_modules._qk, nn_modules._pv = _scores_free, _mix_free
    ssd_lib.torch = _NoEinsum()
    try:
        yield
    finally:
        nn_modules._qk, nn_modules._pv, ssd_lib.torch = saved


class _NoEinsum:
    """``torch`` for ``nn.ssd`` with a dot-free ``einsum``."""

    def __getattr__(self, name):
        return getattr(torch, name)

    einsum = staticmethod(_einsum_free)


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
    """The step's counts (``roofline.count_step``), the local bytes of its
    outputs, and the layerless paths of the arguments it read (``read``)."""
    step, args, _, _ = _build_cell(cfg, shape, rules, mesh, batch_seq_shard)
    leaves = _named_leaves(args)  # before the step replaces its counters
    tracker = _ReadTracker()

    def tracked(*a):
        with tracker:
            return step(*a)

    with implicit_replication():
        out, analysis = rf.count_step(tracked, *args)
    analysis["output_bytes"] = _local_bytes(out)
    analysis["read"] = {_layerless(path) for path, t in leaves if id(t) in tracker.read}
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
    out["read"] = base["read"]
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
                         shape_name, mesh_name, variant, held=not overrides)
    finally:
        dist.destroy_process_group()


def _run_cell(cfg, shape, multi_pod, vspec, cell_id, t0, arch, shape_name,
              mesh_name, variant, held: bool) -> dict:
    """``run_cell``'s body; ``held``: the cell is the table's (no overrides)
    and its result gets a ``fidelity``."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    kind = shape.kind
    rules = rules_for(cfg, kind, mesh, style=vspec.get("style", "1d"))
    seq = bool(vspec.get("batch_seq_shard"))
    result = {"cell": cell_id, "arch": arch, "shape": shape_name,
              "mesh": mesh_name, "kind": kind, "variant": variant,
              "fsdp": rules.fsdp_axis is not None}

    analysis = count_cell(cfg, shape, rules, mesh, seq)
    read = analysis.pop("read")
    # full depth on meta: the arguments the step reads, the dropped
    # shardings, the outputs
    _, args, dropped, aliased = _build_cell(cfg, shape, rules, mesh, seq)
    arg_bytes = _read_bytes(args, read)
    alias_bytes = _read_bytes(args, read, within=aliased) if aliased is not None else 0
    del args, aliased
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
    result["status"] = "ok"
    fid = result["fidelity"] = fidelity(result) if held else None
    if fid is not None and fid["dot_flops_ratio"] < AIM[0]:
        with no_attention():
            rest = count_cell(cfg, shape, rules, mesh, seq)["dot_flops"]
        result["fidelity"] = fidelity(result, rest)
    result["compile_seconds"] = time.time() - t0
    return result


def reference_entry(cell: str) -> dict | None:
    """The reference's entry for ``arch|shape|mesh`` in the table, or None
    where the table has none."""
    if not os.path.exists(REFERENCE_TABLE):
        return None
    with open(REFERENCE_TABLE) as f:
        return json.load(f).get("|".join(cell.split("|")[:3]))


def fidelity(result: dict, rest: float | None = None, ref: dict | None = None) -> dict | None:
    """A baseline cell's per-rank dot FLOPs over the reference's, its
    argument bytes less the reference's, and whether it meets the aim (the
    module docstring); with ``rest`` (the port's dot FLOPs under
    ``no_attention``), also the products other than attention's over the
    reference's, attention's (the SSD's with it), and for a training cell
    under FSDP attention's times the reference's ``attention_repeat``
    (``attention_share``).  Against ``ref`` (an entry of the table's form)
    where given, else the table's; None for a variant or a cell the table
    lacks."""
    if ref is None and result.get("variant", "baseline") == "baseline":
        ref = reference_entry(result["cell"])
    if ref is None or ref.get("status") != "ok":
        return None
    ratio = result["analysis"]["dot_flops"] / ref["dot_flops"]
    extra = result["memory"]["argument_bytes"] - ref["argument_bytes"]
    out = {"dot_flops_ratio": ratio, "argument_bytes_extra": extra}
    held = AIM[0] <= ratio <= AIM[1]
    if rest is not None:
        out["rest_ratio"] = rest / ref["rest_dot_flops"]
        attention = ref["dot_flops"] - ref["rest_dot_flops"]
        out["attention_ratio"] = ((result["analysis"]["dot_flops"] - rest) / attention
                                  if attention else None)
        repeat = ref.get("attention_repeat")
        if result["kind"] == "train" and result.get("fsdp") and attention and repeat:
            out["attention_share"] = out["attention_ratio"] * repeat
            held = held or (AIM[0] <= out["rest_ratio"] <= AIM[1]
                            and AIM[0] <= out["attention_share"] <= AIM[1])
    out["in_aim"] = held and extra == 0
    return out


def compare(directory: str) -> int:
    """One line per baseline cell in ``directory`` (``--out``'s JSON): its
    status and, against the reference's table, the dot-FLOP ratio and the
    extra argument bytes.  1 if a cell is not ``ok`` or misses the aim."""
    bad = 0
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name)) as f:
            res = json.load(f)
        if res.get("variant", "baseline") != "baseline" or res["status"] == "skipped":
            continue
        fid = (res.get("fidelity") or fidelity(res)) if res["status"] == "ok" else None
        bad += fid is None or not fid["in_aim"]
        print(json.dumps({"cell": res["cell"], "status": res["status"], **(fid or {})}))
    return 1 if bad else 0


def _run_guarded(arch: str, shape: str, mesh: str, variant: str) -> dict:
    """``run_cell``, a cell that raises recorded as ``status: error``."""
    try:
        return run_cell(arch, shape, multi_pod=(mesh == "multi"), variant=variant)
    except Exception as e:  # recorded, never skipped: the cell is an error
        return {"cell": f"{arch}|{shape}|{mesh}|{variant}", "status": "error",
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=[a for a in ARCH_IDS if a != "boundswitch-h32"])
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="directory for per-cell JSON")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a process of its own")
    ap.add_argument("--compare", metavar="DIR",
                    help="run nothing: hold the cells an earlier --out wrote to DIR "
                         "against the reference's table")
    args = ap.parse_args(argv)
    if args.compare:
        return compare(args.compare)

    cells = []
    archs = [a for a in ARCH_IDS if a != "boundswitch-h32"] if args.all else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for a in archs:
        for s in shapes:
            for m in meshes:
                cells.append((a, s, m, args.variant))

    if args.jobs > 1:
        pool = ProcessPoolExecutor(args.jobs, mp_context=multiprocessing.get_context("spawn"))
        results = pool.map(_run_guarded, *zip(*cells))
    else:
        pool, results = None, (_run_guarded(*c) for c in cells)
    failed = missed = 0
    try:
        for res in results:
            failed += res.get("status") == "error"
            line = {k: res.get(k) for k in ("cell", "status", "reason", "error")}
            print(json.dumps(line), flush=True)
            if res.get("status") == "ok":
                r = res["roofline"]
                print(f"  compute={r['compute_s']*1e3:.3f}ms memory={r['memory_s']*1e3:.3f}ms "
                      f"collective={r['collective_s']*1e3:.3f}ms dominant={r['dominant']} "
                      f"mem/dev={res['memory']['per_device_total']/2**30:.2f}GiB "
                      f"seconds={res['compile_seconds']:.1f}", flush=True)
                fid = res["fidelity"]
                if fid is not None:
                    missed += not fid["in_aim"]
                    rest = ""
                    if "attention_share" in fid:
                        rest = (f" (without attention x{fid['rest_ratio']:.4f}, attention "
                                f"x{fid['attention_share']:.4f} of its share)")
                    elif "rest_ratio" in fid:
                        rest = f" (without attention x{fid['rest_ratio']:.4f})"
                    print(f"  reference: dot_flops x{fid['dot_flops_ratio']:.4f}{rest} "
                          f"argument_bytes {fid['argument_bytes_extra']:+d} "
                          f"{'in aim' if fid['in_aim'] else 'OUTSIDE THE AIM'}", flush=True)
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                fname = res["cell"].replace("|", "_") + ".json"
                with open(os.path.join(args.out, fname), "w") as f:
                    json.dump(res, f, indent=1)
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
    return 1 if failed or missed else 0


if __name__ == "__main__":
    raise SystemExit(main())
