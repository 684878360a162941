"""Path-based sharding rules -> specs -> DTensor placements, with
auto-legalization (torch port of the reference's
``repro.distributed.sharding``).

Every parameter is matched by the *suffix* of its reference path against a
rule table; the rule yields logical axes for the trailing dims (leading
stacked dims — layers / groups / bank slots — are always replicated).
Logical axes map to mesh axes per run:

    tp   -> "model"
    fsdp -> "data"  (only when the run enables FSDP; else replicated)
    dp   -> ("pod", "data") on the multi-pod mesh, ("data",) single-pod

A spec is a tuple with one entry per tensor dim, as the reference's
``PartitionSpec``: ``None`` (replicated), a mesh-axis name, or a tuple of
names (the dim sharded over several mesh dims, the first the major one).
``placements`` turns a spec into one ``Shard(dim)`` / ``Replicate()`` per
mesh dim.

Paths are the reference's: the port's parameter ``layers.3.attn.wq`` is
the reference leaf ``layers/attn/wq``, whose leading layer axis is stacked;
the port's per-layer tensor takes the reference spec's trailing entries,
and ``legalize`` reports dropped entries under the reference's path and dim
(the stacked leaf's), once per leaf.

``legalize`` drops any spec entry whose dim is not divisible by the mapped
mesh-axis size (e.g. smollm's 15 heads) — the shard would be uneven.
Dropped entries are recorded so the dry-run can report them.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    tp_axis: str = "model"
    fsdp_axis: Optional[str] = None     # set to "data" to enable FSDP/ZeRO
    dp_axes: tuple = ("data",)          # batch axes
    style: str = "1d"                   # "1d" (baseline) | "2d" (serve:
                                        # weights shard OUTPUT dims over
                                        # (fsdp x tp); contraction dims never
                                        # shard)


# rule table: (path regex, logical axes for the TRAILING dims)
# logical names: "tp", "fsdp", None
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed/embedding$",        ("tp", "fsdp")),
    (r"head/w$",                 ("fsdp", "tp")),
    (r"bank_head/w$",            (None, "fsdp", "tp")),
    (r"attn/w[qkv]$",            ("fsdp", "tp")),
    (r"attn/wo$",                ("tp", "fsdp")),
    (r"self_attn/w[qkv]$",       ("fsdp", "tp")),
    (r"self_attn/wo$",           ("tp", "fsdp")),
    (r"cross_attn/w[qkv]$",      ("fsdp", "tp")),
    (r"cross_attn/wo$",          ("tp", "fsdp")),
    (r"mlp/w[gu]$",              ("fsdp", "tp")),
    (r"mlp/wd$",                 ("tp", "fsdp")),
    (r"moe/router$",             (None, None)),
    (r"moe/w[gu]$",              ("tp", "fsdp", None)),   # experts over model
    (r"moe/wd$",                 ("tp", None, "fsdp")),
    (r"mamba/in_proj$",          ("fsdp", "tp")),
    (r"mamba/out_proj$",         ("tp", "fsdp")),
    (r"mamba/conv_w$",           (None, "tp")),
    (r"mamba/conv_b$",           ("tp",)),
    (r"adapter/a$",              (None, "tp", None)),     # (K, d@tp, r)
    (r"adapter/b$",              (None, None, "tp")),     # (K, r, out@tp)
    (r"frontend_proj/w$",        (None, "tp")),
    (r"frame_proj/w$",           (None, "tp")),
    (r"(norm|ln\d|scale)",       None),                   # norms: replicate
]


# "2d" serve style: every matrix shards only its OUTPUT dim, jointly over
# (fsdp, tp) where available.  "both" maps to the (fsdp_axis, tp_axis) tuple.
_PARAM_RULES_2D: list[tuple[str, tuple]] = [
    (r"embed/embedding$",        ("tp", "fsdp")),   # gather, not contraction
    (r"head/w$",                 (None, "both")),
    (r"bank_head/w$",            (None, None, "both")),
    (r"(attn|self_attn|cross_attn)/w[qkv]$", (None, "both")),
    (r"(attn|self_attn|cross_attn)/wo$",     (None, "both")),
    (r"mlp/w[gud]$",             (None, "both")),
    (r"moe/router$",             (None, None)),
    (r"moe/w[gud]$",             ("tp", None, "fsdp")),
    (r"mamba/in_proj$",          (None, "both")),
    (r"mamba/out_proj$",         (None, "both")),
    (r"mamba/conv_w$",           (None, "tp")),
    (r"mamba/conv_b$",           ("tp",)),
    (r"adapter/a$",              (None, "tp", None)),
    (r"adapter/b$",              (None, None, "tp")),
    (r"frontend_proj/w$",        (None, "tp")),
    (r"frame_proj/w$",           (None, "tp")),
    (r"(norm|ln\d|scale)",       None),
]


def ref_path(name: str) -> tuple[str, int]:
    """A port parameter name -> (the reference's leaf path, the number of
    stacked axes in front of the port tensor's dims)."""
    parts = name.split(".")
    keys = [p for p in parts if not p.isdigit()]
    return "/".join(keys), len(parts) - len(keys)


def _logical_to_mesh(logical, rules: ShardingRules):
    if logical == "tp":
        return rules.tp_axis
    if logical == "fsdp":
        return rules.fsdp_axis
    if logical == "both":
        axes = tuple(a for a in (rules.fsdp_axis, rules.tp_axis) if a)
        return axes if len(axes) > 1 else (axes[0] if axes else None)
    return None


def spec_for_path(path_s: str, ndim: int, rules: ShardingRules) -> tuple:
    """The spec of a ``ndim``-dim leaf at the reference path ``path_s``."""
    table = _PARAM_RULES_2D if rules.style == "2d" else _PARAM_RULES
    for pattern, trailing in table:
        if re.search(pattern, path_s):
            if trailing is None:
                return ()
            axes = [_logical_to_mesh(a, rules) for a in trailing]
            lead = [None] * max(0, ndim - len(axes))
            return tuple(lead + axes[-ndim:] if ndim < len(axes) else lead + axes)
    return ()  # default: replicate


def param_specs(model: nn.Module, rules: ShardingRules) -> dict:
    """{parameter name: spec} for every parameter of ``model`` (meta
    tensors do), in ``model.parameters()`` order."""
    return {name: spec_for_path(ref_path(name)[0], p.ndim, rules)
            for name, p in model.named_parameters()}


def _axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``, or of any object with the
    reference mesh's ``axis_names`` and ``devices``."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _path_key(entry):
    path, dim, _ = entry
    return (path.split("/"), dim)


def legalize(specs: dict, shapes: dict, mesh):
    """Drop spec entries whose dims don't divide the mesh axis size.

    ``specs`` / ``shapes`` map the same names (parameter names, or
    "/"-joined tree paths) to specs and to tensors (or shapes).  Returns
    ``(legal_specs, dropped)``; ``dropped`` lists ``(path, dim, axis)``
    under the reference's leaf path and dim, once per leaf, in the
    reference's order (its tree order: sorted keys).
    """
    axis_size = _axis_sizes(mesh)
    dropped: set = set()
    legal = {}
    for name, spec in specs.items():
        leaf = shapes[name]
        shape = tuple(getattr(leaf, "shape", leaf))
        path, lead = ref_path(name)
        new = []
        for i, entry in enumerate(spec[:len(shape)]):
            if entry is None:
                new.append(None)
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            total = 1
            for a in axes:
                total *= axis_size[a]
            if shape[i] % total == 0:
                new.append(entry)
            else:
                dropped.add((path, i + lead, entry))
                new.append(None)
        legal[name] = tuple(new)
    return legal, sorted(dropped, key=_path_key)


def tree_paths(tree, prefix: str = "") -> dict:
    """A nested dict of tensors (a batch, a cache) flattened to
    {"/"-joined path: leaf}, ``None`` leaves skipped."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(tree_paths(v, path))
        elif v is not None:
            out[path] = v
    return out


def tree_unflatten(flat: dict) -> dict:
    """``tree_paths``' inverse."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def _dp_entry(rules: ShardingRules):
    dp = tuple(a for a in rules.dp_axes if a)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def batch_specs(batch: dict, rules: ShardingRules) -> dict:
    """Batch dims shard over dp axes; everything else replicated.  Keyed by
    ``tree_paths``."""
    dp = _dp_entry(rules)
    return {path: (() if leaf.ndim == 0 else (dp, *([None] * (leaf.ndim - 1))))
            for path, leaf in tree_paths(batch).items()}


def cache_specs(cache: dict, rules: ShardingRules) -> dict:
    """KV / SSM caches: leading stacked dims replicated, batch dim over dp.

    Cache leaves look like (L, B, G, Lc, hd) / (L, B, H, P, N) /
    (groups, L, B, ...): the batch dim follows the stacked layer dims.
    Keyed by ``tree_paths``.
    """
    dp = _dp_entry(rules)
    out = {}
    for name, leaf in tree_paths(cache).items():
        nd = leaf.ndim
        entries = [None] * nd
        if re.search(r"(^|/)(k|v)$", name) and nd >= 2:
            entries[1] = dp
        elif re.search(r"(ssm|conv)$", name) and nd >= 2:
            # batch dim: for (n, B, ...) it's 1; for (groups, n, B, ...) it's 2
            bdim = nd - 4 if name.endswith("ssm") else nd - 3
            entries[max(bdim, 0)] = dp
        out[name] = tuple(entries)
    return out


def opt_state_specs(param_spec_tree: dict, opt_state: dict) -> dict:
    """Optimizer state shards like its params (m/v/master mirror them)."""
    specs = {"m": param_spec_tree, "v": param_spec_tree, "step": ()}
    if "master" in opt_state:
        specs["master"] = param_spec_tree
    return specs


def placements(mesh, spec: tuple) -> list:
    """The spec as one ``Shard(dim)`` or ``Replicate()`` per mesh dim.  A
    tuple entry shards its dim over several mesh dims, which must appear
    in the mesh's order (the first the major one)."""
    names = mesh.mesh_dim_names
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def distribute(t: torch.Tensor, mesh, spec: tuple) -> torch.Tensor:
    """``t`` (the same full tensor on every rank) as a DTensor: each rank
    keeps its own slice, no data moves (meta tensors included)."""
    return distribute_tensor(t, mesh, placements(mesh, spec), src_data_rank=None)


def distribute_tree(tree: dict, mesh, specs: dict) -> dict:
    """Every leaf of a nested dict (a batch, a cache) distributed by the
    spec under its ``tree_paths`` path."""
    return tree_unflatten({p: distribute(t, mesh, specs[p])
                           for p, t in tree_paths(tree).items()})


def distribute_state(state: dict, mesh, specs: dict, batch: dict | None = None):
    """The train state (``train_step.init_train_state``'s layout) and a
    batch as DTensors, in place: each parameter of ``state["params"]``
    becomes a DTensor parameter, and the optimizer lists ``m``, ``v``,
    ``master`` (``model.parameters()`` order) follow the same specs.  The
    step counters stay host tensors.  ``specs`` = {"params": {name: spec},
    "opt": ``opt_state_specs``'s dict[, "batch": ``batch_specs``]}.
    Returns ``(state, batch)``."""
    model = state["params"]
    pspecs = specs["params"]
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        mod._parameters[leaf] = nn.Parameter(
            distribute(p.detach(), mesh, pspecs[name]), requires_grad=p.requires_grad)
    names = list(pspecs)
    for key in ("m", "v", "master"):
        if key in state["opt"]:
            ospecs = specs["opt"][key]
            state["opt"][key] = [distribute(t, mesh, ospecs[n])
                                 for n, t in zip(names, state["opt"][key])]
    if batch is not None:
        batch = distribute_tree(batch, mesh, specs["batch"])
    return state, batch


def gather_state(state: dict) -> dict:
    """``distribute_state``'s inverse, in place: every DTensor parameter
    and optimizer list entry made whole (a plain tensor on every rank)."""
    model = state["params"]
    for name, p in list(model.named_parameters()):
        if hasattr(p, "full_tensor"):
            owner, _, leaf = name.rpartition(".")
            mod = model.get_submodule(owner) if owner else model
            mod._parameters[leaf] = nn.Parameter(p.detach().full_tensor(),
                                                 requires_grad=p.requires_grad)
    for key in ("m", "v", "master"):
        if key in state.get("opt", {}):
            state["opt"][key] = [t.full_tensor() if hasattr(t, "full_tensor") else t
                                 for t in state["opt"][key]]
    return state
