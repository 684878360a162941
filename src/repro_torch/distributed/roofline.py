"""Per-rank roofline counts of an eager step, and the roofline terms on an
H100 (torch port of the reference's ``repro.distributed.roofline``).

The reference parses the SPMD-partitioned HLO.  Here ``count_step`` runs
the step under ``StepCounter``, a ``TorchDispatchMode`` that sees every op
on the tensors one rank holds.  On DTensors it defers to DTensor's own
dispatch (``NotImplemented``, as ``CommDebugMode`` does), so what it counts
are the local ops DTensor issues: per-rank shapes, and the collectives that
its redistributions issue.  DTensor's own sharding propagation (on fake
tensors, or on tagged meta tensors) is not counted.  It counts:

  * ``dot_flops``: the matrix products (``mm``, ``bmm``, ``addmm``,
    ``baddbmm``, ...) by ``torch.utils.flop_counter``'s formulas;
  * ``hbm_bytes``: every op's input and output bytes; views (``view``,
    ``transpose``, ``permute``, ``expand``, ``slice``, ``detach``, ...),
    allocations and waits count 0.  Eager PyTorch does not fuse, so this is
    what the step moves, not the reference's fusion-boundary count;
  * collective bytes per rank, with the reference's factors:

      all-reduce          2 x result bytes          (bidirectional ring)
      all-gather          result bytes              ((n-1)/n ~ 1)
      reduce-scatter      result bytes x (gs - 1)   (input = result x gs)
      all-to-all          result bytes
      collective-permute  result bytes;

  * ``peak_live_bytes``: the most bytes that the step's own outputs held
    at once (storages made during the step, released as they die).

Hardware model: one H100 SXM (989e12 bf16 dense FLOP/s, 3.35e12 B/s HBM3)
and one 400 Gb/s NDR InfiniBand port per GPU (50e9 B/s).  A 16 x 16 mesh
spans 32 eight-GPU nodes, so its axes cross nodes; one port is the
conservative link.  (Inside a node NVLink moves 450 GB/s per direction.)
"""

from __future__ import annotations

import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

HW = {
    "peak_flops": 989e12,   # bf16 dense per GPU (H100 SXM)
    "hbm_bw": 3.35e12,      # bytes/s per GPU (HBM3)
    "link_bw": 50e9,        # bytes/s per GPU: one 400 Gb/s NDR port
}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional collectives (the ops DTensor's redistributions issue) -> kind
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute",
}

# ops that move no bytes: allocations, aliases and waits
_NO_BYTES = {"empty", "empty_strided", "empty_like", "detach", "alias",
             "lift_fresh", "as_strided", "wait_tensor", "_local_scalar_dense"}


def _tensors(tree, out: list | None = None) -> list:
    """The tensors in nested lists, tuples and dicts (a fast flatten: the
    counter runs it on every op)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            _tensors(item, out)
    elif isinstance(tree, dict):
        for item in tree.values():
            _tensors(item, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_propagation(ins: list, outs: list) -> bool:
    """Whether the op is DTensor working out a sharding, not the step:
    its shape propagation runs on fake tensors, its propagation through an
    op's decomposition on meta tensors tagged with a ``_spec``."""
    return (any(isinstance(t, FakeTensor) for t in outs)
            or any(hasattr(t, "_spec") for t in ins))


class StepCounter(TorchDispatchMode):
    """Counts one rank's matrix FLOPs, bytes moved, collective bytes and
    peak live bytes over the ops run under it (see the module docstring)
    that touch a tensor of ``device_type``: the step's device, not the
    host scalars beside it nor DTensor's own bookkeeping on the CPU."""

    def __init__(self, device_type: str):
        super().__init__()
        self.device_type = device_type
        self.dot_flops = 0.0
        self.hbm_bytes = 0.0
        self.collective = {k: 0.0 for k in COLLECTIVES}
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._seen = weakref.WeakKeyDictionary()

    def _release(self, nbytes: int) -> None:
        self.live_bytes -= nbytes

    def _track(self, outs: list) -> None:
        for t in outs:
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            weakref.finalize(st, self._release, n)
            self.live_bytes += n
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor issue its local ops first
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if _is_propagation(ins, outs):
            return out
        if not any(t.device.type == self.device_type for t in ins + outs):
            return out
        name = func.overloadpacket.__name__
        if func.overloadpacket in flop_registry:
            self.dot_flops += flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out)
        kind = _COLLECTIVE_OPS.get(name)
        if kind is not None:
            rb = sum(_nbytes(t) for t in outs)
            if kind == "all-reduce":
                rb *= 2
            elif kind == "reduce-scatter":
                group_size = next(a for a in args if isinstance(a, int))
                rb *= max(group_size - 1, 1)
            self.collective[kind] += rb
        if not func.is_view and name not in _NO_BYTES:
            self.hbm_bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self._track(outs)
        return out

    def analysis(self) -> dict:
        """The reference's ``analyze`` keys, plus ``peak_live_bytes``."""
        coll = dict(self.collective)
        return {
            "dot_flops": self.dot_flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": coll,
            "collective_bytes_total": sum(coll.values()),
            "peak_live_bytes": self.peak_live_bytes,
        }


def _device_type(tree) -> str:
    """The device type of the first tensor in ``tree`` (dicts, lists,
    tuples, modules' parameters; a DTensor's local shard)."""
    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters())
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, torch.Tensor):
        return (tree.to_local() if isinstance(tree, DTensor) else tree).device.type
    if isinstance(tree, (list, tuple)):
        for item in tree:
            found = _device_type(item)
            if found:
                return found
    return ""


def count_step(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under a ``StepCounter`` on the device of its
    first tensor argument: (its result, the counts of one rank)."""
    counter = StepCounter(_device_type(args))
    with counter:
        out = fn(*args, **kwargs)
    return out, counter.analysis()


def roofline_terms(analysis: dict) -> dict:
    """Seconds per step for each roofline term (per GPU: the counts are
    one rank's)."""
    compute_s = analysis["dot_flops"] / HW["peak_flops"]
    memory_s = analysis["hbm_bytes"] / HW["hbm_bw"]
    coll_s = analysis["collective_bytes_total"] / HW["link_bw"]
    dominant = max(
        ("compute", compute_s), ("memory", memory_s), ("collective", coll_s),
        key=lambda kv: kv[1],
    )[0]
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "dominant": dominant,
        "step_s_lower_bound": max(compute_s, memory_s, coll_s),
    }


def model_flops(cfg, shape, kind: str) -> float:
    """MODEL_FLOPS: 6*N*D (train) / 2*N*D (inference), N = active params.

    enc-dec splits the position budget (S/2 frames through the encoder,
    S/2 tokens through the decoder), so D uses seq_len/2 — each token only
    crosses its own stack.
    """
    n_active = cfg.active_param_count()
    seq = shape.seq_len // 2 if cfg.family == "encdec" else shape.seq_len
    if kind == "train":
        tokens = shape.global_batch * seq
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch  # decode: one token per sequence
    return 2.0 * n_active * tokens
