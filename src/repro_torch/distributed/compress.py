"""Int8 gradient codec and the compressed all-reduce (torch port of the
reference's ``repro.distributed.compress``).

Symmetric, saturating int8 quantization with one f32 scale per leaf.  The
codes are bit-equal to the reference's on the same f32 input: the same f32
operations in the same order, and ``torch.round`` rounds half to even as
``jnp.round`` does.  ``compress_grads`` applies the codec leaf by leaf and
models the compressed cross-pod reduce in single-program form;
``compressed_psum`` is that reduce over one axis of a ``DeviceMesh``,
moving int8-valued codes (summed as int32) instead of the values.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def quantize(x: torch.Tensor, axis=None):
    """x -> (int8 codes, f32 scale).  Symmetric, saturating."""
    xf = x.to(torch.float32)
    amax = xf.abs().max() if axis is None else xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    codes = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return codes, scale


def dequantize(codes: torch.Tensor, scale: torch.Tensor, dtype=torch.float32):
    return (codes.to(torch.float32) * scale).to(dtype)


def quantize_dequantize(x: torch.Tensor) -> torch.Tensor:
    codes, scale = quantize(x)
    return dequantize(codes, scale, x.dtype)


def compress_grads(grads: list) -> list:
    """The codec applied leaf by leaf; a ``None`` gradient (a parameter the
    loss does not reach: zero) stays ``None``, as zeros code to zeros."""
    return [None if g is None else quantize_dequantize(g) for g in grads]


def compressed_psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """All-reduce ``x`` over the mesh axis ``axis`` moving int8 codes.

    Each rank computes its local scale; the scales are max-reduced so every
    rank codes against one shared scale; the codes are summed as int32 and
    the sum times the shared scale (f32) is cast back to ``x.dtype`` — the
    reference's order.  The sum is over integers, so every rank gets the
    same bits.
    """
    group = mesh.get_group(axis)
    _, scale = quantize(x)
    gscale = scale.clone()
    dist.all_reduce(gscale, op=dist.ReduceOp.MAX, group=group)
    codes = torch.clamp(torch.round(x.to(torch.float32) / gscale), -127, 127).to(torch.int8)
    summed = codes.to(torch.int32)
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    return (summed.to(torch.float32) * gscale).to(x.dtype)
