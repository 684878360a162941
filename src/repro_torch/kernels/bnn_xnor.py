"""Bit-packed XNOR-popcount binary matmul (paper Eq. 1, layer 1).

``xnor_matmul`` launches the Hopper kernel ``csrc/xnor_matmul.cu`` on CUDA
tensors; on CPU tensors it runs the plain version ``xnor_matmul_ref``.
``xnor_matmul.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import xnor_matmul_ref


def cuda_args(*tensors: torch.Tensor):
    """Raw device pointers (None for a missing tensor) and the current stream."""
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    return ptrs, torch.cuda.current_stream().cuda_stream


def xnor_matmul(x_packed: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """Binary matmul: (B, W) x (H, W) int32 words -> (B, H) int32 +-1 dot products."""
    if x_packed.dim() != 2 or w_packed.dim() != 2:
        raise ValueError("xnor_matmul takes (B, W) and (H, W) word matrices")
    b, w_words = x_packed.shape
    h = w_packed.shape[0]
    if w_packed.shape[1] != w_words:
        raise ValueError("word-count mismatch between x and w")
    if x_packed.dtype != torch.int32 or w_packed.dtype != torch.int32:
        raise TypeError("packed words must be torch.int32")
    if not x_packed.is_cuda:
        return xnor_matmul_ref(x_packed, w_packed)
    if w_packed.device != x_packed.device:
        raise ValueError("x and w must be on one device")
    if x_packed.stride(1) != 1 or w_packed.stride(1) != 1:
        raise ValueError("word rows must be contiguous")
    out = torch.empty((b, h), dtype=torch.int32, device=x_packed.device)
    if b and h:
        with torch.cuda.device(x_packed.device):
            (xp, wp, op), stream = cuda_args(x_packed, w_packed, out)
            _build.launch("xnor_matmul", xp, wp, op, b, h, w_words,
                          x_packed.stride(0), w_packed.stride(0), stream)
        xnor_matmul.launches += 1
    return out


xnor_matmul.launches = 0
