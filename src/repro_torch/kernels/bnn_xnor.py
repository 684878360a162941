"""Bit-packed XNOR-popcount binary matmul (paper Eq. 1, layer 1).

``xnor_matmul`` launches the Hopper kernel ``csrc/xnor_matmul.cu`` on CUDA
tensors, with the warps per CTA that ``xnor_warps`` picks; on CPU tensors
it runs the plain version ``xnor_matmul_ref``.  ``xnor_matmul.launches``
counts the kernel's launches by row count B.
"""

from __future__ import annotations

import collections

import torch

from . import _build
from .ref import xnor_matmul_ref


def cuda_args(*tensors: torch.Tensor):
    """Raw device pointers (None for a missing tensor) and the current stream."""
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    return ptrs, torch.cuda.current_stream().cuda_stream


# The most 32 x 32 tiles at which 16 warps per CTA beat 4: on an H100 80GB
# HBM3 at 700 W (benchmarks_torch/xnor_warps.py, H = 32, W = 256) 16 warps
# were faster up to B = 1024 (32 tiles) and slower from B = 2048 (64 tiles),
# since a 16-warp CTA fits once per SM.
MAX_TILES_16_WARPS = 32


def xnor_warps(b: int, h: int) -> int:
    """Warps per CTA of ``xnor_matmul``'s kernel, decided before launch from
    the number of tiles of 32 rows by 32 hidden units.  Up to
    ``MAX_TILES_16_WARPS`` tiles, 16 warps take 16 rows (one m16 tile) and
    spread the d bits over more warps (B = 1: one CTA of 16 warps); past
    it, 4 warps take 32 rows (two m16 tiles) and four CTAs share an SM."""
    tiles = -(-b // 32) * -(-h // 32)
    return 16 if tiles <= MAX_TILES_16_WARPS else 4


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
                          x_packed.stride(0), w_packed.stride(0),
                          xnor_warps(b, h), stream)
        xnor_matmul.launches[b] += 1
    return out


xnor_matmul.launches = collections.Counter()
