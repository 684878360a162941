"""Decode attention over a static KV cache: one new query token a row.

``decode_attention`` launches the Hopper kernel ``csrc/decode_attention.cu``
on CUDA tensors and runs its plain version ``decode_attention_ref`` on CPU
(or meta) tensors.  Row b attends over its cache's first ``min(cache_len[b]
+ 1, L)`` positions, which is both the causal mask (positions up to the new
token's) and a sliding window's ring (every resident position).  Scores are
f32 dot products times ``scale``, the softmax is exact over those positions,
the probabilities are rounded to the cache's dtype before the value
product, which sums in f32, and the output is rounded once to ``out_dtype``.
The kernel reads only those positions, in the cache's own dtype; the plain
version is the port's earlier arithmetic: the whole cache in f32, the rest
masked.

``decode_attention.launches`` counts kernel launches by the cache's dtype
(``"bfloat16"``, ``"float32"``).
"""

from __future__ import annotations

import collections

import torch

from . import _build
from .bnn_xnor import cuda_args

__all__ = ["CHUNK", "decode_attention", "decode_attention_ref"]

F32 = torch.float32
NEG = torch.finfo(F32).min
# positions one CTA takes (the kernel's kChunk, which refuses any other)
CHUNK = 256
MAX_HEAD_DIM = 256
# the scores kernel holds a group's queries in f32 in 48 KB of shared memory
MAX_QUERY_FLOATS = 48 * 1024 // 4
_DTYPES = (torch.float32, torch.bfloat16)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         cache_len: torch.Tensor, scale: float,
                         out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of ``decode_attention``: every position scored in f32,
    the invalid ones masked, softmax, the probabilities cast to v's dtype,
    the value product in f32."""
    lcache = k.shape[2]
    kpos = torch.arange(lcache, device=k.device)
    valid = kpos[None, :] < torch.clamp(cache_len + 1, max=lcache)[:, None]
    scores = torch.matmul(q.to(F32), k.to(F32).transpose(-1, -2)[:, :, None]) * scale
    scores = torch.where(valid[:, None, None, None], scores, NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype).to(F32), v.to(F32)[:, :, None])
    return out.to(out_dtype)


def decode_attention(
    q: torch.Tensor,          # (B, G, gq, S, D): each group's query heads
    k: torch.Tensor,          # (B, G, L, D) the cache, f32 or bf16
    v: torch.Tensor,          # (B, G, L, D) same dtype and strides
    cache_len: torch.Tensor,  # (B,) int: row b's new token sits at position cache_len[b]
    scale: float,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Attention of q over each row's valid cache positions -> (B, G, gq, S,
    D) in ``out_dtype``.  The S tokens of a row share its positions."""
    bsz, g, gq, s, d = q.shape
    if tuple(k.shape[:2]) != (bsz, g) or k.shape[3] != d or k.shape != v.shape \
            or tuple(cache_len.shape) != (bsz,):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, cache_len {tuple(cache_len.shape)}")
    if not k.is_cuda:
        return decode_attention_ref(q, k, v, cache_len, scale, out_dtype)
    dev = k.device
    if any(t.device != dev for t in (q, v, cache_len)):
        raise ValueError("q, the cache and cache_len must be on one device")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES or v.dtype != k.dtype \
            or out_dtype not in _DTYPES:
        raise TypeError(f"decode_attention takes float32 or bfloat16, not q {q.dtype}, "
                        f"k {k.dtype}, v {v.dtype}, out {out_dtype}")
    m = gq * s
    if d % 8 or d > MAX_HEAD_DIM or m * d > MAX_QUERY_FLOATS:
        raise ValueError(f"decode_attention: head dim {d} must be a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}, and {m} queries x {d} within {MAX_QUERY_FLOATS}")
    vec = 16 // k.element_size()
    if k.stride() != v.stride() or k.stride(3) != 1 or any(st % vec for st in k.stride()[:3]) \
            or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention: the caches need one set of strides, rows of "
                         "16-byte aligned contiguous head dims")
    lcache = k.shape[2]
    qc = q.reshape(bsz, g, m, d).contiguous()
    cl = cache_len.to(torch.int64).contiguous()
    n_chunks = -(-lcache // CHUNK)
    scores = torch.empty((bsz, g, m, lcache), dtype=F32, device=dev)
    partial = torch.empty((bsz, g, m, n_chunks, d), dtype=F32, device=dev)
    out = torch.empty((bsz, g, m, d), dtype=out_dtype, device=dev)
    if bsz and g and m:
        with torch.cuda.device(dev):
            ptrs, stream = cuda_args(qc, k, v, cl, scores, partial, out)
            _build.launch("decode_attention", *ptrs, bsz, g, m, lcache, d,
                          *k.stride()[:3], float(scale),
                          int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
                          int(out_dtype == torch.bfloat16), CHUNK, stream)
        decode_attention.launches[str(k.dtype).removeprefix("torch.")] += 1
    return out.reshape(bsz, g, gq, s, d)


decode_attention.launches = collections.Counter()
