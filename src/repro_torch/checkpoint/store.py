"""Tensor checkpoint store (torch port): MessagePack manifest + compressed
leaf files, in the reference's on-disk format.

Leaves are zstd-compressed when ``zstandard`` is importable, else stdlib
zlib; the codec is recorded in the manifest and either codec is accepted on
restore (restore reads leaf filenames from the manifest, so the extension is
informational only — legacy checkpoints whose zlib leaves were written with
a ``.zst`` suffix still restore).

Layout::

    <dir>/step_<N>/
        MANIFEST.msgpack     # {step, codec, leaves: [{path, file, shape,
                             #  dtype}], extra}
        <leaf-hash>.bin.zst  # one compressed raw-bytes file per leaf
                             # (.bin.zlib under the zlib fallback)

A tree is nested ``dict`` / ``list`` / ``tuple`` of torch tensors or NumPy
arrays.  Leaves are visited in the reference's flatten order (dict keys
sorted, sequences by index) and named by their ``/``-joined path, so the
manifest (written with `repro_torch.codec`) and the leaf file names are
byte-equal to the reference's for the same tree, and a checkpoint written
by either package restores in the other.  ``bfloat16`` leaves are held as
their ``uint16`` bit patterns under the dtype name ``"bfloat16"``.

Commit protocol: everything is written into ``step_<N>.tmp`` and atomically
renamed — a crash mid-save never corrupts the latest checkpoint.  Restore
places every leaf on one device (``device=None``: CUDA), where the
reference re-shards onto a JAX mesh.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import zlib

import numpy as np
import torch

from repro_torch import codec
from repro_torch.device import resolve_device

try:
    import zstandard as zstd
except ImportError:  # gated: fall back to stdlib zlib (codec recorded below)
    zstd = None

_BF16 = "bfloat16"


def _compressor():
    """(codec_name, compress_fn) — zstd when available, else stdlib zlib."""
    if zstd is not None:
        return "zstd", zstd.ZstdCompressor(level=3).compress
    return "zlib", lambda raw: zlib.compress(raw, 3)


def _decompress(codec_name: str, blob: bytes) -> bytes:
    if codec_name == "zstd":
        if zstd is None:
            raise ModuleNotFoundError(
                "checkpoint was written with zstd; install `zstandard` to "
                "restore it")
        return zstd.ZstdDecompressor().decompress(blob)
    if codec_name == "zlib":
        return zlib.decompress(blob)
    raise ValueError(f"unknown checkpoint codec {codec_name!r}")


_LEAF_EXT = {"zstd": "zst", "zlib": "zlib"}


def _leaf_file(path_s: str, codec_name: str) -> str:
    return (hashlib.sha1(path_s.encode()).hexdigest()[:16] + ".bin."
            + _LEAF_EXT[codec_name])


def _flatten(tree, prefix: tuple = ()) -> list:
    """[(path parts, leaf)] in the reference's flatten order."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in _flatten(v, prefix + (str(i),))]
    return [(prefix, tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from ``leaves``."""
    if isinstance(like, dict):
        got = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: got[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _host_array(leaf) -> tuple[np.ndarray, str]:
    """(raw host array, dtype name) of one leaf; bf16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _shape_of(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)


def _to_tensor(arr: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    """A private tensor of ``arr``'s bits on ``device`` (uint32: int32 with
    the same bits, the port's packed-word convention)."""
    if dtype_name == _BF16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


def save(directory: str, step: int, tree, extra: dict | None = None,
         keep_last: int | None = None) -> str:
    """Write ``tree`` as checkpoint ``step_<step>``; returns final path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    codec_name, compress = _compressor()
    manifest: dict = {"step": step, "codec": codec_name, "leaves": [],
                      "extra": extra or {}}
    for parts, leaf in _flatten(tree):
        ps = "/".join(parts)
        arr, dtype_name = _host_array(leaf)
        fname = _leaf_file(ps, codec_name)
        with open(os.path.join(tmp, fname), "wb") as f:
            f.write(compress(np.ascontiguousarray(arr).tobytes()))
        manifest["leaves"].append({
            "path": ps,
            "file": fname,
            "shape": list(arr.shape),
            "dtype": dtype_name,
        })
    with open(os.path.join(tmp, "MANIFEST.msgpack"), "wb") as f:
        f.write(codec.packb(manifest))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit

    if keep_last is not None:
        steps = sorted(list_steps(directory))
        for s in steps[:-keep_last]:
            shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                          ignore_errors=True)
    return final


def list_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name.split("_")[1]))
            except (IndexError, ValueError):
                continue
    return sorted(out)


def latest_step(directory: str) -> int | None:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: int | None, like_tree, *, device=None):
    """Restore into the structure of ``like_tree``, every leaf a tensor on
    ``device`` (``None``: CUDA).  Returns (tree, extra_metadata).

    Raises ``KeyError`` for a leaf the checkpoint lacks and ``ValueError``
    for a shape that differs from ``like_tree``'s.
    """
    dev = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    ckpt = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(ckpt, "MANIFEST.msgpack"), "rb") as f:
        manifest = codec.unpackb(f.read())
    by_path = {e["path"]: e for e in manifest["leaves"]}
    codec_name = manifest.get("codec", "zstd")  # pre-codec checkpoints were zstd

    out = []
    for parts, like in _flatten(like_tree):
        ps = "/".join(parts)
        if ps not in by_path:
            raise KeyError(f"checkpoint missing leaf {ps}")
        e = by_path[ps]
        with open(os.path.join(ckpt, e["file"]), "rb") as f:
            raw = _decompress(codec_name, f.read())
        host_dtype = np.uint16 if e["dtype"] == _BF16 else np.dtype(e["dtype"])
        arr = np.frombuffer(raw, dtype=host_dtype).reshape(e["shape"])
        if tuple(arr.shape) != tuple(_shape_of(like)):
            raise ValueError(
                f"shape mismatch for {ps}: ckpt {arr.shape} vs model "
                f"{tuple(_shape_of(like))}")
        out.append(_to_tensor(arr, e["dtype"], dev))
    return _unflatten(like_tree, iter(out)), manifest["extra"]
