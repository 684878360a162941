"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use by its own ``nvcc``
process into ``build/kernels/`` at the root of the checkout (a directory
``.gitignore`` lists), as a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o lib<name>-<hash>.so csrc/<name>.cu

No library links ``-lcuda``: ``banked_matmul.cu`` encodes its TMA tensor
maps with ``cuTensorMapEncodeTiled``, which it finds at run time through
``cudaGetDriverEntryPointByVersion`` (``cuda.h`` is used for its types
only).

The file name carries a hash of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded.  ``build_all``
starts every compile at once and waits for all of them.  Pointers and the
stream are passed as ``ctypes.c_void_p``; every launch function returns
its ``cudaError_t`` (or a negative code of its own, such as a tensor map
the driver could not encode) and ``launch`` raises if it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

#: C signature of each library's launch function: name -> (symbol, argtypes).
SIGNATURES = {
    "fused_forward": ("fused_forward_launch", [
        _P, _P, _P,        # x, row_ids (NULL: contiguous), block_slots
        _P, _P, _P, _P,    # w1, b1, w2, b2
        _P, _P,            # scores, actions (NULL: no actions)
        _I, _I, _I, _I,    # n_blocks, block_b, n_x_rows, row_stride
        _I, _I, _I, _I,    # meta_words, W, H, C
        _I, _P,            # num_slots, stream
    ]),
    "xnor_matmul": ("xnor_matmul_launch", [
        _P, _P, _P,        # x, w, out
        _I, _I, _I,        # B, H, W
        _I, _I,            # x row stride, w row stride
        _I, _P,            # warps per CTA (4 or 16, bnn_xnor.xnor_warps), stream
    ]),
    "banked_xnor_layer1": ("banked_xnor_layer1_launch", [
        _P, _P, _P, _P, _P,  # x, w1, b1, block_slots, out
        _I, _I, _I,          # n_blocks, block_b, x row stride
        _I, _I, _I,          # W, H, num_slots
        _P,                  # stream
    ]),
    "banked_matmul": ("banked_matmul_launch", [
        _P, _P, _P, _P, _P,  # x, w, b (NULL for variant 3 alone), block_slots, out
        _I, _I, _I, _I, _I,  # n_blocks, block_b, D, H, num_slots
        _I, _P,              # variant (0 f32/fma, 1 bf16/fma, 2 bf16/wgmma,
                             # 3 bf16/wgmma.f32out), stream
    ]),
    "decode_attention": ("decode_attention_launch", [
        _P, _P, _P, _P,      # q, k, v, cache_len
        _P, _P, _P,          # scores, partial (f32 scratch), out
        _I, _I, _I, _I, _I,  # B, G, M (queries a group), L, D
        _LL, _LL, _LL,       # the caches' row, group and position strides
        _F,                  # scale
        _I, _I, _I, _I,      # q_bf16, kv_bf16, out_bf16, chunk
        _P,                  # stream
    ]),
}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources(name: str) -> list[Path]:
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names=tuple(SIGNATURES)) -> dict[str, str]:
    """Compile every named library that is not built yet, all at once.

    Returns each compiler's output (``-Xptxas -v`` register and shared
    memory report) by name; raises if any compile fails."""
    jobs = {n: j for n in names if (j := _start(n)) is not None}
    logs, failed = {}, []
    for n, (proc, tmp, out) in jobs.items():
        logs[n], _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{n}:\n{logs[n]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (compiled on first use)."""
    lib = _loaded.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def launch(name: str, *args) -> None:
    """Call library ``name``'s launch function; raise on a CUDA error."""
    symbol, _ = SIGNATURES[name]
    lib = load(name)
    err = getattr(lib, symbol)(*args)
    if err:
        describe = getattr(lib, f"{name}_error_string")
        describe.argtypes, describe.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(
            f"{symbol} failed: error {err} ({describe(err).decode()})")
