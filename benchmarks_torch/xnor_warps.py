#!/usr/bin/env python3
"""Device time of ``xnor_matmul``'s kernel at both CTA shapes, across B.

    python3 benchmarks_torch/xnor_warps.py

On one CUDA GPU, at the paper's H32 layer 1 (H = 32, W = 256 words) on the
payload views of (B, 272) packet rows, for B from 1 to 8192: launches the
kernel with 4 warps over 32 rows and with 16 warps over 16 rows, checks
each against the plain version bit for bit, and prints one JSON line per B
with both device times (CUDA events behind a busy-wait kernel, as
``chip_smoke.py`` takes them) and the shape ``bnn_xnor.xnor_warps`` picks.
The first line is the card's name and power limit.  Exits non-zero without
a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = (1, 16, 64, 256, 1024, 2048, 4096, 4224, 8192)
H, W = 32, 256


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("xnor_warps: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import numpy as np
    from chip_smoke import kernel_device_ms, nvidia_smi, warm_up_clocks
    from repro_torch.core import packet as pkt
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.bnn_xnor import cuda_args, xnor_warps

    print(nvidia_smi("name,power.limit"), flush=True)
    dev = torch.device("cuda")
    warm_up_clocks(dev)
    rng = np.random.default_rng(0)
    rows = pkt.to_device(rng.integers(0, 2**32, (max(ROWS), pkt.META_WORDS + W),
                                      dtype=np.uint32), dev)
    w = pkt.to_device(rng.integers(0, 2**32, (H, W), dtype=np.uint32), dev)
    for b in ROWS:
        x = pkt.payload_of(rows)[:b]
        out = torch.empty((b, H), dtype=torch.int32, device=dev)
        want = ref.xnor_matmul_ref(x, w)
        line = {"B": b, "H": H, "W": W, "xnor_warps": xnor_warps(b, H)}
        for warps in (4, 16):
            (xp, wp, op), stream = cuda_args(x, w, out)

            def run():
                _build.launch("xnor_matmul", xp, wp, op, b, H, W, x.stride(0),
                              w.stride(0), warps, stream)

            out.zero_()
            run()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise RuntimeError(f"xnor_warps: B={b} warps={warps} differs from the plain version")
            line[f"ms_{warps}_warps"] = kernel_device_ms(run)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
