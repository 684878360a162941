"""The shape rules that pick a kernel's variant, held on the CPU.

``matmul_variant`` picks ``banked_matmul``'s kernel, ``xnor_warps`` the CTA
shape of ``xnor_matmul``'s.  Each rule is decided before launch (no
fallback after a failed launch), so it is a pure function of the shapes
(and, for ``banked_matmul``, the dtype and the alignment of the bases);
``tests/test_torch_cuda.py`` runs each of these shapes on the card.
"""

import pytest
import torch

from repro_torch.kernels.banked_matmul import matmul_variant
from repro_torch.kernels.bnn_xnor import MAX_TILES_16_WARPS, xnor_warps
from test_torch_cuda import MATMUL_SHAPES, XNOR_SHAPES

# bf16 kernel per (D, H) of MATMUL_SHAPES: TMA needs 16-byte row strides,
# so D and H must be multiples of 8 bf16 values.
BF16_KERNEL = {
    (16, 8): "bf16/wgmma", (37, 70): "bf16/fma", (960, 960): "bf16/wgmma",
    (1, 5): "bf16/fma", (64, 200): "bf16/wgmma", (64, 64): "bf16/wgmma",
    (72, 36): "bf16/fma",
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,bb,d,h,k", MATMUL_SHAPES)
def test_matmul_variant_of_each_cuda_shape(dtype, b, bb, d, h, k):
    want = "f32/fma" if dtype == torch.float32 else BF16_KERNEL[(d, h)]
    assert matmul_variant(dtype, d, h) == want


@pytest.mark.parametrize("dtype,want", [(torch.float32, "f32/fma"),
                                        (torch.bfloat16, "bf16/fma")])
def test_matmul_variant_of_a_misaligned_base(dtype, want):
    assert matmul_variant(dtype, 960, 960, aligned=False) == want


def test_matmul_variant_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        matmul_variant(torch.float16, 64, 64)


# xnor_matmul's warps per CTA for each (B, H, W) of XNOR_SHAPES: 16 only up
# to MAX_TILES_16_WARPS tiles of 32 x 32.
XNOR_WARPS = {
    (1, 32): 16, (33, 40): 16, (100, 7): 16, (8192, 32): 4, (1, 40): 16,
    (33, 32): 16, (4200, 40): 4,
}


@pytest.mark.parametrize("b,h,w", XNOR_SHAPES)
def test_xnor_warps_of_each_cuda_shape(b, h, w):
    assert xnor_warps(b, h) == XNOR_WARPS[(b, h)]


@pytest.mark.parametrize("b,h,want", [
    (32 * MAX_TILES_16_WARPS, 32, 16), (32 * MAX_TILES_16_WARPS + 1, 32, 4),
    (16 * MAX_TILES_16_WARPS, 33, 16), (16 * MAX_TILES_16_WARPS + 1, 33, 4),
    (1, 32 * MAX_TILES_16_WARPS + 1, 4), (256, 32, 16), (2048, 32, 4), (0, 32, 16),
])
def test_xnor_warps_counts_tiles_of_rows_and_units(b, h, want):
    """The rule counts ceil(B / 32) * ceil(H / 32) tiles: the control-plane
    replay's B = 1 and B = 256 take 16 warps, the data plane's batch of
    2048 and inference_only's 8192 take 4."""
    assert xnor_warps(b, h) == want
