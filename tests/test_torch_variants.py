"""The shape rule that picks ``banked_matmul``'s kernel, held on the CPU.

The rule is decided before launch (no fallback after a failed launch), so
it is a pure function of the dtype, D, H and the alignment of the bases;
``tests/test_torch_cuda.py`` runs each of these shapes on the card and
checks that the launch was counted under this variant.
"""

import pytest
import torch

from repro_torch.kernels.banked_matmul import matmul_variant
from test_torch_cuda import MATMUL_SHAPES

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
