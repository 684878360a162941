"""zamba2-7b-instruct — Zyphra's Zamba2-7B-Instruct at its published widths
(https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json;
arXiv:2411.15242, arXiv:2405.16712).

81 Mamba2 layers (d 3584, expand 2, 112 heads of 64, state 64, two B/C
groups, conv 4, chunk 256) and two shared transformer blocks, used in turn
at the 13 ``hybrid_layer_ids``.  At site j (layer ``hybrid_layer_ids[j]``)
block j mod 2 reads the residual stream beside the token embeddings,
[x, e] (7168 wide): attention of 32 heads of 224 (RoPE, scale
(224 / 2) ** -0.5), then a GELU-gated MLP of width 14336 whose gate_up
carries site j's own rank-128 delta; site j's own linear (3584 x 3584)
maps the block's output, and the sum enters layer
``hybrid_layer_ids[j]``'s Mamba input, not the residual stream.

The family is ``zamba2`` (``models.lm``): the registry's ``zamba2-7b``
(family ``hybrid``, the JAX package's approximation) is another model and
stays as it is.  This module is not listed in ``registry.ARCH_IDS``;
``get_config("zamba2-7b-instruct")`` finds it by name.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class Zamba2Config(ModelConfig):
    """``ModelConfig`` with the published hybrid's own fields."""

    ssm_groups: int = 1                  # B/C groups (mamba_ngroups)
    hybrid_layer_ids: tuple = ()         # layers whose Mamba input a block feeds
    num_mem_blocks: int = 1              # shared blocks, used in turn
    shared_adapter_rank: int = 0         # rank of each site's gate_up delta
    mlp_act: str = "gelu"                # exact GELU on the gate (the first half)

    def __post_init__(self):
        super().__post_init__()
        if self.mlp_act != "gelu":
            raise ValueError(f"mlp_act {self.mlp_act!r}: the published block gates by gelu")
        if self.ssm_heads % self.ssm_groups:
            raise ValueError(f"{self.ssm_heads} heads do not split into "
                             f"{self.ssm_groups} B/C groups")
        if any(not 0 <= i < self.n_layers for i in self.hybrid_layer_ids):
            raise ValueError(f"hybrid_layer_ids {self.hybrid_layer_ids} outside "
                             f"{self.n_layers} layers")

    @property
    def attn_width(self) -> int:
        """The shared attention's input: [hidden, embeddings]."""
        return 2 * self.d_model

    def param_count(self) -> int:
        """Every parameter, the embedding counted once (tied head)."""
        d, di, h, n = self.d_model, self.d_inner, self.ssm_heads, self.ssm_state
        gn = self.ssm_groups * n
        conv = di + 2 * gn
        mamba = (d                                  # the layer's norm
                 + d * (2 * di + 2 * gn + h)        # in_proj: z, x, B, C, dt
                 + self.ssm_conv_width * conv + conv  # conv weight and bias
                 + 3 * h                            # dt_bias, A_log, D
                 + di                               # the gated norm
                 + di * d)                          # out_proj
        a, hd, f = self.attn_width, self.head_dim, self.d_ff
        block = (a + a * self.n_heads * hd + 2 * a * self.n_kv_heads * hd
                 + self.n_heads * hd * d            # norm, q, k, v, o
                 + d + d * 2 * f + f * d)           # norm, gate_up, down
        site = d * self.shared_adapter_rank + self.shared_adapter_rank * 2 * f + d * d
        embed = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        return (self.n_layers * mamba + self.num_mem_blocks * block
                + len(self.hybrid_layer_ids) * site + embed + d)


CONFIG = Zamba2Config(
    name="zamba2-7b-instruct",
    family="zamba2",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=224,                        # attention_head_dim: 2 x 3584 / 32
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    ssm_conv_width=4,
    ssm_groups=2,
    hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    num_mem_blocks=2,
    shared_adapter_rank=128,
    rope_theta=10000.0,
    norm_eps=1e-5,
    dtype="bfloat16",
    tie_embeddings=True,                 # assumed: Zamba2Config ties by default
    bank_mode="none",
)
