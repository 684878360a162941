"""zamba2-7b — hybrid: Mamba2 backbone + *shared* attention block applied
every 6 layers [arXiv:2411.15242; unverified].

The shared attention block is itself a resident shared executor (one weight
set referenced from many sites) — see DESIGN.md §5.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_chunk=256,
    attn_every=6,
    shared_attn=True,
    bank_mode="adapter",
    bank_slots=4,
)
