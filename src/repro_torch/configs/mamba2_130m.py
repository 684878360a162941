"""mamba2-130m — attention-free SSD (state-space duality)
[arXiv:2405.21060; unverified].

Attention-oriented sharding is inapplicable (DESIGN.md §Arch-applicability);
the bank applies in *full* mode — K complete residents, paper-faithful.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,               # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,        # padded to 50432 for TP divisibility
    ssm_state=128,
    ssm_head_dim=64,
    ssm_chunk=256,
    tie_embeddings=True,
    bank_mode="full",
    bank_slots=2,
)
