"""olmoe-1b-7b — MoE, 64 experts top-8 [arXiv:2409.02060; hf].

Token->expert routing reuses the banked grouped-dispatch machinery: MoE is
the paper's sigma at token granularity (DESIGN.md §5).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    n_experts=64,
    experts_per_token=8,
    bank_mode="adapter",
    bank_slots=4,
)
