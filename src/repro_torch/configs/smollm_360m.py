"""smollm-360m — llama-arch small dense GQA [hf:HuggingFaceTB/SmolLM; hf].

Small enough for the paper's *full* model residency: the whole param pytree
is banked K times, the closest LM analogue of BoundSwitch's weight bank.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,              # 15 heads: not divisible by TP=16 on purpose —
    n_kv_heads=5,            # sharding falls to the flattened qkv dim
    d_ff=2560,
    vocab_size=49152,
    tie_embeddings=True,
    bank_mode="full",
    bank_slots=2,
)
