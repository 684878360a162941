"""llava-next-34b — VLM backbone (anyres tiling)
[hf:llava-hf/llava-v1.6; unverified].

Per assignment the modality frontend is a STUB: ``input_specs()`` provides
precomputed patch embeddings (B, frontend_len, d_model) prepended to the
token stream; only the transformer backbone is modeled.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    frontend="patch",
    frontend_len=576,        # one 24x24 ViT tile of patch embeddings
    bank_mode="head",
    bank_slots=4,
)
