"""arctic-480b — MoE 128 experts top-2 with a dense residual MLP per layer
[hf:Snowflake/snowflake-arctic-base; hf].

At ~480B total params this cell exists to prove state sharding: bf16 adam
moments + no fp32 master + experts sharded over the model axis and expert
matrices additionally sharded over data (ZeRO-style).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,              # 56 heads: flattened-qkv sharding path
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    n_experts=128,
    experts_per_token=2,
    moe_dense_residual=True,
    master_weights=False,    # pure-bf16 params: 480B fp32 masters can't fit
    moments_dtype="bfloat16",
    bank_mode="head",
    bank_slots=4,
)
