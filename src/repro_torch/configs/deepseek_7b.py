"""deepseek-7b — llama-arch dense MHA [arXiv:2401.02954; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,           # full MHA
    d_ff=11008,
    vocab_size=102400,
    bank_mode="adapter",
    bank_slots=4,
)
