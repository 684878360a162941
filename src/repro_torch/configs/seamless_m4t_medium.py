"""seamless-m4t-medium — multimodal encoder-decoder backbone
[arXiv:2308.11596; hf].

Audio frontend is a STUB: precomputed frame embeddings feed the encoder.
12L interpreted as 12 encoder + 12 decoder layers (m4t text-decoder depth).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=24,             # total: enc + dec
    n_enc_layers=12,
    n_dec_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,       # padded to 256256 for TP divisibility
    cross_len=4096,
    frontend="frame",
    frontend_len=0,          # encoder input IS the frame stream
    bank_mode="head",
    bank_slots=4,
)
