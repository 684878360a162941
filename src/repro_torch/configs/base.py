"""Model / run configuration system (the port's own copy of the JAX
package's pure-Python module, so that the port imports nothing of it).

One frozen dataclass covers every assigned architecture family; per-arch
files under ``repro_torch/configs`` instantiate it with the exact published
hyper-parameters, and ``reduced()`` derives the CPU smoke-test variant.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None           # default d_model // n_heads
    sliding_window: Optional[int] = None     # SWA (h2o-danube3)

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_dense_residual: bool = False         # arctic: dense FFN in parallel
    moe_capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # --- hybrid (zamba2): shared attention block every N ssm layers ---
    attn_every: int = 0
    shared_attn: bool = False

    # --- enc-dec (seamless) ---
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    cross_len: int = 4096                    # encoder-memory length at decode

    # --- modality frontend stubs (vlm / audio) ---
    frontend: Optional[str] = None           # "patch" | "frame"
    frontend_len: int = 0                    # embeddings prepended per sample

    # --- numerics / misc ---
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 256
    tie_embeddings: bool = False

    # --- model bank (the paper's technique, lifted to this arch) ---
    bank_mode: str = "none"                  # none | full | adapter | head
    bank_slots: int = 2
    adapter_rank: int = 16

    # --- training ---
    remat: str = "full"                      # none | full
    master_weights: bool = True              # fp32 master copy of params
    moments_dtype: str = "float32"           # adam m/v dtype (bf16 for huge)

    # --- perf-iteration knobs (EXPERIMENTS.md §Perf; defaults = baseline) ---
    flash_remat: bool = False        # recompute flash inner scans in bwd
    seq_shard_attention: bool = False  # shard q-block seq dim over TP axis
                                       # (kills head-replication waste when
                                       # n_heads is not divisible by TP)
    cache_dtype: str = "model"       # "model" (= cfg.dtype) | "int8":
                                     # quantized KV cache with native int8
                                     # QK/PV dots (halves decode cache reads)
    seq_shard_activations: bool = False  # Megatron-SP: pin the residual
                                         # stream's token dim to the TP axis
                                         # between layers

    def __post_init__(self):
        if self.head_dim is None and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode state: SSM, hybrid, or bounded (SWA) cache."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    def kv_cache_len(self, seq_len: int) -> int:
        """Per-layer attention cache length at decode for a given context."""
        if self.sliding_window is not None:
            return min(seq_len, self.sliding_window)
        return seq_len

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        return _param_count(self, active_only=True)

    def reduced(self, **over) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            vocab_pad_multiple=32,
            n_experts=min(self.n_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=32,
            ssm_chunk=16,
            attn_every=2 if self.attn_every else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            n_dec_layers=min(self.n_dec_layers, 2),
            cross_len=32,
            sliding_window=32 if self.sliding_window else None,
            frontend_len=8 if self.frontend else 0,
            adapter_rank=4,
            remat="none",
            name=self.name + "-reduced",
        )
        small.update(over)
        return dataclasses.replace(self, **small)


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    d, f, v = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    hd = cfg.head_dim or 0
    q_dim = cfg.n_heads * hd
    kv_dim = cfg.n_kv_heads * hd

    def attn_params():
        return d * q_dim + 2 * d * kv_dim + q_dim * d

    def mlp_params(ff):
        return 3 * d * ff  # SwiGLU: gate, up, down

    def ssm_params():
        di = cfg.d_inner
        heads = cfg.ssm_heads
        g = 1  # single B/C group
        in_proj = d * (2 * di + 2 * g * cfg.ssm_state + heads)
        conv = cfg.ssm_conv_width * (di + 2 * g * cfg.ssm_state)
        out = di * d + di  # out_proj + D skip(+gate norm folded)
        return in_proj + conv + out + heads  # + A per head

    n = 2 * v * d if not cfg.tie_embeddings else v * d
    if cfg.family == "dense":
        per = attn_params() + mlp_params(f) + 2 * d
        n += cfg.n_layers * per
    elif cfg.family == "moe":
        e = cfg.experts_per_token if active_only else cfg.n_experts
        per = attn_params() + e * mlp_params(f) + d * cfg.n_experts + 2 * d
        if cfg.moe_dense_residual:
            per += mlp_params(f)
        n += cfg.n_layers * per
    elif cfg.family == "ssm":
        n += cfg.n_layers * (ssm_params() + d)
    elif cfg.family == "hybrid":
        n_attn_apps = cfg.n_layers // max(cfg.attn_every, 1)
        shared = attn_params() + mlp_params(f) + 2 * d
        n += cfg.n_layers * (ssm_params() + d)
        n += shared if cfg.shared_attn else n_attn_apps * shared
    elif cfg.family == "encdec":
        enc = attn_params() + mlp_params(f) + 2 * d
        dec = 2 * attn_params() + mlp_params(f) + 3 * d
        n += cfg.n_enc_layers * enc + cfg.n_dec_layers * dec
    else:
        raise ValueError(cfg.family)
    return n


# ---------------------------------------------------------------------------
# input shapes (assigned to every arch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether a (arch x shape) cell runs; reason recorded when skipped."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "pure full-attention arch: 500k dense KV decode has no sub-quadratic path (DESIGN.md §5)"
    return True, ""
