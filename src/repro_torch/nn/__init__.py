"""LM building blocks: norms, rotary embeddings, flash attention, SwiGLU,
the MoE layer and the Mamba2 / SSD block."""
