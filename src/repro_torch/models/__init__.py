"""LM families (dense, MoE, SSM, hybrid, encoder-decoder) and their API."""
