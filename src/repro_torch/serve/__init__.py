"""The batched LM serving engine with per-request slot routing."""
