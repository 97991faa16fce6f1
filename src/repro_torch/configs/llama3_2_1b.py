"""Llama-3.2-1B [hf:meta-llama/Llama-3.2-1B] — small llama3, GQA kv=8."""
from .base import ModelConfig, register

register(ModelConfig(
    name="llama3.2-1b",
    arch_type="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500000.0,
    tie_embeddings=True,
    citation="hf:meta-llama/Llama-3.2-1B",
))
