"""Phi-3-mini-3.8B [arXiv:2404.14219] — dense RoPE SwiGLU."""
from .base import ModelConfig, register

register(ModelConfig(
    name="phi3-mini-3.8b",
    arch_type="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10000.0,
    citation="arXiv:2404.14219",
))
