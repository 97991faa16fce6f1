"""Qwen3-14B [hf:Qwen/Qwen3-8B family] — dense, qk_norm, GQA kv=8."""
from .base import ModelConfig, register

register(ModelConfig(
    name="qwen3-14b",
    arch_type="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    rope_theta=1000000.0,
    qk_norm=True,
    citation="hf:Qwen/Qwen3-8B",
))
