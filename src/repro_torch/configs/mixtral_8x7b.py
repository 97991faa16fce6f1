"""Mixtral-8x7B [arXiv:2401.04088] — 8 experts top-2, sliding-window attention."""
from .base import ModelConfig, MoEConfig, register

register(ModelConfig(
    name="mixtral-8x7b",
    arch_type="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1000000.0,
    sliding_window=4096,
    long_context_mode="swa",   # O(window) decode cache => long_500k runs
    moe=MoEConfig(n_experts=8, n_shared_experts=0, top_k=2, d_expert=14336),
    citation="arXiv:2401.04088",
))
