"""Llemma-34B (paper's main model; codellama-34b arch) — dry-run only."""
from .base import ModelConfig, register

register(ModelConfig(
    name="llemma-34b",
    arch_type="dense",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=32000,
    rope_theta=1000000.0,
    citation="arXiv:2310.10631 (Llemma); paper's search LLM",
))
