"""HuBERT-XLarge [arXiv:2106.07447] — encoder-only audio backbone (stub frontend)."""
from .base import ModelConfig, register

register(ModelConfig(
    name="hubert-xlarge",
    arch_type="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,          # masked-unit prediction classes
    causal=False,
    act="gelu",
    frontend_dim=512,
    citation="arXiv:2106.07447",
))
