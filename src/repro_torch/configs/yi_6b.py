"""Yi-6B [arXiv:2403.04652] — llama-arch GQA kv=4."""
from .base import ModelConfig, register

register(ModelConfig(
    name="yi-6b",
    arch_type="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5000000.0,
    citation="arXiv:2403.04652",
))
