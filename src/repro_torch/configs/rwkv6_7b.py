"""RWKV6-7B "Finch" [arXiv:2404.05892] — attention-free, data-dependent decay."""
from .base import ModelConfig, SSMConfig, register

register(ModelConfig(
    name="rwkv6-7b",
    arch_type="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=0,               # attention-free
    n_kv_heads=0,
    d_ff=14336,              # channel-mix hidden
    vocab_size=65536,
    ssm=SSMConfig(kind="rwkv6", head_dim=64, chunk_size=128),
    long_context_mode="recurrent",
    citation="arXiv:2404.05892",
))
