"""Mamba2-370m — pure SSD (attention-free) family.

Public numbers from the Mamba2 release (state-spaces/mamba2-370m):
48 layers, d_model 1024, expand 2, d_state 128, head_dim 64, GPT-NeoX
tokenizer vocab.  This is the smallest pure-mamba2 config; it exists so
the serving stack has a registered attention-free *mamba* family
(rwkv6-7b covers the wkv flavour) — the paged engine serves it through
``RecurrentRuntime`` with a zero-layer KV pool and one state page per
sequence.
"""
from .base import ModelConfig, SSMConfig, register

register(ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,               # attention-free
    n_kv_heads=0,
    d_ff=0,                  # no channel-mix FFN in mamba blocks
    vocab_size=50288,
    ssm=SSMConfig(kind="mamba2", d_state=128, d_conv=4, head_dim=64,
                  expand=2, chunk_size=256),
    norm_eps=1e-5,
    tie_embeddings=True,
    dtype="bfloat16",
    long_context_mode="recurrent",
    citation="Dao & Gu, Transformers are SSMs (Mamba-2), ICML 2024",
))
