"""Tiny configs used by the runnable examples and the e2e search drivers."""
from .base import ModelConfig, register

# Small char-level LM that can actually be trained on CPU for the e2e
# search demonstration (examples/train_and_search.py).
register(ModelConfig(
    name="tiny-lm",
    arch_type="dense",
    n_layers=4,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=64,
    rope_theta=10000.0,
    dtype="float32",
    citation="in-repo synthetic-task model",
))

# Sentence embedder used for ETS semantic clustering (encoder).
register(ModelConfig(
    name="tiny-embedder",
    arch_type="encoder",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=64,
    causal=False,
    act="gelu",
    dtype="float32",
    citation="in-repo embedding model (stands in for math-BERT)",
))
