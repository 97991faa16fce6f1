"""Zamba2-7B [arXiv:2411.15242] — Mamba2 backbone + shared attention blocks."""
from .base import ModelConfig, SSMConfig, register

register(ModelConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,              # shared attention block's MLP
    vocab_size=32000,
    attn_every=6,            # shared attn block applied every 6th layer
    shared_attn_params=True, # Zamba2 reuses one attention block's params
    ssm=SSMConfig(kind="mamba2", d_state=64, d_conv=4, head_dim=64, expand=2),
    # long-context: the shared attention block switches to SWA (window 4096)
    # *only* in long mode so the 500k decode cache stays O(window); mamba
    # state is O(1).  Normal serving uses full attention.
    long_context_window=4096,
    long_context_mode="recurrent",
    citation="arXiv:2411.15242",
))
