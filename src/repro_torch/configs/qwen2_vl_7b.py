"""Qwen2-VL-7B [arXiv:2409.12191] — VLM backbone, M-RoPE; vision frontend stubbed."""
from .base import ModelConfig, register

register(ModelConfig(
    name="qwen2-vl-7b",
    arch_type="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    rope_theta=1000000.0,
    mrope_sections=(16, 24, 24),   # (t, h, w) rotary splits of head_dim=128
    frontend_dim=1280,
    citation="arXiv:2409.12191",
))
