"""DeepSeekMoE-16B [arXiv:2401.06066] — fine-grained MoE, 2 shared + 64 routed top-6."""
from .base import ModelConfig, MoEConfig, register

register(ModelConfig(
    name="deepseek-moe-16b",
    arch_type="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,               # per-expert hidden dim (fine-grained)
    vocab_size=102400,
    rope_theta=10000.0,
    moe=MoEConfig(n_experts=64, n_shared_experts=2, top_k=6, d_expert=1408),
    citation="arXiv:2401.06066",
))
