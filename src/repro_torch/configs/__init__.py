"""Architecture config registry.  ``get_config('<arch-id>')``.

The port registers every configuration of the reference: the dense
models, the VLM (``qwen2-vl-7b``: M-RoPE, patch frontend), the audio
encoder (``hubert-xlarge``: frame frontend), the MoE
(``deepseek-moe-16b``, ``mixtral-8x7b``), SSM (``mamba2-370m``,
``rwkv6-7b``) and hybrid (``zamba2-7b``) families, and the tiny test
models.
"""
from .base import (  # noqa: F401
    ModelConfig, MoEConfig, SSMConfig, InputShape, INPUT_SHAPES,
    get_shape, get_config, list_configs, register, tiny_variant,
)

_LOADED = False

_ARCH_MODULES = [
    "deepseek_moe_16b", "zamba2_7b", "hubert_xlarge", "phi3_mini_3_8b",
    "qwen2_vl_7b", "llama3_2_1b", "mixtral_8x7b", "qwen3_14b",
    "rwkv6_7b", "yi_6b", "llemma_34b", "mamba2_370m", "tiny",
]


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    import importlib
    for m in _ARCH_MODULES:
        importlib.import_module(f"{__name__}.{m}")
