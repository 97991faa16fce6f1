"""Architecture config registry.  ``get_config('<arch-id>')``.

The port registers the configurations its slices serve: ``llama3.2-1b``
and the tiny test models.  Other architectures join with their model
families.
"""
from .base import (  # noqa: F401
    ModelConfig, MoEConfig, SSMConfig, InputShape, INPUT_SHAPES,
    get_shape, get_config, list_configs, register, tiny_variant,
)

_LOADED = False

_ARCH_MODULES = ["llama3_2_1b", "tiny"]


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    import importlib
    for m in _ARCH_MODULES:
        importlib.import_module(f"{__name__}.{m}")
