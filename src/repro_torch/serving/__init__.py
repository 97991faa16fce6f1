"""Serving runtime: paged decode engine, sampler, LM search backend."""
from .engine import DecodeStream, EngineConfig, PagedEngine  # noqa: F401
from .sampler import sample_tokens_rowwise  # noqa: F401
from .search_backend import BackendConfig, LMBackend  # noqa: F401
