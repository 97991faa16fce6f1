"""Token sampling (port of ``repro.serving.sampler``).

Row keys: a row's key is a tuple of non-negative ints — the search
backend derives ``(problem seed, step, branch index)`` and the decode
stream appends the row's live-iteration count — and its Gumbel noise is
drawn with numpy from that tuple alone.  So a row's token depends only
on its own key chain and logits, never on which rows share the batch:
a sweep reproduces solo runs inside the port.  The bits differ from
jax's threefry chains (matching them is later work); greedy decoding
(temperature <= 0) is a plain argmax and matches the reference exactly.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

RowKey = Tuple[int, ...]


def gumbel_noise(key: RowKey, n: int) -> np.ndarray:
    """(n,) float64 standard Gumbel noise determined by ``key`` alone."""
    return np.random.default_rng(list(key)).gumbel(size=n)


def sample_tokens_rowwise(keys: Sequence[Optional[RowKey]],
                          logits: torch.Tensor, temperature: float = 1.0
                          ) -> np.ndarray:
    """keys (B,) row keys (None = unoccupied row, sampled as 0), logits
    (B, V) -> (B,) int32 on the host.  temperature <= 0 means greedy."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
    lg = logits.float().cpu().numpy()
    out = np.zeros(lg.shape[0], np.int32)
    for j, key in enumerate(keys):
        if key is None:
            continue
        out[j] = int(np.argmax(lg[j] / temperature
                               + gumbel_noise(key, lg.shape[1])))
    return out
