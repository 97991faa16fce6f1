"""The sampling noise of a served token, worked out from the algorithm.

The served search samples each token as ``argmax(logits / T + g)``, with
``g`` jax's Gumbel noise drawn from a threefry2x32 key (jax's
partitionable layout).  This file re-derives, from the seed alone, the
key of every decoded token and its noise, so that a sampled token can be
judged like a greedy one: the reference's ``logits / T + g`` should put
the served token first.

Keys (all words uint32):

  * ``key(seed) = (0, seed)``; ``fold_in(k, d) = threefry(k, (0, d))``;
  * a problem's chain starts at ``key(seed)``; search step ``s``
    (1-based) takes ``step = fold_in(chain, 1)`` and moves the chain on
    to ``fold_in(chain, 0)``;
  * branch ``i`` of that step (in the order the step created them)
    starts from ``fold_in(step, i)``;
  * before each token the branch's key ``k`` is split: the token is
    drawn with ``fold_in(k, 1)``, and ``k`` moves on to ``fold_in(k, 0)``;
  * the noise of vocabulary entry ``v`` under a draw key is built from
    ``bits = y0 ^ y1`` of ``threefry(key, (0, v))``:
    ``u = float((bits >> 9) | 0x3f800000) - 1``, ``u = max(u + tiny,
    tiny)``, ``g = -log(-log(u))``, here in float64.

Plain NumPy for the keys, plain PyTorch (int64 lanes) for the noise.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
TINY = float(np.finfo(np.float32).tiny)


def _rotl(x, r):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on int64 lanes that hold uint32s
    (NumPy arrays, torch tensors or ints, broadcast together)."""
    k2 = k0 ^ k1 ^ PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def key(seed: int) -> tuple:
    return (0, int(seed) & MASK32)


def fold_in(k: tuple, d: int) -> tuple:
    y0, y1 = threefry2x32(int(k[0]), int(k[1]), 0, int(d))
    return (int(y0), int(y1))


def step_key(seed: int, step: int) -> tuple:
    """The key of search step ``step`` (1-based) of any problem."""
    chain = key(seed)
    for _ in range(step - 1):
        chain = fold_in(chain, 0)
    return fold_in(chain, 1)


def draw_keys(seed: int, step: int, branch: int, n_tokens: int) -> list:
    """The draw key of each of a branch's first ``n_tokens`` tokens."""
    k = fold_in(step_key(seed, step), branch)
    out = []
    for _ in range(n_tokens):
        out.append(fold_in(k, 1))
        k = fold_in(k, 0)
    return out


def gumbel(keys, vocab: int, device) -> torch.Tensor:
    """(len(keys), vocab) float64 Gumbel noise, one row per draw key."""
    kt = torch.as_tensor(np.asarray(keys, np.int64).reshape(-1, 2),
                         device=device)
    v = torch.arange(vocab, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(kt[:, :1], kt[:, 1:], 0, v)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32).double() - 1.0
    u = torch.clamp(u + TINY, min=TINY)
    return -torch.log(-torch.log(u))
