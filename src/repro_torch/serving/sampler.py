"""Token sampling (port of ``repro.serving.sampler``).

Row keys are jax's threefry2x32 keys, reproduced here from the algorithm
(20 rounds, rotations 13,15,26,6 / 17,29,16,24, key parity 0x1BD11BDA)
in the layout of ``jax_threefry_partitionable`` (jax's default): a key is
a ``(2,)`` uint32 pair, ``key(seed) = [0, seed]``, ``fold_in(k, d) =
threefry(k, (0, d))`` and ``split(k, n)[i] == fold_in(k, i)``.

Two parts:

  * host (numpy): the key chains — ``key``, ``fold_in``, ``split`` and
    ``split_rows`` (one split of every row's chain per decode step);
  * device: ``sample_tokens_rowwise`` draws each row's token on the
    logits' device and moves only the B tokens to the host.  At
    temperature > 0 it goes through ``kernels.ops.gumbel_sample``: on a
    CUDA device one hand-written kernel
    (``kernels/csrc/gumbel_sample.cu``) computes the bits, the noise and
    the row argmax in registers; on the CPU the plain version below
    (``gumbel_argmax``), which is the kernel's oracle.  The plain
    version, in PyTorch on the logits' device: ``gumbel`` draws a row's
    noise from its key with counters ``(0, j)``, bits ``x0 ^ x1``, ``u =
    bitcast((bits >> 9) | 0x3f800000) - 1``, ``u * (1 - tiny) + tiny``
    clamped at ``tiny`` and ``-log(-log(u))``, as ``jax.random.gumbel``
    does; ``gumbel_argmax`` takes the per-row argmax of ``logits /
    temperature + noise``.  The kernel gives the plain version's tokens
    on the same device bit for bit.

What matches the reference: keys, bits and uniforms bit for bit; the
noise within a few ulp (each ``log`` is computed in float64 and rounded
to float32, XLA's is its own float32 ``log``); so the
sampled tokens are jax's except where two candidates tie within that
noise.  Greedy decoding (temperature <= 0) is a plain argmax.

A row's token depends only on its own key chain and logits, never on
which rows share the batch, so a sweep reproduces solo runs.

Integer arithmetic of the plain version: int64 lanes (numpy arrays or
torch tensors) holding uint32 values, masked to 32 bits after every add
and rotation.  Every op used (``+ & | ^ << >>``) exists for int64 on the
CPU and on CUDA, which ``torch.uint32`` does not promise.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KEY_PARITY = 0x1BD11BDA
# smallest normal float32: the uniform's lower end, as in jax.random
TINY = float(np.finfo(np.float32).tiny)
LN2 = float(np.log(2.0))


def _rotl(x, r: int):
    return ((x & (MASK32 >> r)) << r) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """jax's threefry2x32 hash of counters (x0, x1) under key (k0, k1).

    Arguments are broadcastable int64 numpy arrays or torch tensors (or
    Python ints) holding uint32 values; returns ``(y0, y1)`` in the same
    kind and layout."""
    ks = (k0, k1, k0 ^ k1 ^ _KEY_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


# ---------------------------------------------------------------------------
# host part: key chains (numpy)
# ---------------------------------------------------------------------------

def as_keys(keys) -> np.ndarray:
    """``keys`` checked as (..., 2) key words in [0, 2**32): uint32."""
    k = np.asarray(keys)
    if k.shape[-1:] != (2,):
        raise ValueError(f"keys must have a trailing axis of 2, got shape "
                         f"{k.shape}")
    if k.dtype != np.uint32 and np.any((k < 0) | (k > MASK32)):
        raise ValueError("key words must lie in [0, 2**32)")
    return k.astype(np.uint32)


def _fold(keys, data) -> np.ndarray:
    """threefry(keys[..., None, :], (0, data)) -> (..., len(data), 2)."""
    k = as_keys(keys).astype(np.int64)
    d = np.asarray(data, np.int64)
    y0, y1 = threefry2x32(k[..., 0, None], k[..., 1, None], 0, d)
    return np.stack([y0, y1], axis=-1).astype(np.uint32)


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s data: ``[0, seed]`` as (2,) uint32."""
    seed = int(seed)
    if not 0 <= seed <= MASK32:
        raise ValueError(f"seed must lie in [0, 2**32), got {seed}")
    return np.array([0, seed], np.uint32)


def fold_in(k, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)`` for one (2,) key."""
    data = int(data)
    if not 0 <= data <= MASK32:
        raise ValueError(f"fold_in data must lie in [0, 2**32), got {data}")
    return _fold(k, [data])[0]


def split(k, n: int) -> np.ndarray:
    """``jax.random.split(k, n)`` for one (2,) key: (n, 2), row i
    ``fold_in(k, i)``."""
    return _fold(k, np.arange(int(n)))


def split_rows(keys) -> tuple[np.ndarray, np.ndarray]:
    """One split of every row's chain: keys (n, 2) -> (next (n, 2), sub
    (n, 2)) with ``next = fold_in(k, 0)`` and ``sub = fold_in(k, 1)``
    (the reference engine's per-iteration ``split(k, 2)``)."""
    pair = _fold(keys, [0, 1])
    return pair[:, 0], pair[:, 1]


# ---------------------------------------------------------------------------
# device part: noise and sampling (plain PyTorch on the logits' device)
# ---------------------------------------------------------------------------

def _device_keys(keys, device) -> torch.Tensor:
    return torch.as_tensor(as_keys(keys).reshape(-1, 2).astype(np.int64),
                           device=device)


def random_bits(keys, n: int, device) -> torch.Tensor:
    """``jax.random.bits(k, (n,))`` for each row key: (B, n) int64 lanes
    holding uint32 values."""
    kt = _device_keys(keys, device)
    j = torch.arange(int(n), dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(kt[:, :1], kt[:, 1:], 0, j)
    return y0 ^ y1


def uniform(keys, n: int, device) -> torch.Tensor:
    """``jax.random.uniform(k, (n,), minval=tiny, maxval=1)`` per row
    key: (B, n) float32."""
    fbits = (random_bits(keys, n, device) >> 9) | 0x3F800000
    f = fbits.to(torch.int32).view(torch.float32) - 1.0
    # (1 - tiny) rounds to 1.0 in float32, as it does in jax
    return torch.clamp(f * (1.0 - TINY) + TINY, min=TINY)


def _log(x: torch.Tensor) -> torch.Tensor:
    """``log`` of a positive float32 tensor, rounded once to float32:
    with ``x = m * 2**e``, m in [0.5, 1), ``m - 1`` is exact and ``log(x)
    = log1p(m - 1) + e * ln 2``, summed in float64.

    Not ``torch.log``: on the CPU it calls MKL's vector log, whose first
    multi-threaded call in a process can return one thread's share of
    the elements up to ~1e3 ulp off; ``frexp`` and ``log1p`` do not go
    through MKL."""
    m, e = torch.frexp(x)
    return (torch.log1p(m.double() - 1.0) + e.double() * LN2).float()


def gumbel(keys, n: int, device) -> torch.Tensor:
    """``jax.random.gumbel(k, (n,))`` per row key: (B, n) float32,
    ``-log(-log(u))`` with each log rounded to float32 as jax's are."""
    return -_log(-_log(uniform(keys, n, device)))


def gumbel_argmax(keys, logits: torch.Tensor,
                  temperature: float) -> torch.Tensor:
    """The plain version of ``kernels/csrc/gumbel_sample.cu``: keys (B, 2)
    uint32, logits (B, V) -> (B,) int64 on the logits' device, the
    per-row argmax of ``logits / temperature`` (in float32) plus
    ``gumbel(keys, V)``."""
    return torch.argmax(logits.float() / temperature
                        + gumbel(keys, logits.shape[1], logits.device),
                        dim=-1)


def sample_tokens_rowwise(keys, logits: torch.Tensor,
                          temperature: float = 1.0) -> np.ndarray:
    """keys (B, 2) uint32 row keys, logits (B, V) -> (B,) int32 on the
    host: ``jax.random.categorical(keys[b], logits[b] / temperature)``
    per row, computed on the logits' device (``ops.gumbel_sample``: the
    kernel on a card, ``gumbel_argmax`` on the CPU).  temperature <= 0
    means greedy (``keys`` unused)."""
    if temperature <= 0:
        tok = torch.argmax(logits, dim=-1)
    else:
        tok = ops.gumbel_sample(keys, logits, temperature)
    return tok.to(torch.int32).cpu().numpy()
