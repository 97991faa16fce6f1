"""Random weights from the seed, made on the device in the type they are
served in.

One ``torch.randn`` call per model fills a flat buffer of the model's
dtype (bfloat16 for the served models: no float32 masters exist at any
time); every matrix is a view into it, scaled in place to the port's
initialisation (embedding 0.02, a matrix of fan-in ``n`` 1/sqrt(n)).
Norm weights are ones.  The layout is the port's parameter tree: one
stacked group of all layers, each leaf (L, ...).

The PRM and the embedder carry no output head: their callers read the
value head and the hidden states only.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def spec_of(port: Dict) -> Dict:
    """A model's sizes with the derived and default fields filled in."""
    s = dict(port)
    s.setdefault("head_dim", s["d_model"] // s["n_heads"])
    s.setdefault("norm_eps", 1e-5)
    s.setdefault("rope_theta", 10000.0)
    s.setdefault("act", "swiglu")
    s.setdefault("causal", True)
    s.setdefault("dtype", "bfloat16")
    return s


def _leaves(s: Dict, head: str) -> List[Tuple[Tuple[str, ...], tuple, float]]:
    """(path, shape, std) of every random leaf; std 0 marks a norm."""
    L, d, V = s["n_layers"], s["d_model"], s["vocab_size"]
    H, K, hd = s["n_heads"], s["n_kv_heads"], s["head_dim"]
    g = ("groups", "0")
    out = [(("embed",), (V, d), 0.02),
           (g + ("ln1",), (L, d), 0.0),
           (g + ("attn", "wq"), (L, d, H * hd), d ** -0.5),
           (g + ("attn", "wk"), (L, d, K * hd), d ** -0.5),
           (g + ("attn", "wv"), (L, d, K * hd), d ** -0.5),
           (g + ("attn", "wo"), (L, H * hd, d), (H * hd) ** -0.5),
           (g + ("ln2",), (L, d), 0.0),
           (("ln_f",), (d,), 0.0)]
    moe = s.get("moe")
    if moe:
        E, de = moe["n_experts"], moe["d_expert"]
        ds = de * moe["n_shared_experts"]
        out += [(g + ("moe", "router"), (L, d, E), d ** -0.5),
                (g + ("moe", "w_gate"), (L, E, d, de), d ** -0.5),
                (g + ("moe", "w_up"), (L, E, d, de), d ** -0.5),
                (g + ("moe", "w_down"), (L, E, de, d), de ** -0.5)]
        if ds:
            out += [(g + ("moe", "shared", "w_gate"), (L, d, ds), d ** -0.5),
                    (g + ("moe", "shared", "w_up"), (L, d, ds), d ** -0.5),
                    (g + ("moe", "shared", "w_down"), (L, ds, d),
                     ds ** -0.5)]
    else:
        ff = s["d_ff"]
        out += [(g + ("mlp", "w_up"), (L, d, ff), d ** -0.5),
                (g + ("mlp", "w_down"), (L, ff, d), ff ** -0.5)]
        if s["act"] == "swiglu":
            out.append((g + ("mlp", "w_gate"), (L, d, ff), d ** -0.5))
    if head == "lm":
        out.append((("lm_head",), (d, V), d ** -0.5))
    elif head == "value":
        out.append((("value_head",), (d, 1), d ** -0.5))
    return out


def _put(tree: Dict, path: Tuple[str, ...], t: torch.Tensor) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = t


def make(spec: Dict, head: str, seed: int, device) -> Dict:
    """The parameter tree of one model, from ``seed``.  ``head`` is
    "lm" (output head), "value" (PRM value head) or "none"."""
    dt = DTYPES[spec["dtype"]]
    leaves = _leaves(spec, head)
    n = sum(math.prod(shape) for _, shape, std in leaves if std)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    buf = torch.randn(n, generator=gen, device=device, dtype=dt)
    tree: Dict = {}
    off = 0
    for path, shape, std in leaves:
        if std:
            k = math.prod(shape)
            t = buf[off:off + k].view(shape)
            t.mul_(std)
            off += k
        else:
            t = torch.ones(shape, dtype=dt, device=device)
        _put(tree, path, t)
    tree["groups"] = [tree["groups"]["0"]]
    return tree
