"""Plain forward passes of the benchmark's models, in float32.

One decoder family covers every configuration: pre-norm blocks of RMS
norm, grouped-query attention with rotary positions (rotate-half
layout; the Qwen2-VL text path's M-RoPE with three equal position
streams is exactly this), and a SwiGLU MLP, a GELU MLP (the encoder),
or a routed mixture of experts with shared experts (DeepSeekMoE).  The
weights are the nested dicts the benchmark makes (``weights.py``),
layer ``l`` of each stacked leaf at index ``l``; this file reads them
and nothing else.

Every product runs in the precision ``prec`` names:

  * ``fp32``  — float32 with TF32 off (the reference);
  * ``tf32``  — float32 products on TF32 tensor cores (the embedder's
    control: its configuration states float32);
  * ``bf16``  — bfloat16 products and attention;
  * ``fp8``   — each weight product takes both operands rounded to fp8
    e4m3 (one scale per row of activations, one per column of weights)
    and attention in bfloat16 (the control of bfloat16 configurations).

Sequences go through layer by layer, all of them together, so each
layer's weights are read once; attention runs per sequence.
``bucket_hidden`` instead runs a right-padded (rows, length) bucket as
one batch, padded positions at -1: a mixture of experts with a fixed
expert capacity drops replicas by their place in the whole bucket, so
a bucket can only be judged whole.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

NEG = -1e30        # masked score: a query with no visible key averages all
FP8_MAX = 448.0


@contextlib.contextmanager
def precision(prec: str):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    tf32 = prec == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def mm(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """x (..., k) float32 @ w (k, n) -> float32."""
    if prec == "bf16":
        return (x.bfloat16() @ w.bfloat16()).float()
    if prec == "fp8":
        return _fp8(x, -1) @ _fp8(w.float(), 0)
    return x @ w.float()


def rms(w: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, hd) rotated by positions pos (..., S), rotate-half."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = pos.float()[..., None] * inv
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attend(q, k, v, qpos, kpos, causal: bool, prec: str) -> torch.Tensor:
    """q (S,H,hd), k/v (C,K,hd), positions -1 where empty -> (S,H*hd)."""
    S, H, hd = q.shape
    K = k.shape[1]
    dt = torch.bfloat16 if prec in ("bf16", "fp8") else torch.float32
    qg = q.reshape(S, K, H // K, hd).to(dt)
    s = torch.einsum("skgh,ckh->kgsc", qg, k.to(dt)).float() / math.sqrt(hd)
    ok = (kpos[None, :] >= 0)
    if causal:
        ok = ok & (kpos[None, :] <= qpos[:, None])
    s = torch.where(ok[None, None], s, torch.tensor(NEG, device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("kgsc,ckh->skgh", p.to(dt), v.to(dt)).float()
    return o.reshape(S, H * hd)


def _layer(group: Dict, l: int) -> Dict:
    def take(t):
        if isinstance(t, dict):
            return {k: take(v) for k, v in t.items()}
        return t[l]
    return take(group)


def swiglu(x, w_gate, w_up, w_down, prec):
    return mm(F.silu(mm(x, w_gate, prec)) * mm(x, w_up, prec), w_down, prec)


def route(h: torch.Tensor, router: torch.Tensor, top_k: int):
    """Softmax routing in float32: (gates (N,k) renormalised over the
    top k, expert ids (N,k)); ties go to the lower expert id."""
    probs = torch.softmax(h @ router.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    g = vals[:, :top_k]
    return g / g.sum(-1, keepdim=True).clamp(min=1e-9), idx[:, :top_k]


def kept_replicas(idx: torch.Tensor, n_experts: int, capacity: int):
    """(N,k) bool: replica r = token * k + j keeps its slot when fewer
    than ``capacity`` earlier replicas (in that order) chose its expert."""
    eid = idx.reshape(-1)
    order = torch.sort(eid, stable=True).indices
    counts = torch.bincount(eid, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(order)
    rank[order] = torch.arange(eid.numel(), device=eid.device)
    return (rank - starts[eid] < capacity).reshape(idx.shape)


def capacity_of(moe: Dict, n_tokens: int) -> int:
    """Slots per expert for one call over ``n_tokens`` tokens: ceil to 8
    of int(capacity_factor * replicas / experts) + 1."""
    cap = int(moe["capacity_factor"] * n_tokens * moe["top_k"]
              / moe["n_experts"]) + 1
    return -(-cap // 8) * 8


def moe_ffn(h, p, moe: Dict, prec: str, capacity: Optional[int] = None,
            stats: Optional[Dict] = None):
    gates, idx = route(h, p["router"], moe["top_k"])
    if capacity is not None:
        keep = kept_replicas(idx, moe["n_experts"], capacity)
        if stats is not None:
            stats["dropped"] = stats.get("dropped", 0) + int((~keep).sum())
        gates = torch.where(keep, gates, 0.0)
    out = torch.zeros_like(h)
    for e in range(moe["n_experts"]):
        tok, j = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(h[tok], p["w_gate"][e], p["w_up"][e], p["w_down"][e],
                   prec)
        out.index_add_(0, tok, y * gates[tok, j][:, None])
    sh = p.get("shared")
    if sh is not None:
        out = out + swiglu(h, sh["w_gate"], sh["w_up"], sh["w_down"], prec)
    return out


def _block(x, blk, spec, segs, prec, capacity=None, stats=None):
    """One layer over the concatenated tokens x (N,d); ``segs`` lists
    (start, length, positions) per sequence."""
    hd = spec["head_dim"]
    H, K = spec["n_heads"], spec["n_kv_heads"]
    eps = spec["norm_eps"]
    a = blk["attn"]
    h = rms(blk["ln1"], x, eps)
    q = mm(h, a["wq"], prec).reshape(-1, H, hd)
    k = mm(h, a["wk"], prec).reshape(-1, K, hd)
    v = mm(h, a["wv"], prec).reshape(-1, K, hd)
    y = torch.empty((x.shape[0], H * hd), device=x.device)
    for s0, n, pos in segs:
        qs = rope(q[s0:s0 + n], pos, spec["rope_theta"])
        ks = rope(k[s0:s0 + n], pos, spec["rope_theta"])
        y[s0:s0 + n] = attend(qs, ks, v[s0:s0 + n], pos, pos,
                              spec["causal"], prec)
    x = x + mm(y, a["wo"], prec)
    h = rms(blk["ln2"], x, eps)
    if "moe" in blk:
        return x + moe_ffn(h, blk["moe"], spec["moe"], prec, capacity, stats)
    m = blk["mlp"]
    if spec["act"] == "gelu":
        return x + mm(F.gelu(mm(h, m["w_up"], prec), approximate="tanh"),
                      m["w_down"], prec)
    return x + swiglu(h, m["w_gate"], m["w_up"], m["w_down"], prec)


def _run(w, spec, x, segs, prec, capacity=None, stats=None):
    group = w["groups"][0]
    with precision(prec):
        for l in range(spec["n_layers"]):
            x = _block(x, _layer(group, l), spec, segs, prec, capacity, stats)
        return rms(w["ln_f"], x, spec["norm_eps"])


@torch.no_grad()
def hidden(w, spec, seqs: Sequence[Sequence[int]], prec: str = "fp32"
           ) -> List[torch.Tensor]:
    """Final normed hidden states (S_i, d) of each whole sequence."""
    dev = w["embed"].device
    toks = torch.as_tensor([t for s in seqs for t in s], device=dev)
    segs, s0 = [], 0
    for s in seqs:
        segs.append((s0, len(s), torch.arange(len(s), device=dev)))
        s0 += len(s)
    x = w["embed"][toks].float()
    h = _run(w, spec, x, segs, prec)
    return [h[a:a + n] for a, n, _ in segs]


@torch.no_grad()
def bucket_hidden(w, spec, toks: torch.Tensor, pos: torch.Tensor,
                  prec: str = "fp32", stats: Optional[Dict] = None
                  ) -> torch.Tensor:
    """Final normed hidden states (B, T, d) of a right-padded bucket
    (positions -1 at padding), run as one call: the expert capacity is
    the bucket's."""
    B, T = toks.shape
    x = w["embed"][toks.reshape(-1)].float()
    segs = [(r * T, T, pos[r]) for r in range(B)]
    cap = capacity_of(spec["moe"], B * T) if "moe" in spec else None
    return _run(w, spec, x, segs, prec, cap, stats).reshape(B, T, -1)


def logits_at(w, spec, h: torch.Tensor, rows: torch.Tensor, prec: str
              ) -> torch.Tensor:
    """Next-token logits (len(rows), V) float32 from hidden states."""
    with precision(prec):
        return mm(h[rows], w["lm_head"], prec)


def reward_of(w, h_last: torch.Tensor, prec: str) -> torch.Tensor:
    """PRM reward: sigmoid of the value head at the given states."""
    with precision(prec):
        return torch.sigmoid(mm(h_last, w["value_head"], prec)[..., 0])
