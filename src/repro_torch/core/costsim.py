"""Analytic memory-operation cost model for tree search (paper §3, Fig. 2).

Generative decode is memory-bandwidth-bound, so step latency ~ bytes moved:

    bytes/step = model-weight loads + KV loads

Model weights are amortized across sequences decoded in the same batched
step — but only up to the device's KV memory capacity: if the live
sequences' KV state exceeds capacity, the step fragments into several
successive batches and the weights are re-loaded per fragment (paper §3,
factor 2), and prefix segments that were evicted must be recomputed
(factor 3).

Two attention-load models:
  * ``tree_attention=True``  — unique tree tokens loaded once per step
    (DeFT-style kernel / our Pallas tree kernel).
  * ``tree_attention=False`` — every sequence loads its full path
    (contiguous per-sequence caches).

The simulator consumes a ``SearchTree.kv_trace`` (per-step leaf/node/token
counts recorded by the controller), so any search method run through
``run_search`` can be costed after the fact.  This is what benchmarks/
fig2_proxy_metrics.py uses to reproduce the paper's "FLOPs and model calls
are flat, runtime is not" observation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence


@dataclass
class HardwareModel:
    # Defaults model the paper's profiling setup (H100 NVL, one GPU for
    # the search LM).  TPU v5e serving would use hbm=16e9/bw=819e9 and a
    # model sharded so that capacity stays positive.
    hbm_bytes: float = 94e9              # per-device HBM
    hbm_bw: float = 3350e9               # bytes/s (H100 NVL)
    model_bytes: float = 2 * 7e9         # bf16 weights
    kv_bytes_per_token: float = 2 * 32 * 2 * 8 * 128   # 2*L*2*K*hd bytes
    capacity_frac: float = 0.8           # fraction of HBM usable for KV
    # weights are loaded once per *batched* step and amortized over the
    # problems served together (the paper profiles with 8 threads)
    weight_amortize: int = 8

    def __post_init__(self):
        assert self.capacity_frac * self.hbm_bytes > self.model_bytes, \
            "model alone exceeds usable HBM — shard it or raise hbm_bytes"


@dataclass
class CostBreakdown:
    total_bytes: float
    weight_bytes: float
    kv_bytes: float
    recompute_bytes: float
    est_seconds: float
    fragments_per_step: float


def simulate_search_cost(kv_trace: Sequence[Dict[str, float]],
                         hw: HardwareModel,
                         tree_attention: bool = True,
                         tokens_per_step: float = 40.0) -> CostBreakdown:
    """Bytes moved across the whole recorded search."""
    weight_b = kv_b = recompute_b = 0.0
    frags = []
    kv_capacity = hw.capacity_frac * hw.hbm_bytes - hw.model_bytes
    for step in kv_trace:
        shared_tokens = step["kv_tokens_shared"]
        unshared_tokens = step["kv_tokens_unshared"]
        resident_tokens = shared_tokens if tree_attention else unshared_tokens
        resident_bytes = resident_tokens * hw.kv_bytes_per_token

        # fragmentation: if the live KV state exceeds capacity the step is
        # split and weights re-load per fragment; evicted prefixes recompute.
        n_frag = max(1, int(-(-resident_bytes // max(kv_capacity, 1.0))))
        frags.append(n_frag)
        # each decoded token re-reads the KV state of its path; the search
        # step decodes ~tokens_per_step tokens per live leaf.
        per_tok_kv = (shared_tokens if tree_attention else unshared_tokens)
        kv_b += tokens_per_step * per_tok_kv * hw.kv_bytes_per_token
        weight_b += tokens_per_step * n_frag * hw.model_bytes \
            / max(hw.weight_amortize, 1)
        if n_frag > 1:
            # evicted fraction must be re-prefetched/recomputed once
            excess = max(resident_bytes - kv_capacity, 0.0)
            recompute_b += excess
    total = weight_b + kv_b + recompute_b
    return CostBreakdown(
        total_bytes=total,
        weight_bytes=weight_b,
        kv_bytes=kv_b,
        recompute_bytes=recompute_b,
        est_seconds=total / hw.hbm_bw,
        fragments_per_step=sum(frags) / max(len(frags), 1),
    )
