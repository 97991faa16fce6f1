"""The one traffic generator: a backlog of search problems from a mix's
parameters and the seed.

A mix file (``traffic/<name>.json``) gives

  * ``shared_header_tokens`` — a header every prompt starts with (a
    few-shot preamble; 0 for none), its tokens drawn once per seed;
  * ``problem_tokens`` — [lo, hi], the problem text's length range;
  * ``backlog`` — problems queued at time 0 (a closed loop: the server
    takes the next one when a slot frees);
  * ``max_live`` — problems in flight;
  * the search (``method``, ``width``, ``max_steps``,
    ``max_step_tokens``, ``temperature``, ``ets``) and the pool
    (``page_size``, ``pool_pages``).

Lengths are stratified: each block of ``max_live`` consecutive problems
takes the same evenly spaced lengths over [lo, hi], in an order the seed
draws.  So every seed gives every admission wave the same work, and the
seed changes only which problem gets which length and every token.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def prompts(mix: Dict, vocab: int, seed: int) -> List[List[int]]:
    rng = np.random.default_rng(int(seed))
    header = rng.integers(0, vocab, int(mix.get("shared_header_tokens", 0)))
    lo, hi = mix["problem_tokens"]
    block = int(mix["max_live"])
    base = [int(round(lo + (hi - lo) * (j + 0.5) / block))
            for j in range(block)]
    out = []
    while len(out) < int(mix["backlog"]):
        for n in rng.permutation(base):
            body = rng.integers(0, vocab, int(n))
            out.append([int(t) for t in header] + [int(t) for t in body])
    return out[:int(mix["backlog"])]


def max_prompt(mix: Dict) -> int:
    return int(mix.get("shared_header_tokens", 0)) + int(mix["problem_tokens"][1])
