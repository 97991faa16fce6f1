"""Host-side tree-attention metadata (the unique-page operands of one
tree decode step).

``build_tree_metadata`` derives, from the live rows' block tables, the
tree's unique page list, the per-page descendant bitmap over the padded
batch and the per-page valid lengths; ``TreeMetadata`` carries them plus
the IO accounting they imply.  The allocator's incremental derivation
(``PageAllocator.tree_metadata``) is tested against this from-scratch
build.  Pure numpy: no device code.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np


def _next_pow2(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


@dataclass(frozen=True)
class TreeMetadata:
    """Host-side tree-attention operands + the IO accounting they imply.

    ``n_unique`` pages are streamed once per step by the tree kernel;
    ``n_logical`` (sum of per-row table lengths) is what per-sequence
    paged attention streams.  ``n_logical / n_unique`` is the measured
    sharing ratio the engine reports.
    """
    page_list: np.ndarray          # (N,) int32, padded with pad_page
    page_mask: np.ndarray          # (N, B) int8, padded entries all-zero
    page_lens: np.ndarray          # (N,) int32, padded entries zero
    n_unique: int                  # live unique pages (pre-padding)
    n_logical: int                 # sum of per-row block-table lengths


def build_tree_metadata(block_tables: Sequence[Sequence[int]],
                        lengths: Sequence[int],
                        page_size: int,
                        *,
                        pad_page: int = 0,
                        min_pages: int = 8,
                        n_rows: Optional[int] = None,
                        check: bool = False) -> TreeMetadata:
    """Derive tree-attention metadata from per-row block tables.

    block_tables[j] lists row j's page ids in path order (empty for an
    inactive/padded row); lengths[j] is its valid token count.  The page
    axis is padded to a power of two (>= min_pages) so jit signatures
    stay O(log max pages); padded entries point at ``pad_page`` with
    zero length and an all-zero mask column.

    With ``check=True`` the tree invariants are asserted: a physical
    page occupies the same table position (hence the same valid length)
    in every row that references it, and every (row, position) pair is
    covered by exactly one unique-page entry.
    """
    B = len(block_tables) if n_rows is None else n_rows
    assert len(block_tables) <= B and len(block_tables) == len(lengths)
    order: dict = {}               # page id -> index into the unique list
    lens: List[int] = []
    n_logical = 0
    for table, ln in zip(block_tables, lengths):
        n_logical += len(table)
        for p, pg in enumerate(table):
            valid = min(page_size, ln - p * page_size)
            assert valid > 0, (pg, p, ln, "table longer than length")
            idx = order.get(pg)
            if idx is None:
                order[pg] = len(lens)
                lens.append(valid)
            elif check:
                assert lens[idx] == valid, \
                    (pg, lens[idx], valid, "shared page, divergent fill")
    n_unique = len(order)
    N = _next_pow2(max(n_unique, 1), min_pages)
    page_list = np.full(N, pad_page, np.int32)
    page_lens = np.zeros(N, np.int32)
    page_mask = np.zeros((N, B), np.int8)
    for pg, idx in order.items():
        page_list[idx] = pg
        page_lens[idx] = lens[idx]
    for j, table in enumerate(block_tables):
        for pg in table:
            page_mask[order[pg], j] = 1
    if check:
        cover = page_mask[:n_unique].sum(axis=0)
        for j, table in enumerate(block_tables):
            assert cover[j] == len(table), (j, cover[j], len(table))
    return TreeMetadata(page_list, page_mask, page_lens,
                        n_unique, n_logical)
