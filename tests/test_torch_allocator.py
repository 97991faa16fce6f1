"""The port's allocator and tree metadata (copied host code) against
``repro``'s: the same random op sequences give identical block tables,
refcounts, copy-on-write copies and tree-attention metadata."""
import numpy as np
import pytest

from repro.kernels.tree_attention import \
    build_tree_metadata as jax_build_meta
from repro.kvcache import PageAllocator as JaxAllocator
from repro.kvcache.allocator import OutOfPages as JaxOOP

from repro_torch.kvcache import PageAllocator, build_tree_metadata
from repro_torch.kvcache.allocator import OutOfPages


def _meta_equal(a, b):
    np.testing.assert_array_equal(a.page_list, b.page_list)
    np.testing.assert_array_equal(a.page_mask, b.page_mask)
    np.testing.assert_array_equal(a.page_lens, b.page_lens)
    assert (a.n_unique, a.n_logical) == (b.n_unique, b.n_logical)


def _state(alloc):
    return ({sid: (list(h.block_table), h.length, h.ns)
             for sid, h in alloc.seqs.items()},
            dict(alloc.refcount) if isinstance(alloc.refcount, dict)
            else list(alloc.refcount),
            alloc.used_pages, alloc.logical_pages, alloc.shared_pages())


@pytest.mark.parametrize("seed", range(6))
def test_random_ops_identical_tables_and_metadata(seed):
    rng = np.random.default_rng(seed)
    n_pages, ps = int(rng.choice([24, 64])), int(rng.choice([4, 8]))
    allocs = [JaxAllocator(n_pages, ps), PageAllocator(n_pages, ps)]
    live = []
    oop_seen = False     # an op cut short by OutOfPages may leave pages
    for _ in range(60):  # half-booked (in both copies alike)
        op = rng.choice(["new", "new_seqs", "append", "branch", "free"],
                        p=[0.15, 0.1, 0.35, 0.25, 0.15])
        arg = int(rng.integers(0, 30))
        pick = int(rng.integers(0, max(len(live), 1)))
        results = []
        for a, oop in zip(allocs, (JaxOOP, OutOfPages)):
            try:
                if op == "new":
                    results.append([a.new_seq(arg).seq_id])
                elif op == "new_seqs":
                    results.append([h.seq_id for h in
                                    a.new_seqs([arg, arg // 2 + 1])])
                elif op == "append" and live:
                    results.append([(c.src_page, c.dst_page, c.n_valid)
                                    for c in a.append_tokens(live[pick],
                                                             arg % 9 + 1)])
                elif op == "branch" and live:
                    results.append([h.seq_id for h in
                                    a.branch(live[pick], arg % 3 + 1)])
                elif op == "free" and live:
                    a.free_seq(live[pick])
                    results.append(None)
                else:
                    results.append(None)
            except oop:
                results.append("oop")
        assert results[0] == results[1], (op, results)
        r = results[1]
        if op in ("new", "new_seqs", "branch") and r not in (None, "oop"):
            live.extend(r)
        elif op == "free" and live and r is None:
            live.pop(pick)
        oop_seen |= r == "oop"
        if not oop_seen:
            for a in allocs:
                a.check_invariants()
        assert _state(allocs[0]) == _state(allocs[1])
        rows = sorted(live)[:6] + [None]
        for incremental in (True, False):
            _meta_equal(allocs[0].tree_metadata(rows, pad_page=n_pages - 1,
                                                incremental=incremental),
                        allocs[1].tree_metadata(rows, pad_page=n_pages - 1,
                                                incremental=incremental))
    # the incremental path ran as often in both (not asserted > 0: a
    # sequence with no tokens never takes it)
    assert allocs[0].meta_inc_builds == allocs[1].meta_inc_builds


@pytest.mark.parametrize("case", [
    ([[3, 4], [3, 5], [3, 6, 7], [], []], [14, 12, 19, 0, 0], 8),
    ([[0, 1, 2]], [17, ], 8),
    ([[5], [5], [6]], [3, 3, 2], 4),
])
def test_build_tree_metadata_identical(case):
    tables, lengths, ps = case
    _meta_equal(jax_build_meta(tables, lengths, ps, pad_page=9, check=True),
                build_tree_metadata(tables, lengths, ps, pad_page=9,
                                    check=True))


def test_namespaces_and_page_stats_identical():
    allocs = [JaxAllocator(64, 8), PageAllocator(64, 8)]
    for a in allocs:
        hs = a.new_seqs([20, 9, 30])
        a.branch(hs[0].seq_id, 3)
        a.branch(hs[2].seq_id, 2)
        for sid in list(a.seqs)[:2]:
            a.append_tokens(sid, 5)
    for ns in {h.ns for h in allocs[0].seqs.values()}:
        assert allocs[0].ns_page_stats(ns) == allocs[1].ns_page_stats(ns)
