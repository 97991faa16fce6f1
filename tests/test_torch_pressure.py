"""Memory pressure on the port: the swap transport of ``PagedEngine``
and pressured sweeps, against ``repro`` on the CPU.

  * ``swap_out`` / ``swap_in`` round-trip a problem's pages bitwise
    after other problems overwrote the freed pages, also across two
    partial (subtree) waves, and drop the spill of a namespace freed
    while parked;
  * sampled decode (port threefry row keys) resumes bitwise after swap;
  * a sweep on a pool too small for it (the reference's 40-page recipe)
    finishes in both attention modes and both spill modes: it gives the
    reference's pressured trees (tokens exact, rewards to rtol 1e-5)
    and the port's own roomy trees (tokens exact, rewards to rtol 1e-5;
    the reference's PRM rewards move by ~1e-6 with batch composition),
    with every demoted page restored.
"""
import numpy as np
import pytest
import torch
from _torch_stack import make_stacks

from repro.core import ETSConfig as JaxETSConfig
from repro.core import SearchConfig as JaxSearchConfig
from repro.core import SweepScheduler as JaxSweepScheduler
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import PagedEngine as JaxEngine
from repro.serving.search_backend import BackendConfig as JaxBackendConfig
from repro.serving.search_backend import LMBackend as JaxBackend
from repro.training.task import EOS, NEWLINE

from repro_torch.core import ETSConfig, SearchConfig, SweepScheduler
from repro_torch.serving import (BackendConfig, EngineConfig, LMBackend,
                                 PagedEngine)
from repro_torch.serving.sampler import key, split

ENGINE_KW = dict(page_size=8, max_batch=16, max_seq_len=128)
BACKEND_KW = dict(step_token=NEWLINE, eos_token=EOS, max_step_tokens=6,
                  max_depth=4)
ETS_KW = dict(lambda_b=1.0, lambda_d=1.0, cluster_threshold=0.2)
TIGHT_POOL = 40
ROOMY_POOL = 256


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(2, NEWLINE, n))) for n in lengths]


PROMPTS = _prompts((17, 23, 9, 30))


@pytest.fixture(scope="module")
def stacks():
    return make_stacks(seed=0)


def _engine(stacks, n_pages=ROOMY_POOL, attention="tree"):
    (lm, lp), _, _ = stacks[1]
    return PagedEngine(lm, lp, EngineConfig(n_pages=n_pages,
                                            attention=attention,
                                            **ENGINE_KW), device="cpu")


def _pool_kv(eng, sid):
    h = eng.alloc.seqs[sid]
    return [tuple(t.clone() for t in eng.pool.gather_kv(l, h.block_table,
                                                        h.length))
            for l in range(eng.pool.n_layers)]


def _assert_kv_equal(a, b):
    for (k0, v0), (k1, v1) in zip(a, b):
        assert torch.equal(k0, k1) and torch.equal(v0, v1)


# ---------------------------------------------------------------------------
# Engine: the spill round trip
# ---------------------------------------------------------------------------

def test_swap_roundtrip_bitwise_after_pages_overwritten(stacks):
    eng = _engine(stacks)
    sid = eng.prefill(PROMPTS[3])
    b1, b2 = eng.branch(sid, 2)
    eng.decode([b1, b2], 4, row_keys=split(key(7), 2), temperature=1.0)
    snap = {s: _pool_kv(eng, s) for s in (sid, b1, b2)}
    used = eng.alloc.used_pages
    spilled = eng.swap_out([sid, b1, b2])
    assert spilled == used > 0
    assert eng.alloc.used_pages == 0          # every page released
    # another problem prefills over exactly the freed pages
    (stale, _), = eng._spill[eng.alloc.seqs[sid].ns]
    filler = eng.prefill(_prompts((8 * spilled,), seed=1)[0])
    assert sorted(eng.alloc.seqs[filler].block_table) == sorted(stale)
    restored = eng.swap_in([sid, b1, b2])
    assert restored == spilled == eng.swapped_out_pages \
        == eng.swapped_in_pages
    assert eng.n_swap_outs == eng.n_swap_ins == 1
    for s in (sid, b1, b2):
        _assert_kv_equal(snap[s], _pool_kv(eng, s))
    assert eng._spill == {} and eng._pending_spills == []
    eng.free(filler)
    eng.alloc.check_invariants()


def _decode_around_swap(stacks, with_swap, waves=None):
    """Prefill, branch 3, decode 4 sampled tokens, optionally swap
    (whole namespace, or ``waves`` partial subsets) with the pool dirtied
    in between, then decode 4 more."""
    eng = _engine(stacks)
    sid = eng.prefill(PROMPTS[0])
    bids = eng.branch(sid, 3)
    out1 = eng.decode(bids, 4, row_keys=split(key(11), 3), temperature=1.0)
    if with_swap:
        if waves is None:
            eng.swap_out([sid] + bids)
        else:
            for wave in waves:
                eng.swap_out([bids[i] for i in wave], partial=True)
            ns = eng.alloc.seqs[sid].ns
            assert len(eng._spill[ns]) == len(waves)
        filler = eng.prefill(_prompts((60,), seed=2)[0])   # dirty the pool
        eng.free(filler)
        swapped = [s for s in [sid] + bids if eng.alloc.seqs[s].swapped]
        assert eng.swap_in(swapped) == eng.swapped_out_pages > 0
        assert eng._spill == {} and eng._pending_spills == []
    out2 = eng.decode(bids, 4, row_keys=split(key(12), 3), temperature=1.0)
    eng.alloc.check_invariants()
    return [out1[b] for b in bids] + [out2[b] for b in bids]


def test_sampled_decode_resumes_bitwise_after_swap(stacks):
    base = _decode_around_swap(stacks, with_swap=False)
    assert base == _decode_around_swap(stacks, with_swap=True)
    # the sampled streams are not all one stream
    assert len({tuple(t) for t in base[:3]}) > 1


def test_partial_spill_in_two_waves(stacks):
    """Two partial demotions of one problem leave two spill segments;
    swap-in restores both and decode resumes bitwise."""
    assert _decode_around_swap(stacks, with_swap=False) == \
        _decode_around_swap(stacks, with_swap=True, waves=[[0], [1]])


def test_free_while_swapped_drops_spill(stacks):
    eng = _engine(stacks)
    sid = eng.prefill(PROMPTS[3])
    ns = eng.alloc.seqs[sid].ns
    eng.swap_out([sid])
    assert ns in eng._spill and eng._pending_spills
    eng.free(sid)                       # abandoned while parked
    assert ns not in eng._spill and eng._pending_spills == []
    assert eng.alloc.swapped_pages == 0 and eng.alloc.used_pages == 0
    eng.alloc.check_invariants()


def test_gather_pages_resolves_after_source_pages_reused(stacks):
    """The gather is a snapshot: writing the source pages after
    ``gather_pages_async`` does not change what ``resolve`` returns."""
    eng = _engine(stacks)
    sid = eng.prefill(PROMPTS[1])
    pages = list(eng.alloc.seqs[sid].block_table)
    want = (eng.pool.k[:, pages].numpy().copy(),
            eng.pool.v[:, pages].numpy().copy())
    pending = eng.pool.gather_pages_async(pages)
    eng.pool.k[:, pages] = -1.0
    eng.pool.v[:, pages] = -1.0
    assert pending.pending
    got = pending.resolve()
    assert not pending.pending and pending.resolve() is got
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    # and scatter_pages writes them back where asked
    eng.pool.scatter_pages(pages[::-1], got[0][:, ::-1], got[1][:, ::-1])
    assert np.array_equal(eng.pool.k[:, pages].numpy(), want[0])
    assert np.array_equal(eng.pool.v[:, pages].numpy(), want[1])


# ---------------------------------------------------------------------------
# The sweep under pressure
# ---------------------------------------------------------------------------

def _jax_sweep(stacks, attention, spill, n_pages):
    (lm, lp), (prm, pp), (emb, ep) = stacks[0]
    engine = JaxEngine(lm, lp, JaxEngineConfig(
        n_pages=n_pages, attention=attention, **ENGINE_KW))
    backend = JaxBackend(engine, prm, pp, emb, ep,
                         JaxBackendConfig(temperature=1.0, **BACKEND_KW),
                         answer_fn=lambda full: None, seed=13)
    scfg = JaxSearchConfig(method="ets", width=5, max_steps=3,
                           ets=JaxETSConfig(**ETS_KW))
    sched = JaxSweepScheduler(backend, scfg, prompts=PROMPTS, spill=spill)
    return sched.run(), sched, engine


def _torch_sweep(stacks, attention, spill, n_pages):
    (lm, lp), (prm, pp), (emb, ep) = stacks[1]
    engine = PagedEngine(lm, lp, EngineConfig(
        n_pages=n_pages, attention=attention, **ENGINE_KW), device="cpu")
    backend = LMBackend(engine, prm, pp, emb, ep,
                        BackendConfig(temperature=1.0, **BACKEND_KW),
                        answer_fn=lambda full: None, seed=13, device="cpu")
    scfg = SearchConfig(method="ets", width=5, max_steps=3,
                        ets=ETSConfig(**ETS_KW))
    sched = SweepScheduler(backend, scfg, prompts=PROMPTS, spill=spill)
    return sched.run(), sched, engine


def _tree_view(res):
    return [(n.id, n.parent, n.n_tokens, n.finished,
             (n.payload or {}).get("tokens")) for n in res.tree.nodes]


def _assert_same_trees(ref, got):
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        assert _tree_view(a) == _tree_view(b)
        np.testing.assert_allclose([n.reward for n in b.tree.nodes],
                                   [n.reward for n in a.tree.nodes],
                                   rtol=1e-5, atol=0)
        assert a.steps == b.steps and a.answer == b.answer


def _assert_drained(engine, sched):
    assert sched.stats.demotions > 0
    assert sched.stats.resumes == sched.stats.demotions
    assert engine.swapped_out_pages == engine.swapped_in_pages > 0
    assert engine.n_swap_outs == engine.n_swap_ins == sched.stats.demotions
    assert engine.alloc.swapped_pages == 0 and not engine.alloc.swapped
    assert engine._spill == {} and engine._pending_spills == []
    assert engine.alloc.used_pages == 0
    engine.alloc.check_invariants()


@pytest.fixture(scope="module")
def roomy(stacks):
    """The port's unpressured sweep per attention mode."""
    out = {}
    for attention in ("paged", "tree"):
        res, sched, engine = _torch_sweep(stacks, attention, "namespace",
                                          ROOMY_POOL)
        assert sched.stats.demotions == 0
        assert engine.swapped_out_pages == 0
        out[attention] = res
    return out


@pytest.mark.parametrize("spill", ["namespace", "subtree"])
@pytest.mark.parametrize("attention", ["paged", "tree"])
def test_pressured_sweep_matches_reference_and_roomy(stacks, roomy,
                                                     attention, spill):
    ref, jsched, jengine = _jax_sweep(stacks, attention, spill, TIGHT_POOL)
    got, sched, engine = _torch_sweep(stacks, attention, spill, TIGHT_POOL)
    _assert_same_trees(ref, got)
    _assert_same_trees(roomy[attention], got)
    _assert_drained(engine, sched)
    # the same schedule as the reference's
    assert (sched.stats.demotions, sched.stats.admission_waves) == \
        (jsched.stats.demotions, jsched.stats.admission_waves)
    assert (engine.swapped_out_pages, engine.n_swap_outs) == \
        (jengine.swapped_out_pages, jengine.n_swap_outs)
    assert sched.stats.max_reserved_pages <= TIGHT_POOL - 1
    # the sampled branches are not all one stream
    kids = {tuple((n.payload or {}).get("tokens") or ())
            for r in got for n in r.tree.nodes[1:]}
    assert len(kids) > 1
