"""The port's paged engine against ``repro``'s ``PagedEngine`` on the
CPU: the same prompts through ``prefill_many``, ``branch`` and greedy or
sampled ``decode`` give the same tokens, float32-allclose logits and the
same unique/logical page counters, in both attention modes."""
import jax
import numpy as np
import pytest
import torch
from _torch_stack import make_stacks

from repro.kvcache import KVPool as JaxKVPool
from repro.kvcache.allocator import CopyOp as JaxCopyOp
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import PagedEngine as JaxEngine

from repro_torch.kvcache import KVPool
from repro_torch.kvcache.allocator import CopyOp
from repro_torch.serving import EngineConfig, PagedEngine

LOGIT_TOL = 1e-4     # float32 logits; the two packages sum in other orders


@pytest.fixture(scope="module")
def stacks():
    return make_stacks(seed=5)


def _engines(stacks, mode, **kw):
    (jlm, jp), _, _ = stacks[0]
    (tlm, tp), _, _ = stacks[1]
    ekw = dict(n_pages=96, page_size=8, max_batch=8, max_seq_len=96,
               attention=mode, trace_logits=True, **kw)
    return (JaxEngine(jlm, jp, JaxEngineConfig(**ekw)),
            PagedEngine(tlm, tp, EngineConfig(**ekw), device="cpu"))


def _prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(2, vocab, n))) for n in lengths]


def _assert_same_state(je, te):
    assert je.tokens == te.tokens
    assert je.kv_stats() == te.kv_stats()
    assert je.unique_pages_streamed_by_ns == te.unique_pages_streamed_by_ns
    assert je.logical_pages_streamed_by_ns == te.logical_pages_streamed_by_ns
    assert (je.n_decode_steps, je.n_decoded_tokens, je.n_prefill_tokens) \
        == (te.n_decode_steps, te.n_decoded_tokens, te.n_prefill_tokens)
    assert len(je.logits_trace) == len(te.logits_trace)
    for a, b in zip(je.logits_trace, te.logits_trace):
        np.testing.assert_allclose(b, a, rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("mode", ["paged", "tree"])
def test_prefill_branch_decode_match_reference(stacks, mode):
    je, te = _engines(stacks, mode)
    vocab = je.cfg.vocab_size
    prompts = _prompts(vocab, [13, 5, 21])
    jsid, tsid = je.prefill_many(prompts), te.prefill_many(prompts)
    assert jsid == tsid
    kids = {}
    for e in (je, te):
        kids[id(e)] = (e.branch(tsid[0], 3) + e.branch(tsid[2], 2)
                       + [tsid[1]])
    ids = kids[id(te)]
    assert kids[id(je)] == ids
    jout = je.decode(ids, 7, key=jax.random.key(0), temperature=0.0)
    tout = te.decode(ids, 7, key=0, temperature=0.0)
    assert jout == tout
    # prune some branches, branch again mid-page (CoW), decode again
    for e in (je, te):
        e.free(ids[1])
        e.free(ids[4])
    more = [je.branch(ids[0], 2), te.branch(ids[0], 2)]
    assert more[0] == more[1]
    ids2 = [ids[0], ids[2], ids[3], ids[5]] + more[1]
    jout = je.decode(ids2, 9, key=jax.random.key(1), temperature=0.0,
                     stop_tokens=(3,))
    tout = te.decode(ids2, 9, key=1, temperature=0.0, stop_tokens=(3,))
    assert jout == tout
    _assert_same_state(je, te)
    if mode == "tree":
        assert te.unique_pages_streamed < te.logical_pages_streamed
    else:
        assert te.unique_pages_streamed == te.logical_pages_streamed
    for e in (je, te):
        for sid in list(e.alloc.seqs):
            e.free(sid)
        e.alloc.check_invariants()
        assert e.alloc.used_pages == 0


@pytest.mark.parametrize("mode", ["paged", "tree"])
def test_sampled_decode_matches_reference(stacks, mode):
    """Sampled decode (temperature 1.0) gives the reference's streams:
    ``decode(key=k)`` and a refilled ``DecodeStream`` whose rows join at
    different iterations with their own threefry keys."""
    je, te = _engines(stacks, mode)
    prompts = _prompts(je.cfg.vocab_size, [13, 5, 21], seed=3)
    sids = je.prefill_many(prompts)
    assert te.prefill_many(prompts) == sids
    kids = [e.branch(sids[0], 3) + e.branch(sids[2], 2) for e in (je, te)]
    assert kids[0] == kids[1]
    ids = kids[1]
    jout = je.decode(ids, 8, key=jax.random.key(4), temperature=1.0)
    assert jout == te.decode(ids, 8, key=4, temperature=1.0)
    assert len({tuple(t) for t in jout.values()}) > 1
    keys = jax.random.split(jax.random.key(9), 2)
    outs = []
    for e, k in ((je, keys), (te, np.asarray(jax.random.key_data(keys)))):
        a, b = e.branch(ids[0], 1)[0], e.branch(sids[1], 1)[0]
        stream = e.open_stream(temperature=1.0, stop_tokens=(3,))
        stream.add([a], k[:1], 6)
        stream.step()
        stream.add([b], k[1:], 6)
        while stream.live:
            stream.step()
        outs.append(stream.out)
    assert outs[0] == outs[1]
    _assert_same_state(je, te)


def test_paged_and_tree_modes_agree(stacks):
    """The two attention modes agree on logits and greedy tokens."""
    _, pe = _engines(stacks, "paged")
    _, tr = _engines(stacks, "tree")
    prompts = _prompts(pe.cfg.vocab_size, [17, 9], seed=1)
    outs = []
    for e in (pe, tr):
        sids = e.prefill_many(prompts)
        ids = e.branch(sids[0], 3) + e.branch(sids[1], 2)
        outs.append(e.decode(ids, 10, key=0, temperature=0.0))
    assert outs[0] == outs[1]
    for a, b in zip(pe.logits_trace, tr.logits_trace):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_single_token_prompts_and_chunked_prefill(stacks):
    """Single-token prompts write nothing at prefill; batches beyond
    max_batch prefill in chunks; both match the reference."""
    je, te = _engines(stacks, "paged", )
    prompts = _prompts(je.cfg.vocab_size, [1, 4, 1, 6, 3, 2, 9, 1, 5, 7])
    assert len(prompts) > je.ecfg.max_batch
    assert je.prefill_many(prompts) == te.prefill_many(prompts)
    assert te.n_prefill_calls == je.n_prefill_calls == 2
    ids = list(te.alloc.seqs)[:8]
    assert je.decode(ids, 3, key=jax.random.key(0), temperature=0.0) \
        == te.decode(ids, 3, key=0, temperature=0.0)
    _assert_same_state(je, te)


def test_engine_config_validation():
    with pytest.raises(ValueError, match="attention"):
        EngineConfig(attention="dense")
    with pytest.raises(ValueError, match="page_size"):
        EngineConfig(page_size=16, prefill_chunk_tokens=8)


def test_decode_stream_refill_keeps_rows_independent(stacks):
    """Seating a row mid-stream does not change the other rows' greedy
    streams (per-row attention, row-keyed sampling)."""
    _, te = _engines(stacks, "tree")
    sids = te.prefill_many(_prompts(te.cfg.vocab_size, [11, 6]))
    a, b = te.branch(sids[0], 1)[0], te.branch(sids[1], 1)[0]
    solo = te.decode([a], 6, key=0, temperature=0.0)[a]
    c = te.branch(sids[0], 1)[0]
    stream = te.open_stream(temperature=0.0)
    stream.add([c], [(0, 0)], 6)
    stream.step()
    stream.add([b], [(0, 1)], 6)
    while stream.live:
        stream.step()
    assert stream.out[c] == solo


def test_kv_pool_writes_and_cow_copies_match_reference():
    """``write_tokens`` then ``copy_pages`` leave both pools equal (the
    port writes in place, the reference functionally)."""
    rng = np.random.default_rng(2)
    shape = (2, 8, 4, 2, 8)                  # L, P, S, K, hd
    jp, tp = JaxKVPool(*shape), KVPool(*shape, device="cpu")
    new_k = rng.normal(size=(2, 5, 2, 8)).astype(np.float32)
    new_v = rng.normal(size=(2, 5, 2, 8)).astype(np.float32)
    pages = np.array([1, 1, 3, 6, 6], np.int32)
    slots = np.array([0, 3, 2, 1, 2], np.int32)
    jp.write_tokens(new_k, new_v, pages, slots)
    tp.write_tokens(*(torch.as_tensor(a) for a in (new_k, new_v)),
                    torch.as_tensor(pages).long(),
                    torch.as_tensor(slots).long())
    jp.copy_pages([JaxCopyOp(1, 2, 4), JaxCopyOp(6, 0, 3)])
    tp.copy_pages([CopyOp(1, 2, 4), CopyOp(6, 0, 3)])
    np.testing.assert_array_equal(tp.k.numpy(), np.asarray(jp.k))
    np.testing.assert_array_equal(tp.v.numpy(), np.asarray(jp.v))
