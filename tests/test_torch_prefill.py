"""Page-streamed long-prompt prefill on the port, against its own
one-shot prefill and against ``repro``'s streamed prefill on the CPU.

A prompt whose context is longer than ``prefill_chunk_tokens`` prefills
in segments, one engine call each: the pool K/V match the one-shot
bucket and the reference's streamed path to the reference's tolerance
(rtol = atol = 2e-5), greedy continuations are equal, and
``prefill_many`` sends only the long prompts of a batch down the
streamed path."""
import math

import jax
import numpy as np
import pytest
from _torch_stack import make_stacks

from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import PagedEngine as JaxEngine

from repro_torch.serving import EngineConfig, PagedEngine

TOL = 2e-5                      # the reference's streamed-prefill tolerance
ENGINE_KW = dict(n_pages=128, page_size=8, max_batch=8, max_seq_len=128)


@pytest.fixture(scope="module")
def stacks():
    return make_stacks(seed=4)


def _engine(stacks, **kw):
    (lm, lp), _, _ = stacks[1]
    return PagedEngine(lm, lp, EngineConfig(**ENGINE_KW, **kw), device="cpu")


def _prompts(stacks, lengths, seed=0):
    vocab = stacks[1][0][0].cfg.vocab_size
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(2, vocab, n))) for n in lengths]


def _kv(eng, sid):
    """Per-layer (K, V) of a sequence's context, as numpy."""
    h = eng.alloc.seqs[sid]
    out = []
    for l in range(eng.pool.n_layers):
        k, v = eng.pool.gather_kv(l, h.block_table, h.length)
        out.append((np.asarray(k), np.asarray(v)))
    return out


def _assert_kv_close(a, b):
    for (ka, va), (kb, vb) in zip(a, b):
        np.testing.assert_allclose(ka, kb, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(va, vb, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_tokens,chunk", [(60, 16), (41, 8), (97, 32)])
def test_streamed_matches_one_shot(stacks, n_tokens, chunk):
    prompt = _prompts(stacks, [n_tokens])[0]
    e_s = _engine(stacks, prefill_chunk_tokens=chunk, trace_logits=True)
    e_o = _engine(stacks, trace_logits=True)
    sid_s, sid_o = e_s.prefill(prompt), e_o.prefill(prompt)
    ctx = n_tokens - 1
    assert e_s.n_prefill_calls == math.ceil(ctx / chunk)
    assert e_s.n_prefill_tokens == e_o.n_prefill_tokens == ctx
    assert e_o.n_prefill_calls == 1
    _assert_kv_close(_kv(e_s, sid_s), _kv(e_o, sid_o))
    np.testing.assert_allclose(e_s.logits_trace[-1], e_o.logits_trace[-1],
                               rtol=TOL, atol=TOL)
    out_s = e_s.decode([sid_s], 8, key=5, temperature=0.0)
    out_o = e_o.decode([sid_o], 8, key=5, temperature=0.0)
    assert out_s[sid_s] == out_o[sid_o]
    e_s.alloc.check_invariants()


def test_streamed_matches_reference_streamed(stacks):
    """The port's streamed prefill against ``repro``'s, same segments:
    pool K/V and the final segment's last-token logits within 2e-5."""
    (jlm, jp), _, _ = stacks[0]
    prompt = _prompts(stacks, [75], seed=1)[0]
    kw = dict(ENGINE_KW, prefill_chunk_tokens=16, trace_logits=True)
    je = JaxEngine(jlm, jp, JaxEngineConfig(**kw))
    te = _engine(stacks, prefill_chunk_tokens=16, trace_logits=True)
    jsid, tsid = je.prefill(prompt), te.prefill(prompt)
    assert jsid == tsid
    assert je.n_prefill_calls == te.n_prefill_calls == math.ceil(74 / 16)
    _assert_kv_close(_kv(je, jsid), _kv(te, tsid))
    assert len(je.logits_trace) == len(te.logits_trace) == 1
    np.testing.assert_allclose(te.logits_trace[0], je.logits_trace[0],
                               rtol=TOL, atol=TOL)
    jout = je.decode([jsid], 6, key=jax.random.key(3), temperature=0.0)
    tout = te.decode([tsid], 6, key=3, temperature=0.0)
    assert jout == tout


def test_mixed_batch_routes_long_prompts_to_streamed(stacks):
    """``prefill_many`` streams the prompts whose context exceeds the
    chunk and buckets the rest; every sequence matches a one-shot
    engine, and sampled continuations are equal."""
    prompts = _prompts(stacks, [9, 58, 17, 40, 3], seed=2)
    e_m = _engine(stacks, prefill_chunk_tokens=24)
    e_r = _engine(stacks)
    calls = []
    orig = e_m._prefill_streamed
    e_m._prefill_streamed = lambda h, ctx: (calls.append(len(ctx)),
                                            orig(h, ctx))
    sids_m = e_m.prefill_many(prompts)
    sids_r = [e_r.prefill(p) for p in prompts]
    assert calls == [57, 39]                 # contexts above 24 tokens
    # one bucket for the short prompts, then 3 + 2 segments
    assert e_m.n_prefill_calls == 1 + 3 + 2
    for sm, sr in zip(sids_m, sids_r):
        assert e_m.alloc.seqs[sm].length == e_r.alloc.seqs[sr].length
        _assert_kv_close(_kv(e_m, sm), _kv(e_r, sr))
    out_m = e_m.decode(sids_m, 6, key=9, temperature=1.0)
    out_r = e_r.decode(sids_r, 6, key=9, temperature=1.0)
    assert [out_m[s] for s in sids_m] == [out_r[s] for s in sids_r]
    e_m.alloc.check_invariants()


def test_streamed_history_ignores_stale_page_tails(stacks):
    """History is masked by absolute position: garbage in the not yet
    written slots of the prompt's pages (a reused page) changes
    nothing."""
    prompt = _prompts(stacks, [50], seed=3)[0]
    clean = _engine(stacks, prefill_chunk_tokens=16)
    dirty = _engine(stacks, prefill_chunk_tokens=16)
    dirty.pool.k.fill_(1e3)
    dirty.pool.v.fill_(-1e3)
    sc, sd = clean.prefill(prompt), dirty.prefill(prompt)
    for (kc, vc), (kd, vd) in zip(_kv(clean, sc), _kv(dirty, sd)):
        assert np.array_equal(kc, kd) and np.array_equal(vc, vd)
