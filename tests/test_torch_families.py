"""The model families through the port's paged engine, against the
reference engine on the CPU (the port's mirror of
``tests/test_family_runtimes.py``).

For the tiny variants of mixtral-8x7b and deepseek-moe-16b (MoE),
mamba2-370m and rwkv6-7b (SSM) and zamba2-7b (hybrid), on the same
numpy-seeded params:

  * one-shot prefill logits and greedy decode equal the reference's,
    in both attention modes (paged only for the attention-free SSMs);
  * a streamed prefill (recurrent state carried across segments, KV
    history re-attended) equals the reference's streamed prefill;
  * a full greedy ETS search gives the reference's tree and tokens in
    both modes, PRM rewards within rtol 1e-5;
  * state pages: copy-on-branch, all-or-nothing admission across both
    pools, bit-identical swap round trips, partial spills and freeing
    while parked.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_stack import family_models, numpy_params

from repro.configs import get_config as jax_get_config
from repro.core import ETSConfig as JaxETSConfig
from repro.core import SearchConfig as JaxSearchConfig
from repro.core import run_search as jax_run_search
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import PagedEngine as JaxEngine
from repro.serving.search_backend import BackendConfig as JaxBackendConfig
from repro.serving.search_backend import LMBackend as JaxBackend

from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core import ETSConfig, SearchConfig, run_search
from repro_torch.kvcache.allocator import OutOfPages
from repro_torch.models.model import build_model
from repro_torch.serving import (BackendConfig, EngineConfig, LMBackend,
                                 PagedEngine)

FAMILIES = ["mixtral-8x7b", "deepseek-moe-16b", "mamba2-370m", "rwkv6-7b",
            "zamba2-7b"]
RECURRENT = ["mamba2-370m", "rwkv6-7b", "zamba2-7b"]
ENGINE_KW = dict(n_pages=128, page_size=8, max_batch=16, max_seq_len=64)
PROMPTS = [[3, 5, 7, 2, 9], [4, 4, 1], list(range(10, 39))]


@pytest.fixture(scope="module")
def models():
    """arch -> ((jax lm, params), (torch lm, params)), built lazily."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = family_models(arch, seed=0)
        return cache[arch]
    return get


def _modes(arch):
    return ["paged"] if get_config(arch).arch_type == "ssm" \
        else ["paged", "tree"]


def _engines(models, arch, mode="paged", **over):
    (jm, jp), (tm, tp) = models(arch)
    kw = dict(ENGINE_KW, attention=mode, **over)
    return (JaxEngine(jm, jp, JaxEngineConfig(**kw)),
            PagedEngine(tm, tp, EngineConfig(**kw), device="cpu"))


# ---------------------------------------------------------------------------
# prefill and greedy decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_greedy_decode_match_reference(models, arch):
    for mode in _modes(arch):
        je, te = _engines(models, arch, mode, trace_logits=True)
        js, ts = je.prefill_many(PROMPTS), te.prefill_many(PROMPTS)
        np.testing.assert_allclose(te.logits_trace[0], je.logits_trace[0],
                                   rtol=2e-4, atol=2e-4)
        jo = je.decode(js, 8, jax.random.key(1), temperature=0.0)
        to = te.decode(ts, 8, key=1, temperature=0.0)
        assert [jo[s] for s in js] == [to[s] for s in ts], mode
        for a, b in zip(je.logits_trace[1:], te.logits_trace[1:]):
            np.testing.assert_allclose(b, a, rtol=2e-4, atol=2e-4)
        te.alloc.check_invariants()


@pytest.mark.parametrize("arch", FAMILIES)
def test_streamed_prefill_matches_reference(models, arch):
    """Chunked prefill: recurrent state continues from the state page on
    each segment, KV history is gathered back from the pool."""
    prompt = list(map(int, np.random.default_rng(3).integers(1, 500, 40)))
    je, te = _engines(models, arch, prefill_chunk_tokens=16)
    js, ts = je.prefill(prompt), te.prefill(prompt)
    assert te.n_prefill_calls == 3
    # the port's streamed state equals its one-shot state
    _, one = _engines(models, arch)
    so = one.prefill(prompt)
    if te.state is not None:
        for n, a in te.state.arrays.items():
            np.testing.assert_allclose(
                a[:, te.state_of[ts]].numpy(),
                one.state.arrays[n][:, one.state_of[so]].numpy(),
                rtol=1e-5, atol=1e-5)
    jo = je.decode([js], 6, jax.random.key(2), temperature=0.0)
    to = te.decode([ts], 6, key=2, temperature=0.0)
    assert jo[js] == to[ts]
    assert one.decode([so], 6, key=2, temperature=0.0)[so] == to[ts]


# ---------------------------------------------------------------------------
# full ETS search
# ---------------------------------------------------------------------------

def _prm_emb(vocab):
    """(jax, torch) tiny dense PRM and embedder at ``vocab``."""
    out = ([], [])
    for i, (name, vh) in enumerate([("tiny-lm", True),
                                    ("tiny-embedder", False)]):
        over = dict(n_layers=1, d_model=64, n_heads=2, n_kv_heads=2,
                    d_ff=128, vocab_size=vocab)
        jcfg = dataclasses.replace(jax_get_config(name), **over)
        tcfg = dataclasses.replace(get_config(name), **over)
        jm = jax_build_model(jcfg, with_value_head=vh, remat=False)
        tm = build_model(tcfg, with_value_head=vh, device="cpu")
        npp = numpy_params(jm, 11 + i)
        out[0].append((jm, jax.tree.map(jnp.asarray, npp)))
        out[1].append((tm, params_from_jax(npp, tcfg, "cpu")))
    return out


BACKEND_KW = dict(step_token=2, eos_token=3, max_step_tokens=6, max_depth=3,
                  temperature=0.0)
SEARCH_KW = dict(method="ets", width=4, max_steps=3)
ETS_KW = dict(lambda_b=1.0, lambda_d=1.0, cluster_threshold=0.2)
SEARCH_PROMPT = list(range(4, 21))


def _tree_view(res):
    return [(n.parent, n.depth, n.n_tokens, n.finished,
             (n.payload or {}).get("tokens")) for n in res.tree.nodes]


@pytest.fixture(scope="module")
def reference_search(models):
    """arch -> the reference's greedy ETS result (paged mode; the
    reference's two modes give the same greedy trees)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            (jm, jp), _ = models(arch)
            (prm, emb), _ = _prm_emb(jm.cfg.vocab_size)
            engine = JaxEngine(jm, jp, JaxEngineConfig(**ENGINE_KW))
            backend = JaxBackend(engine, *prm, *emb,
                                 JaxBackendConfig(**BACKEND_KW),
                                 answer_fn=lambda full: None, seed=13)
            cache[arch] = jax_run_search(backend, JaxSearchConfig(
                ets=JaxETSConfig(**ETS_KW), **SEARCH_KW),
                tree=backend.start(SEARCH_PROMPT))
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", FAMILIES)
def test_ets_search_matches_reference(models, reference_search, arch):
    ref = reference_search(arch)
    (_, _), (tm, tp) = models(arch)
    _, (prm, emb) = _prm_emb(tm.cfg.vocab_size)
    for mode in _modes(arch):
        engine = PagedEngine(tm, tp, EngineConfig(attention=mode,
                                                  **ENGINE_KW), device="cpu")
        backend = LMBackend(engine, *prm, *emb, BackendConfig(**BACKEND_KW),
                            answer_fn=lambda full: None, seed=13,
                            device="cpu")
        got = run_search(backend, SearchConfig(ets=ETSConfig(**ETS_KW),
                                               **SEARCH_KW),
                         tree=backend.start(SEARCH_PROMPT))
        assert len(got.tree.nodes) > 1 and got.steps == ref.steps
        assert _tree_view(got) == _tree_view(ref), mode
        np.testing.assert_allclose([n.reward for n in got.tree.nodes],
                                   [n.reward for n in ref.tree.nodes],
                                   rtol=1e-5, atol=0)
        assert got.kv_summary["logical_pages_streamed"] \
            == ref.kv_summary["logical_pages_streamed"]
        engine.alloc.check_invariants()
        if engine.state is not None:
            assert engine.state.used_pages == 0 and not engine.state_of


# ---------------------------------------------------------------------------
# state pages
# ---------------------------------------------------------------------------

def _state_of(engine, sid):
    pg = engine.state_of[sid]
    return {n: a[:, pg].clone() for n, a in engine.state.arrays.items()}


def _equal(a, b):
    return all(torch.equal(a[n], b[n]) for n in a)


@pytest.mark.parametrize("arch", RECURRENT)
def test_state_copy_on_branch(models, arch):
    _, te = _engines(models, arch)
    free0 = te.state.n_free
    sid = te.prefill(list(range(1, 20)))
    assert te.state.n_free == free0 - 1
    parent = _state_of(te, sid)
    b1, b2 = te.branch(sid, 2)
    # one fresh page per branch, each a copy of the parent's
    assert te.state.n_free == free0 - 3
    assert len({te.state_of[s] for s in (sid, b1, b2)}) == 3
    assert _equal(_state_of(te, b1), parent)
    assert _equal(_state_of(te, b2), parent)
    out = te.decode([b1, b2], 6, key=0, temperature=0.0)
    assert out[b1] == out[b2]
    assert _equal(_state_of(te, sid), parent)       # parent untouched
    for s in (sid, b1, b2):
        te.free(s)
    assert te.state.n_free == free0 and te.state.used_pages == 0


@pytest.mark.parametrize("arch", RECURRENT)
def test_both_pool_exhaustion_is_all_or_nothing(models, arch):
    # state pool full: the refused branch / prefill takes no KV page
    _, te = _engines(models, arch, n_state_pages=3)     # 2 live + dump
    sid = te.prefill(list(range(1, 10)))
    used = te.alloc.used_pages
    with pytest.raises(OutOfPages, match="state pool exhausted"):
        te.branch(sid, 2)
    with pytest.raises(OutOfPages, match="state pool exhausted"):
        te.prefill_many([[1, 2, 3], [4, 5, 6]])
    assert te.state.n_free == 1 and te.alloc.used_pages == used
    assert set(te.alloc.seqs) == {sid} and set(te.state_of) == {sid}
    te.alloc.check_invariants()
    # KV pool full: the refused prefill takes no state page
    _, te = _engines(models, arch, n_pages=4)           # 3 pages + dump
    te.prefill(list(range(1, 20)))                      # 3 pages
    free = te.state.n_free
    with pytest.raises(OutOfPages):
        te.prefill(list(range(1, 20)))
    assert te.state.n_free == free and len(te.state_of) == 1
    te.alloc.check_invariants()


@pytest.mark.parametrize("arch", RECURRENT)
def test_state_swap_roundtrip_bit_identical(models, arch):
    """Demote and restore with both pools dirtied in between: the state
    and KV pages come back bitwise, and sampled decode resumes as on an
    engine that never swapped."""
    prompt = list(range(1, 20))

    def run(with_swap):
        _, te = _engines(models, arch)
        sid = te.prefill(prompt)
        b1, b2 = te.branch(sid, 2)
        out1 = te.decode([b1, b2], 4, key=11, temperature=1.0)
        if with_swap:
            ids = [sid, b1, b2]
            states = [_state_of(te, s) for s in ids]
            kv = [[t.clone() for l in range(te.pool.n_layers)
                   for t in te.pool.gather_kv(l, te.alloc.seqs[s].block_table,
                                              te.alloc.seqs[s].length)]
                  for s in ids]
            te.swap_out(ids)
            assert all(s not in te.state_of for s in ids)
            filler = te.prefill(list(range(25, 60)))    # dirty both pools
            te.decode([filler], 2, key=0, temperature=0.0)
            te.free(filler)
            te.swap_in(ids)
            assert all(_equal(_state_of(te, s), st)
                       for s, st in zip(ids, states))
            kv2 = [[t for l in range(te.pool.n_layers)
                    for t in te.pool.gather_kv(l, te.alloc.seqs[s].block_table,
                                               te.alloc.seqs[s].length)]
                   for s in ids]
            assert all(torch.equal(a, b) for x, y in zip(kv, kv2)
                       for a, b in zip(x, y))
        out2 = te.decode([b1, b2], 4, key=12, temperature=1.0)
        return [out1[b1], out1[b2], out2[b1], out2[b2]]

    assert run(with_swap=False) == run(with_swap=True)


@pytest.mark.parametrize("arch", RECURRENT)
def test_state_partial_spill_segments(models, arch):
    """Subtree-grained demotion in two waves spills two state segments;
    swap-in restores both and drains the transfer FIFO."""
    _, te = _engines(models, arch)
    sid = te.prefill(list(range(1, 20)))
    b1, b2, b3 = te.branch(sid, 3)
    te.decode([b1, b2, b3], 4, key=21, temperature=0.0)
    before = [_state_of(te, s) for s in (b1, b2)]
    te.swap_out([b1], partial=True)
    te.swap_out([b2], partial=True)
    ns = te.alloc.seqs[sid].ns
    assert len(te._state_spill[ns]) == 2
    filler = te.prefill(list(range(25, 60)))
    te.free(filler)
    te.swap_in([b1, b2])
    assert te._state_spill == {} and te._pending_spills == []
    assert all(_equal(_state_of(te, s), st)
               for s, st in zip((b1, b2), before))
    out = te.decode([b1, b2, b3], 4, key=22, temperature=0.0)
    assert out[b1] == out[b2] == out[b3]
    te.alloc.check_invariants()


@pytest.mark.parametrize("arch", RECURRENT)
def test_state_freed_while_parked_drops_spill(models, arch):
    _, te = _engines(models, arch)
    free0 = te.state.n_free
    sid = te.prefill(list(range(1, 20)))
    b1 = te.branch(sid, 1)[0]
    ns = te.alloc.seqs[sid].ns
    te.swap_out([sid, b1])
    assert ns in te._state_spill and te.state.n_free == free0
    te.free(b1)                     # one of two parked: the spill stays
    assert ns in te._state_spill
    te.free(sid)                    # the last: the spill is dropped
    assert ns not in te._state_spill and te._pending_spills == []
    assert te.state.n_free == free0 and not te.state_of
    te.alloc.check_invariants()
