"""Full searches on the port against ``repro``'s ``LMBackend`` on the CPU.

Greedy ETS and REBASE, through ``run_search`` and ``run_search_many``,
give the same tree (structure, tokens, finished flags, answers) and the
same per-problem attention IO in both attention modes; PRM rewards
match to ``rtol=1e-5`` (the reference's own rewards move by ~1e-6 with
batch composition).  A sampled ETS sweep (temperature 1.0) gives the
reference's trees in both modes (threefry row keys), and a sampled sweep
on the port equals the port's solo runs (row-keyed sampling)."""
import numpy as np
import pytest
from _torch_stack import make_stacks

from repro.core import ETSConfig as JaxETSConfig
from repro.core import SearchConfig as JaxSearchConfig
from repro.core import run_search as jax_run_search
from repro.core import run_search_many as jax_run_search_many
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import PagedEngine as JaxEngine
from repro.serving.search_backend import BackendConfig as JaxBackendConfig
from repro.serving.search_backend import LMBackend as JaxBackend
from repro.training.task import EOS, NEWLINE, ArithmeticTask, encode

from repro_torch.core import ETSConfig, SearchConfig, run_search, \
    run_search_many
from repro_torch.serving import (BackendConfig, EngineConfig, LMBackend,
                                 PagedEngine)

PROMPTS = [encode("Q1+2*3-4*5+6-7\n"), encode("Q3+4\n"), encode("Q5*2-1\n")]
ETS_KW = dict(lambda_b=1.0, lambda_d=1.0, cluster_threshold=0.2)
ENGINE_KW = dict(n_pages=512, page_size=8, max_batch=16, max_seq_len=120)
BACKEND_KW = dict(step_token=NEWLINE, eos_token=EOS, max_step_tokens=10,
                  max_depth=5)
RUNS = [("ets", "many"), ("rebase", "many"), ("ets", "solo"),
        ("rebase", "solo")]


@pytest.fixture(scope="module")
def stacks():
    return make_stacks(seed=0)


def _jax_backend(stacks, mode, temperature=0.0, seed=0):
    (lm, lp), (prm, pp), (emb, ep) = stacks[0]
    engine = JaxEngine(lm, lp, JaxEngineConfig(attention=mode, **ENGINE_KW))
    return JaxBackend(engine, prm, pp, emb, ep,
                      JaxBackendConfig(temperature=temperature, **BACKEND_KW),
                      answer_fn=ArithmeticTask.extract_answer, seed=seed)


def _torch_backend(stacks, mode, temperature=0.0, seed=0):
    (lm, lp), (prm, pp), (emb, ep) = stacks[1]
    engine = PagedEngine(lm, lp, EngineConfig(attention=mode, **ENGINE_KW),
                         device="cpu")
    return LMBackend(engine, prm, pp, emb, ep,
                     BackendConfig(temperature=temperature, **BACKEND_KW),
                     answer_fn=ArithmeticTask.extract_answer, seed=seed,
                     device="cpu")


def _run(backend, run_search_fn, run_many_fn, scfg, how):
    if how == "many":
        return run_many_fn(backend, scfg, PROMPTS)
    return [run_search_fn(backend, scfg, tree=backend.start(p))
            for p in PROMPTS[:2]]


@pytest.fixture(scope="module")
def reference(stacks):
    """Reference results per (mode, method, how), one jax backend per
    mode (its jitted steps compile once).  The reference's two modes
    give the same greedy trees (its own tests assert it), so tree mode
    runs only the ETS sweep, for its attention-IO counters; the other
    tree-mode runs are held to the paged-mode trees."""
    out = {}
    for mode, runs in (("paged", RUNS), ("tree", RUNS[:1])):
        backend = _jax_backend(stacks, mode)
        for method, how in runs:
            scfg = JaxSearchConfig(method=method, width=4, max_steps=3,
                                   ets=JaxETSConfig(**ETS_KW))
            out[mode, method, how] = _run(backend, jax_run_search,
                                          jax_run_search_many, scfg, how)
        backend.engine.alloc.check_invariants()
        assert backend.engine.alloc.used_pages == 0
    return out


def _tree_view(res):
    return [(n.parent, n.depth, n.n_tokens, n.finished,
             (n.payload or {}).get("tokens"), (n.payload or {}).get("answer"))
            for n in res.tree.nodes]


def _assert_same_result(ref, got, same_mode=True):
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        assert _tree_view(a) == _tree_view(b)
        np.testing.assert_allclose([n.reward for n in b.tree.nodes],
                                   [n.reward for n in a.tree.nodes],
                                   rtol=1e-5, atol=0)
        assert a.steps == b.steps and a.answer == b.answer
        keys = ("unique_pages_streamed", "logical_pages_streamed")
        for key in keys if same_mode else keys[1:]:
            assert a.kv_summary[key] == b.kv_summary[key], key


@pytest.mark.parametrize("mode", ["paged", "tree"])
@pytest.mark.parametrize("method,how", RUNS)
def test_greedy_search_matches_reference(stacks, reference, mode, method,
                                         how):
    backend = _torch_backend(stacks, mode)
    scfg = SearchConfig(method=method, width=4, max_steps=3,
                        ets=ETSConfig(**ETS_KW))
    got = _run(backend, run_search, run_search_many, scfg, how)
    ref = reference.get((mode, method, how))
    if ref is None:
        _assert_same_result(reference["paged", method, how], got,
                            same_mode=False)
    else:
        _assert_same_result(ref, got)
    backend.engine.alloc.check_invariants()
    assert backend.engine.alloc.used_pages == 0
    assert any(len(r.tree.nodes) > 4 for r in got)


@pytest.mark.parametrize("mode", ["paged", "tree"])
def test_sampled_search_matches_reference(stacks, mode):
    """Sampled ETS (temperature 1.0, seed 7): the port's sweep gives the
    reference's trees, tokens exact, rewards to rtol 1e-5."""
    scfg = dict(method="ets", width=4, max_steps=3)
    ref = jax_run_search_many(
        _jax_backend(stacks, mode, 1.0, seed=7),
        JaxSearchConfig(ets=JaxETSConfig(**ETS_KW), **scfg), PROMPTS)
    backend = _torch_backend(stacks, mode, 1.0, seed=7)
    got = run_search_many(backend, SearchConfig(ets=ETSConfig(**ETS_KW),
                                                **scfg), PROMPTS)
    _assert_same_result(ref, got)
    # sampling varied the branches (greedy branches of a leaf are equal)
    kids = [tuple((n.payload or {}).get("tokens") or ())
            for n in got[0].tree.nodes[1:]]
    assert len(set(kids)) > 1
    backend.engine.alloc.check_invariants()
    assert backend.engine.alloc.used_pages == 0


def test_sampled_sweep_equals_solo_runs(stacks):
    """Row-keyed sampling: each problem's sampled tree in a sweep equals
    its solo run on a fresh backend with the same seed."""
    scfg = SearchConfig(method="ets", width=4, max_steps=3,
                        ets=ETSConfig(**ETS_KW))
    sweep = run_search_many(_torch_backend(stacks, "tree", 1.0, seed=7),
                            scfg, PROMPTS)
    for prompt, res in zip(PROMPTS, sweep):
        backend = _torch_backend(stacks, "tree", 1.0, seed=7)
        solo = run_search(backend, scfg, tree=backend.start(prompt))
        assert _tree_view(solo) == _tree_view(res)
    # sampling actually varied the branches of at least one step
    kids = [tuple((n.payload or {}).get("tokens") or ())
            for n in sweep[0].tree.nodes[1:]]
    assert len(set(kids)) > 1


def test_sampled_streams_depend_on_seed(stacks):
    scfg = SearchConfig(method="rebase", width=4, max_steps=2)
    runs = [run_search_many(_torch_backend(stacks, "paged", 1.0, seed=s),
                            scfg, PROMPTS[:1])[0] for s in (1, 2)]
    assert _tree_view(runs[0]) != _tree_view(runs[1])


def test_multi_replica_sweep_is_a_later_slice(stacks):
    """The multi-replica sweep landed with the replicas slice: two
    backends give the one-backend sweep's trees (the replica suite is
    ``tests/test_torch_replica.py``)."""
    scfg = SearchConfig(method="ets", width=2, max_steps=1)
    want = run_search_many(_torch_backend(stacks, "paged"), scfg, PROMPTS)
    backends = [_torch_backend(stacks, "paged") for _ in range(2)]
    got = run_search_many(backends, scfg, PROMPTS)
    assert [_tree_view(r) for r in got] == [_tree_view(r) for r in want]
