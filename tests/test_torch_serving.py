"""The online ``ServingLoop`` on the port, against ``run_search_many`` and
against ``repro``'s ``ServingLoop`` on the CPU.

  * a degenerate trace (all arrivals at 0, no deadlines) gives the
    sweep's trees in both attention modes, lock-step and token-level
    refill;
  * the slice's whole path — a Poisson trace with priorities and
    deadlines, tree attention, a long prompt streamed in segments, a
    pool small enough that problems are demoted to host memory and
    restored — gives the reference's trees (tokens exact, rewards to
    rtol 1e-5), the same virtual-clock SLO report and the same swap
    counters, in both scheduling modes;
  * First-Finish halts each problem at its first answer;
  * refill never runs more decode iterations than lock-step;
  * a JSON trace loads into the reference's requests, and serves;
  * a backend without the row-level interface is served by refill's
    whole-step event mode, with the sweep's trees and the reference's
    event-mode SLO report; on the stub backend of the reference's tests
    both scheduling modes reproduce the sweep, random timed workloads
    never change a result and nothing starves, and First-Finish stops
    early (``tests/test_serving.py:104-170``).
"""
import json

import numpy as np
import pytest
from _hypothesis_shim import HealthCheck, given, settings, st
from _torch_stack import make_stacks
from test_serving import STUB_PROMPTS, _assert_results_identical
from test_serving import StubBackend as RefStubBackend
from test_torch_replica import STUB_SCFG, StubBackend, _stub_serial

from repro.core import ETSConfig as JaxETSConfig
from repro.core import Request as JaxRequest
from repro.core import SearchConfig as JaxSearchConfig
from repro.core import ServingConfig as JaxServingConfig
from repro.core import ServingLoop as JaxServingLoop
from repro.core import load_trace as jax_load_trace
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import PagedEngine as JaxEngine
from repro.serving.search_backend import BackendConfig as JaxBackendConfig
from repro.serving.search_backend import LMBackend as JaxBackend
from repro.training.task import EOS, NEWLINE

from repro_torch.core import (ETSConfig, Request, SearchConfig,
                              ServingConfig, ServingLoop, load_trace,
                              poisson_requests, run_search_many)
from repro_torch.serving import (BackendConfig, EngineConfig, LMBackend,
                                 PagedEngine)

ENGINE_KW = dict(page_size=8, max_batch=32, max_seq_len=160)
BACKEND_KW = dict(step_token=NEWLINE, eos_token=EOS, max_step_tokens=6,
                  max_depth=4, temperature=1.0)
ETS_KW = dict(lambda_b=1.0, lambda_d=1.0, cluster_threshold=0.2)
SCFG_KW = dict(method="ets", width=5, max_steps=3)


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(2, NEWLINE, n))) for n in lengths]


PROMPTS = _prompts((17, 23, 9, 30))
# the slice's path: one prompt longer than the prefill chunk among short
# ones, more requests than max_live
LONG_PROMPTS = _prompts((17, 90, 23, 9, 30, 12))
CHUNK = 32
TIGHT_POOL = 40


@pytest.fixture(scope="module")
def stacks():
    return make_stacks(seed=0)


def _torch_backend(stacks, attention="tree", n_pages=256, **ekw):
    (lm, lp), (prm, pp), (emb, ep) = stacks[1]
    engine = PagedEngine(lm, lp, EngineConfig(
        n_pages=n_pages, attention=attention, **ENGINE_KW, **ekw),
        device="cpu")
    return engine, LMBackend(engine, prm, pp, emb, ep,
                             BackendConfig(**BACKEND_KW),
                             answer_fn=lambda full: None, seed=13,
                             device="cpu")


def _jax_backend(stacks, attention="tree", n_pages=256, **ekw):
    (lm, lp), (prm, pp), (emb, ep) = stacks[0]
    engine = JaxEngine(lm, lp, JaxEngineConfig(
        n_pages=n_pages, attention=attention, **ENGINE_KW, **ekw))
    return engine, JaxBackend(engine, prm, pp, emb, ep,
                              JaxBackendConfig(**BACKEND_KW),
                              answer_fn=lambda full: None, seed=13)


def _scfg():
    return SearchConfig(ets=ETSConfig(**ETS_KW), **SCFG_KW)


def _jax_scfg():
    return JaxSearchConfig(ets=JaxETSConfig(**ETS_KW), **SCFG_KW)


def _tree_view(res):
    return [(n.id, n.parent, n.n_tokens, n.finished,
             (n.payload or {}).get("tokens")) for n in res.tree.nodes]


def _assert_same_results(ref, got):
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        assert _tree_view(a) == _tree_view(b)
        np.testing.assert_allclose([n.reward for n in b.tree.nodes],
                                   [n.reward for n in a.tree.nodes],
                                   rtol=1e-5, atol=0)
        assert a.steps == b.steps and a.answer == b.answer
        assert [c[0] for c in a.completed] == [c[0] for c in b.completed]


@pytest.fixture(scope="module")
def sweeps(stacks):
    """``run_search_many`` on the port, per attention mode."""
    out = {}
    for attention in ("paged", "tree"):
        _, backend = _torch_backend(stacks, attention)
        out[attention] = run_search_many(backend, _scfg(), PROMPTS)
    return out


@pytest.mark.parametrize("refill", [False, True])
@pytest.mark.parametrize("attention", ["paged", "tree"])
def test_degenerate_trace_equals_sweep(stacks, sweeps, attention, refill):
    engine, backend = _torch_backend(stacks, attention)
    loop = ServingLoop(backend, _scfg(), [Request(prompt=p) for p in PROMPTS],
                       cfg=ServingConfig(refill=refill))
    _assert_same_results(sweeps[attention], loop.run())
    assert loop.slo.report()["n_finished"] == len(PROMPTS)
    assert engine.alloc.used_pages == 0
    engine.alloc.check_invariants()
    if refill:
        # the whole run decodes through one persistent stream
        assert loop._stream is not None
        assert engine.n_decode_calls == 0


def _slice_requests(request_cls):
    reqs = poisson_requests(LONG_PROMPTS, rate=0.05, seed=0,
                            priorities=[0, 1], deadline_slack=300)
    return [request_cls(prompt=list(r.prompt), arrival=r.arrival,
                        priority=r.priority, deadline=r.deadline)
            for r in reqs]


def _serve(loop_cls, cfg_cls, req_cls, backend, scfg, refill):
    loop = loop_cls(backend, scfg, _slice_requests(req_cls), max_live=3,
                    cfg=cfg_cls.from_stage_costs(
                        {"decode_iter_s": 0.02, "score_s": 0.05,
                         "embed_s": 0.004, "prefill_s": 0.03},
                        refill=refill))
    return loop, loop.run()


@pytest.mark.parametrize("refill", [True, False])
def test_slice_path_matches_reference(stacks, refill):
    kw = dict(attention="tree", n_pages=TIGHT_POOL,
              prefill_chunk_tokens=CHUNK)
    jengine, jbackend = _jax_backend(stacks, **kw)
    jloop, ref = _serve(JaxServingLoop, JaxServingConfig, JaxRequest,
                        jbackend, JaxSearchConfig(ets=JaxETSConfig(**ETS_KW),
                                                  **SCFG_KW), refill)
    engine, backend = _torch_backend(stacks, **kw)
    streamed = []
    orig = engine._prefill_streamed
    engine._prefill_streamed = lambda h, ctx: (streamed.append(len(ctx)),
                                               orig(h, ctx))
    loop, got = _serve(ServingLoop, ServingConfig, Request, backend, _scfg(),
                       refill)
    _assert_same_results(ref, got)
    assert loop.slo.report() == jloop.slo.report()
    assert loop.slo.admitted == jloop.slo.admitted
    assert loop.slo.report()["n_finished"] == len(LONG_PROMPTS)
    # the long prompt streamed, and the pool was too small: problems were
    # demoted and restored exactly as in the reference
    assert streamed == [89]                 # in ceil(89 / 32) segments
    assert engine.n_prefill_calls == jengine.n_prefill_calls
    assert engine.n_prefill_tokens == sum(len(p) - 1 for p in LONG_PROMPTS)
    assert loop.stats.demotions == jloop.stats.demotions > 0
    assert engine.swapped_out_pages == engine.swapped_in_pages \
        == jengine.swapped_out_pages > 0
    assert (engine.n_decode_steps, engine.unique_pages_streamed,
            engine.logical_pages_streamed) == \
        (jengine.n_decode_steps, jengine.unique_pages_streamed,
         jengine.logical_pages_streamed)
    assert engine.alloc.used_pages == engine.alloc.swapped_pages == 0
    engine.alloc.check_invariants()


def test_first_finish_halts_at_first_answer(stacks):
    reqs = [Request(prompt=p) for p in PROMPTS]
    runs = {}
    for ff in (False, True):
        _, backend = _torch_backend(stacks)
        loop = ServingLoop(backend, _scfg(), reqs,
                           cfg=ServingConfig(refill=True, first_finish=ff))
        runs[ff] = (loop, loop.run())
    (full, full_out), (ffl, ff_out) = runs[False], runs[True]
    for a, b in zip(ff_out, full_out):
        assert a.steps <= b.steps
        # the early answers are a prefix of the full run's: the same
        # streams, truncated at the first completed trajectory
        assert bool(a.completed) == bool(b.completed)
        assert a.completed == b.completed[:len(a.completed)]
    assert any(a.steps < b.steps for a, b in zip(ff_out, full_out))
    assert sum(ffl.slo.finished.values()) < sum(full.slo.finished.values())


def test_refill_decode_iterations_never_exceed_lockstep(stacks):
    reqs = poisson_requests(PROMPTS * 2, rate=0.1, seed=5)
    engines, loops = {}, {}
    for refill in (False, True):
        engine, backend = _torch_backend(stacks)
        loop = ServingLoop(backend, _scfg(),
                           [Request(prompt=list(r.prompt), arrival=r.arrival)
                            for r in reqs],
                           max_live=2, cfg=ServingConfig(refill=refill))
        loop.run()
        engines[refill], loops[refill] = engine, loop
    assert engines[True].n_decode_steps <= engines[False].n_decode_steps
    assert loops[True].slo.report()["p99_tta"] < \
        loops[False].slo.report()["p99_tta"]


def test_load_trace_matches_reference(stacks, tmp_path):
    """A JSON trace, optional fields left out on some entries, loads into
    the reference's requests field for field and serves every request."""
    reqs = poisson_requests(PROMPTS, rate=0.1, seed=3, priorities=[1, 0],
                            deadline_slack=200)
    entries = [dict(prompt=r.prompt, arrival=r.arrival, priority=r.priority,
                    deadline=r.deadline) for r in reqs[:2]]
    entries += [dict(prompt=r.prompt) for r in reqs[2:3]]
    entries += [dict(prompt=r.prompt, arrival=r.arrival) for r in reqs[3:]]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(entries))
    got, want = load_trace(str(path)), jax_load_trace(str(path))
    assert [vars(r) for r in got] == [vars(r) for r in want]
    assert [vars(r) for r in got[:2]] == [vars(r) for r in reqs[:2]]
    assert got[2].arrival == 0.0 and got[2].deadline is None
    engine, backend = _torch_backend(stacks)
    loop = ServingLoop(backend, _scfg(), got, max_live=2)
    assert len(loop.run()) == len(PROMPTS)
    assert loop.slo.report()["n_finished"] == len(PROMPTS)
    assert engine.alloc.used_pages == 0


def _whole_step(backend):
    """``backend`` without the row-level interface."""
    class WholeStep:
        def __getattr__(self, name):
            if name in ("expand_begin", "expand_finish", "open_stream",
                        "stream_budget"):
                raise AttributeError(name)
            return getattr(backend, name)

    return WholeStep()


def test_refill_needs_row_level_backend(stacks, sweeps):
    """Token-level refill needs the row-level interface; without it the
    loop runs refill's whole-step event mode, as the reference does:
    the sweep's trees, and the reference's event-mode trees, clock and
    SLO report.  Lock-step serves the same backend too."""
    reqs = [Request(prompt=p, arrival=2.0 * i, priority=i % 2)
            for i, p in enumerate(PROMPTS)]
    jreqs = [JaxRequest(prompt=r.prompt, arrival=r.arrival,
                        priority=r.priority) for r in reqs]
    for refill in (True, False):
        _, backend = _torch_backend(stacks)
        loop = ServingLoop(_whole_step(backend), _scfg(), reqs, max_live=2,
                           cfg=ServingConfig(refill=refill))
        assert loop._rowlevel is False
        got = loop.run()
        _assert_same_results(sweeps["tree"], got)
        _, jbackend = _jax_backend(stacks)
        jloop = JaxServingLoop(_whole_step(jbackend), _jax_scfg(), jreqs,
                               max_live=2,
                               cfg=JaxServingConfig(refill=refill))
        assert jloop._rowlevel is False
        _assert_same_results(jloop.run(), got)
        assert loop.slo.report() == jloop.slo.report()
        assert loop.clock == jloop.clock
    _, backend = _torch_backend(stacks)
    assert ServingLoop(backend, _scfg(), reqs)._rowlevel is True


def test_est_step_cost_overrides_the_slack_estimate(stacks):
    _, backend = _torch_backend(stacks)
    reqs = [Request(prompt=p) for p in PROMPTS]
    assert ServingLoop(backend, _scfg(), reqs, cfg=ServingConfig(
        est_step_cost=3.5))._est_step == 3.5
    loop = ServingLoop(backend, _scfg(), reqs)
    cfg = loop.cfg
    assert loop._est_step == (cfg.decode_iter_cost * backend.stream_budget()
                              + cfg.score_cost + cfg.embed_cost)


# ---------------------------------------------------------------------------
# The reference's stub-backend cases, against the port's event mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("refill", [False, True])
def test_degenerate_trace_matches_batch_sweep_stub(refill):
    base = run_search_many(StubBackend(), STUB_SCFG, STUB_PROMPTS)
    loop = ServingLoop(StubBackend(), STUB_SCFG,
                       [Request(prompt=p) for p in STUB_PROMPTS],
                       cfg=ServingConfig(refill=refill))
    _assert_results_identical(base, loop.run())
    rep = loop.slo.report()
    assert rep["n_finished"] == len(STUB_PROMPTS)
    assert rep["deadline_hit_rate"] is None
    assert 0 < rep["p50_tta"] <= rep["p99_tta"] <= rep["max_tta"]
    jloop = JaxServingLoop(RefStubBackend(), JaxSearchConfig(
        method="beam", width=4, max_steps=3),
        [JaxRequest(prompt=p) for p in STUB_PROMPTS],
        cfg=JaxServingConfig(refill=refill))
    jloop.run()
    assert rep == jloop.slo.report() and loop.clock == jloop.clock


@settings(max_examples=10, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.tuples(st.integers(0, 50),        # arrival time
                          st.integers(0, 2),         # priority class
                          st.integers(0, 1)),        # has a deadline?
                min_size=2, max_size=6),
       st.integers(1, 4),                            # max_live
       st.integers(0, 1))                            # first_finish
def test_timed_workload_scheduling_invariance_stub(specs, max_live,
                                                   first_finish):
    """Refill's event mode on a whole-step backend: every request
    finishes, and without First-Finish each equals its solo run."""
    prompts = [[100 + i, i % 7] for i in range(len(specs))]
    reqs = [Request(prompt=p, arrival=float(a), priority=prio,
                    deadline=float(a + 40) if dl else None)
            for p, (a, prio, dl) in zip(prompts, specs)]
    loop = ServingLoop(StubBackend(), STUB_SCFG, reqs, max_live=max_live,
                       cfg=ServingConfig(refill=True,
                                         first_finish=bool(first_finish)))
    out = loop.run()
    assert len(out) == len(reqs)
    for i, req in enumerate(reqs):
        assert i in loop.slo.finished
        assert loop.slo.finished[i] >= req.arrival
        assert loop.slo.admitted[i] >= req.arrival
        assert out[i].completed
    if not first_finish:
        _assert_results_identical(_stub_serial(prompts), out)


def test_first_finish_halts_at_first_answer_stub():
    reqs = [Request(prompt=p) for p in STUB_PROMPTS]
    full = ServingLoop(StubBackend(), STUB_SCFG, reqs,
                       cfg=ServingConfig(refill=True)).run()
    ff_loop = ServingLoop(StubBackend(), STUB_SCFG, reqs,
                          cfg=ServingConfig(refill=True, first_finish=True))
    ff = ff_loop.run()
    for a, b in zip(ff, full):
        assert a.steps <= b.steps
        assert len(a.completed) >= 1
    assert sum(a.steps for a in ff) < sum(b.steps for b in full)
