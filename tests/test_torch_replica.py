"""Engine replicas on the port (the port's mirror of the replica tests of
``tests/test_mesh.py``), against the port's single-backend runs and
against ``repro``'s replica classes on the CPU.

  * a two-replica LM sweep (``run_search_many`` on a list of backends)
    gives the single-backend sweep's trees, greedy and sampled, and the
    reference's two-replica trees (tokens exact, rewards within rtol
    1e-5, the port's reward contract);
  * stub sweeps over 1-3 replicas and random routers reproduce serial
    runs exactly; a one-element list unwraps to the plain sweep;
  * ``ReplicaServingLoop``: a degenerate trace equals the batch sweep
    (stub and LM, both scheduling modes: the stub, which has no
    row-level interface, is refilled in whole-step event mode, as in
    the reference), random timed workloads and routers never change a
    result, and a Poisson trace served on two LM replicas matches the
    reference's routing, trees and SLO report;
  * ``ServingLoop.submit`` is the constructor's request, late;
  * ``launch.serve --replicas 2`` serves a workload to its end.
"""
import numpy as np
import pytest
from _hypothesis_shim import HealthCheck, given, settings, st
from _torch_stack import make_stacks
from test_serving import STUB_PROMPTS, _assert_results_identical
from test_serving import StubBackend as _RefStubBackend

from repro.core import ETSConfig as JaxETSConfig
from repro.core import ReplicaServingLoop as JaxReplicaServingLoop
from repro.core import Request as JaxRequest
from repro.core import SearchConfig as JaxSearchConfig
from repro.core import ServingConfig as JaxServingConfig
from repro.core import run_search_many as jax_run_search_many
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import PagedEngine as JaxEngine
from repro.serving.search_backend import BackendConfig as JaxBackendConfig
from repro.serving.search_backend import LMBackend as JaxBackend
from repro.training.task import EOS, NEWLINE

from repro_torch.core import (ETSConfig, ReplicaServingLoop, ReplicaSweep,
                              Request, SearchConfig, SearchTree,
                              ServingConfig, ServingLoop, poisson_requests,
                              run_search, run_search_many)
from repro_torch.launch import serve as launch_serve
from repro_torch.serving import (BackendConfig, EngineConfig, LMBackend,
                                 PagedEngine)


class StubBackend(_RefStubBackend):
    """The reference tests' prompt-keyed stub, on the port's tree."""

    def start(self, prompt):
        return SearchTree(root_tokens=len(prompt),
                          root_payload={"prompt": tuple(prompt)})


STUB_SCFG = SearchConfig(method="beam", width=4, max_steps=3)

ENGINE_KW = dict(n_pages=256, page_size=8, max_batch=32, max_seq_len=128)
BACKEND_KW = dict(step_token=NEWLINE, eos_token=EOS, max_step_tokens=6,
                  max_depth=4)
ETS_KW = dict(lambda_b=1.0, lambda_d=1.0, cluster_threshold=0.2)
SCFG_KW = dict(method="ets", width=4, max_steps=2)
LM_PROMPTS = [list(map(int, np.random.default_rng(i).integers(2, NEWLINE, n)))
              for i, n in enumerate((17, 23, 9))]


@pytest.fixture(scope="module")
def stacks():
    return make_stacks(seed=0)


def _lm_backend(stacks, attention="tree", temperature=0.0):
    (lm, lp), (prm, pp), (emb, ep) = stacks[1]
    engine = PagedEngine(lm, lp, EngineConfig(attention=attention,
                                              **ENGINE_KW), device="cpu")
    return LMBackend(engine, prm, pp, emb, ep,
                     BackendConfig(temperature=temperature, **BACKEND_KW),
                     answer_fn=lambda full: None, seed=13, device="cpu")


def _jax_backend(stacks, attention="tree", temperature=0.0):
    (lm, lp), (prm, pp), (emb, ep) = stacks[0]
    engine = JaxEngine(lm, lp, JaxEngineConfig(attention=attention,
                                               **ENGINE_KW))
    return JaxBackend(engine, prm, pp, emb, ep,
                      JaxBackendConfig(temperature=temperature, **BACKEND_KW),
                      answer_fn=lambda full: None, seed=13)


def _scfg():
    return SearchConfig(ets=ETSConfig(**ETS_KW), **SCFG_KW)


def _jax_scfg():
    return JaxSearchConfig(ets=JaxETSConfig(**ETS_KW), **SCFG_KW)


def _tree_view(res):
    return [(n.id, n.parent, n.n_tokens, n.finished,
             (n.payload or {}).get("tokens")) for n in res.tree.nodes]


def _assert_same_results(ref, got):
    """Tokens and structure exact, rewards within rtol 1e-5."""
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        assert len(b.tree.nodes) > 1
        assert _tree_view(a) == _tree_view(b)
        np.testing.assert_allclose([n.reward for n in b.tree.nodes],
                                   [n.reward for n in a.tree.nodes],
                                   rtol=1e-5, atol=0)
        assert a.steps == b.steps and a.answer == b.answer


def _drained(backends):
    for b in backends:
        assert b.engine.alloc.used_pages == 0
        b.engine.alloc.check_invariants()


# ---------------------------------------------------------------------------
# replica sweeps on LM backends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_replica_sweep_lm_bit_identical(stacks, temperature):
    """Two LM engine replicas behind one queue reproduce the
    single-backend sweep per problem (identically-seeded backends), and
    the reference's two-replica sweep."""
    want = run_search_many(_lm_backend(stacks, temperature=temperature),
                           _scfg(), LM_PROMPTS)
    backends = [_lm_backend(stacks, temperature=temperature)
                for _ in range(2)]
    got = run_search_many(backends, _scfg(), LM_PROMPTS)
    _assert_same_results(want, got)
    _drained(backends)
    assert all(b.engine.n_decode_steps for b in backends)
    ref = jax_run_search_many(
        [_jax_backend(stacks, temperature=temperature) for _ in range(2)],
        _jax_scfg(), LM_PROMPTS)
    _assert_same_results(ref, got)


def test_replica_sweep_paged_mode(stacks):
    want = run_search_many(_lm_backend(stacks, "paged"), _scfg(), LM_PROMPTS)
    backends = [_lm_backend(stacks, "paged") for _ in range(3)]
    _assert_same_results(want, run_search_many(backends, _scfg(),
                                               LM_PROMPTS))
    _drained(backends)


def test_multi_replica_sweep_needs_continuous(stacks):
    with pytest.raises(ValueError, match="continuous=True"):
        run_search_many([StubBackend(), StubBackend()], STUB_SCFG,
                        STUB_PROMPTS, continuous=False)


# ---------------------------------------------------------------------------
# replica sweep: routing-invariant per-problem results (stub backend)
# ---------------------------------------------------------------------------

def _stub_serial(prompts, scfg=STUB_SCFG):
    be = StubBackend()
    return [run_search(be, scfg, tree=be.start(p)) for p in prompts]


def test_replica_sweep_matches_serial_runs():
    want = _stub_serial(STUB_PROMPTS)
    for n_rep in (1, 2, 3):
        rs = ReplicaSweep([StubBackend() for _ in range(n_rep)],
                          STUB_SCFG, STUB_PROMPTS)
        _assert_results_identical(want, rs.run())
        counts = [len(rep.sched.results) for rep in rs.replicas]
        assert sum(counts) == len(STUB_PROMPTS)
        if n_rep > 1:
            assert max(counts) < len(STUB_PROMPTS)   # routing spread


def test_run_search_many_unwraps_single_backend_list():
    want = run_search_many(StubBackend(), STUB_SCFG, STUB_PROMPTS)
    got = run_search_many([StubBackend()], STUB_SCFG, STUB_PROMPTS)
    _assert_results_identical(want, got)


@settings(max_examples=15, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.integers(0, 10 ** 6),       # router seed
       st.integers(1, 4),             # replicas
       st.integers(1, 5))             # per-replica max_live
def test_replica_sweep_random_routing_invariance(seed, n_rep, max_live):
    """ANY room-respecting router yields the same per-problem results."""
    rng = np.random.default_rng(seed)

    def chaotic_router(eligible, loads):
        return eligible[int(rng.integers(len(eligible)))]

    rs = ReplicaSweep([StubBackend() for _ in range(n_rep)], STUB_SCFG,
                      STUB_PROMPTS, max_live=max_live,
                      router=chaotic_router)
    _assert_results_identical(_stub_serial(STUB_PROMPTS), rs.run())


# ---------------------------------------------------------------------------
# replica serving loop: one arrival stream over N loops
# ---------------------------------------------------------------------------

def test_replica_serving_degenerate_trace():
    """All arrivals at t=0: the replica pool reproduces the batch sweep
    per request, and the merged SLO report covers every request."""
    want = run_search_many(StubBackend(), STUB_SCFG, STUB_PROMPTS)
    pool = ReplicaServingLoop(
        [StubBackend() for _ in range(2)], STUB_SCFG,
        [Request(prompt=p) for p in STUB_PROMPTS],
        cfg=ServingConfig(refill=False))
    _assert_results_identical(want, pool.run())
    assert pool.slo.report()["n_finished"] == len(STUB_PROMPTS)
    assert sorted(pool.routed) == list(range(len(STUB_PROMPTS)))
    assert pool.clock == max(lp.clock for lp in pool.loops)


@pytest.mark.parametrize("refill", [False, True])
def test_replica_serving_degenerate_trace_lm(stacks, refill):
    want = run_search_many(_lm_backend(stacks), _scfg(), LM_PROMPTS)
    backends = [_lm_backend(stacks) for _ in range(2)]
    pool = ReplicaServingLoop(backends, _scfg(),
                              [Request(prompt=p) for p in LM_PROMPTS],
                              cfg=ServingConfig(refill=refill))
    _assert_same_results(want, pool.run())
    assert pool.slo.report()["n_finished"] == len(LM_PROMPTS)
    assert set(pool.routed.values()) == {0, 1}
    _drained(backends)


@settings(max_examples=10, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.tuples(st.integers(0, 50),     # arrival time
                          st.integers(0, 2)),     # priority class
                min_size=2, max_size=6),
       st.integers(1, 3),                         # replicas
       st.integers(0, 10 ** 6))                   # router seed
def test_replica_serving_timed_workload_invariance(specs, n_rep, seed):
    """Random arrivals, priorities, replica counts and routers: every
    request finishes with its solo-run result."""
    rng = np.random.default_rng(seed)

    def chaotic_router(eligible, loads):
        return eligible[int(rng.integers(len(eligible)))]

    prompts = [[100 + i, i % 7] for i in range(len(specs))]
    reqs = [Request(prompt=p, arrival=float(a), priority=prio)
            for p, (a, prio) in zip(prompts, specs)]
    pool = ReplicaServingLoop([StubBackend() for _ in range(n_rep)],
                              STUB_SCFG, reqs, max_live=2,
                              cfg=ServingConfig(refill=False),
                              router=chaotic_router)
    _assert_results_identical(_stub_serial(prompts), pool.run())
    assert pool.slo.report()["n_finished"] == len(reqs)


@pytest.mark.parametrize("refill", [True, False])
def test_replica_serving_matches_reference(stacks, refill):
    """A Poisson trace with priorities and deadlines on two LM replicas:
    the reference's routing, trees and virtual-clock SLO report."""
    reqs = poisson_requests(LM_PROMPTS * 2, rate=0.05, seed=1,
                            priorities=[0, 1], deadline_slack=200)

    def serve(loop_cls, cfg_cls, req_cls, backends, scfg):
        loop = loop_cls(backends, scfg,
                        [req_cls(prompt=list(r.prompt), arrival=r.arrival,
                                 priority=r.priority, deadline=r.deadline)
                         for r in reqs],
                        max_live=2, cfg=cfg_cls(refill=refill))
        return loop, loop.run()

    jloop, ref = serve(JaxReplicaServingLoop, JaxServingConfig, JaxRequest,
                       [_jax_backend(stacks) for _ in range(2)],
                       _jax_scfg())
    backends = [_lm_backend(stacks) for _ in range(2)]
    loop, got = serve(ReplicaServingLoop, ServingConfig, Request, backends,
                      _scfg())
    _assert_same_results(ref, got)
    assert loop.routed == jloop.routed and set(loop.routed.values()) \
        == {0, 1}
    assert loop.slo.report() == jloop.slo.report()
    assert loop.clock == jloop.clock
    _drained(backends)


def test_replica_refill_needs_row_level_backends():
    """Refill over whole-step replicas runs each loop in event mode:
    the batch sweep's results, and the reference pool's routing, clock
    and SLO report on its own stub."""
    want = run_search_many(StubBackend(), STUB_SCFG, STUB_PROMPTS)
    reqs = [(p, float(3 * i), i % 2) for i, p in enumerate(STUB_PROMPTS)]
    pool = ReplicaServingLoop(
        [StubBackend() for _ in range(2)], STUB_SCFG,
        [Request(prompt=p, arrival=a, priority=q) for p, a, q in reqs],
        max_live=2, cfg=ServingConfig(refill=True))
    assert not any(lp._rowlevel for lp in pool.loops)
    _assert_results_identical(want, pool.run())
    jpool = JaxReplicaServingLoop(
        [_RefStubBackend() for _ in range(2)],
        JaxSearchConfig(method="beam", width=4, max_steps=3),
        [JaxRequest(prompt=p, arrival=a, priority=q) for p, a, q in reqs],
        max_live=2, cfg=JaxServingConfig(refill=True))
    jpool.run()
    assert pool.routed == jpool.routed
    assert pool.slo.report() == jpool.slo.report()
    assert pool.clock == jpool.clock


def test_replica_serving_degenerate_trace_refill():
    want = run_search_many(StubBackend(), STUB_SCFG, STUB_PROMPTS)
    pool = ReplicaServingLoop(
        [StubBackend() for _ in range(2)], STUB_SCFG,
        [Request(prompt=p) for p in STUB_PROMPTS],
        cfg=ServingConfig(refill=True))
    _assert_results_identical(want, pool.run())
    assert pool.slo.report()["n_finished"] == len(STUB_PROMPTS)
    assert sorted(pool.routed) == list(range(len(STUB_PROMPTS)))
    assert pool.clock == max(lp.clock for lp in pool.loops)


@settings(max_examples=10, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.tuples(st.integers(0, 50),     # arrival time
                          st.integers(0, 2)),     # priority class
                min_size=2, max_size=6),
       st.integers(1, 3),                         # replicas
       st.integers(0, 10 ** 6))                   # router seed
def test_replica_serving_timed_workload_invariance_refill(specs, n_rep,
                                                          seed):
    rng = np.random.default_rng(seed)

    def chaotic_router(eligible, loads):
        return eligible[int(rng.integers(len(eligible)))]

    prompts = [[100 + i, i % 7] for i in range(len(specs))]
    reqs = [Request(prompt=p, arrival=float(a), priority=prio)
            for p, (a, prio) in zip(prompts, specs)]
    pool = ReplicaServingLoop([StubBackend() for _ in range(n_rep)],
                              STUB_SCFG, reqs, max_live=2,
                              cfg=ServingConfig(refill=True),
                              router=chaotic_router)
    _assert_results_identical(_stub_serial(prompts), pool.run())
    assert pool.slo.report()["n_finished"] == len(reqs)


def test_serving_loop_submit_matches_constructor():
    """submit() is equivalent to passing the request up front."""
    reqs = [Request(prompt=p, arrival=float(i))
            for i, p in enumerate(STUB_PROMPTS)]
    want = ServingLoop(StubBackend(), STUB_SCFG, reqs,
                       cfg=ServingConfig(refill=False)).run()
    loop = ServingLoop(StubBackend(), STUB_SCFG, [],
                       cfg=ServingConfig(refill=False))
    for i, r in enumerate(reqs):
        loop.submit(i, r)
    _assert_results_identical(want, loop.run())
    assert loop.requests == dict(enumerate(reqs))
    with pytest.raises(AssertionError, match="duplicate"):
        loop.submit(0, reqs[0])


# ---------------------------------------------------------------------------
# the serve launcher on two replicas
# ---------------------------------------------------------------------------

def test_serve_launcher_runs_replicas(capsys):
    out = launch_serve.main(["--device", "cpu", "--requests", "3",
                             "--train-steps", "3", "--replicas", "2",
                             "--max-live", "1"])
    loop = out["loop"]
    assert isinstance(loop, ReplicaServingLoop) and len(out["backends"]) == 2
    assert len(out["results"]) == 3 and out["report"]["n_finished"] == 3
    assert set(loop.routed.values()) == {0, 1}
    # the replicas share the weights, not the pools
    e0, e1 = (b.engine for b in out["backends"])
    assert e0.params is e1.params and e0.pool is not e1.pool
    _drained(out["backends"])
    assert "replicas=2" in capsys.readouterr().out
