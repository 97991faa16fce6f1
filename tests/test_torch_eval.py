"""The port's eval harness (``repro_torch.eval``) and its host-only core
copies (``core.synthetic``, ``core.costsim``): the harness tests of
``tests/test_adaptive.py`` on the port, then reports, documents and cost
estimates equal to the reference's for the same seeds and configs."""
import dataclasses

import numpy as np
import pytest

from repro import core as jcore
from repro import eval as jeval

from repro_torch.core import (AdaptiveConfig, ETSConfig, HardwareModel,
                              SearchConfig, SyntheticProblem,
                              SyntheticTaskConfig, evaluate_method,
                              run_search, simulate_search_cost)
from repro_torch.eval import (EvalTask, get_task, list_tasks, register_task,
                              run_eval)


# ---------------------------------------------------------------------------
# The reference's harness tests, on the port
# ---------------------------------------------------------------------------

def test_task_registry_roundtrip():
    assert "synthetic" in list_tasks() and "arithmetic" in list_tasks()
    with pytest.raises(KeyError):
        get_task("no-such-task")

    @register_task("_test_dummy")
    class Dummy(EvalTask):
        def docs(self, n, seed=0):
            return []

    assert isinstance(get_task("_test_dummy"), Dummy)
    assert "_test_dummy" in list_tasks()


def test_arithmetic_task_docs_are_checkable():
    task = get_task("arithmetic", n_ops=2)
    docs = task.docs(5, seed=3)
    assert len(docs) == 5
    for d in docs:
        assert d.prompt is not None and len(d.prompt) > 0
        assert isinstance(d.gold, int)
        assert task.check(d.gold, d.gold)
        assert not task.check(None, d.gold)
        assert not task.check(d.gold + 1, d.gold)


def test_run_eval_synthetic_report_shape():
    scfg = SearchConfig(method="ets", width=4, max_steps=4,
                        ets=ETSConfig(lambda_b=1.0, lambda_d=1.0))
    rep = run_eval(get_task("synthetic"), scfg, n=8, seed=0)
    assert rep.task == "synthetic" and rep.n == 8
    assert 0.0 <= rep.accuracy <= 1.0
    assert len(rep.results) == len(rep.correct) == 8
    assert rep.total_gen_tokens > 0
    assert rep.gen_tokens_per_doc == pytest.approx(
        rep.total_gen_tokens / 8)
    assert rep.accuracy == pytest.approx(np.mean(rep.correct))


def test_run_eval_disabled_adaptation_matches_plain():
    scfg = SearchConfig(method="ets", width=6, max_steps=5,
                        ets=ETSConfig(lambda_b=1.0, lambda_d=1.0))
    plain = run_eval(get_task("synthetic"), scfg, n=10, seed=3)
    off = run_eval(get_task("synthetic"), scfg, n=10, seed=3,
                   adaptive=AdaptiveConfig(enabled=False))
    assert plain.accuracy == off.accuracy
    assert plain.total_gen_tokens == off.total_gen_tokens
    assert plain.correct == off.correct


# ---------------------------------------------------------------------------
# Equal to the reference (both host code)
# ---------------------------------------------------------------------------

def _both(cls_name, **kw):
    """The same config object in the port and in the reference."""
    import repro_torch.core as tcore
    return getattr(tcore, cls_name)(**kw), getattr(jcore, cls_name)(**kw)


def _tree_shape(res):
    return [(n.parent, n.n_tokens, n.payload and n.payload.get("answer"))
            for n in res.tree.nodes]


@pytest.mark.parametrize("method,adaptive", [
    ("ets", None), ("rebase", None),
    ("ets", dict(easy_threshold=2.0, hard_threshold=-1.0, min_width=1))])
def test_synthetic_run_eval_equals_reference(method, adaptive):
    ets_kw = dict(lambda_b=1.0, lambda_d=1.0)
    tscfg = SearchConfig(method=method, width=6, max_steps=5,
                         ets=ETSConfig(**ets_kw))
    jscfg = jcore.SearchConfig(method=method, width=6, max_steps=5,
                               ets=jcore.ETSConfig(**ets_kw))
    tad, jad = (None, None) if adaptive is None else _both(
        "AdaptiveConfig", **adaptive)
    got = run_eval(get_task("synthetic"), tscfg, n=12, seed=4, adaptive=tad)
    want = jeval.run_eval(jeval.get_task("synthetic"), jscfg, n=12, seed=4,
                          adaptive=jad)
    assert (got.task, got.n, got.accuracy, got.total_gen_tokens,
            got.gen_tokens_per_doc, got.correct) == \
        (want.task, want.n, want.accuracy, want.total_gen_tokens,
         want.gen_tokens_per_doc, want.correct)
    assert [r.answer for r in got.results] == \
        [r.answer for r in want.results]
    assert [_tree_shape(r) for r in got.results] == \
        [_tree_shape(r) for r in want.results]


def test_arithmetic_docs_equal_reference():
    got = get_task("arithmetic", n_ops=3).docs(6, seed=9)
    want = jeval.get_task("arithmetic", n_ops=3).docs(6, seed=9)
    assert [(d.prompt, d.gold, d.meta) for d in got] == \
        [(d.prompt, d.gold, d.meta) for d in want]


def test_evaluate_method_and_cost_model_equal_reference():
    """``evaluate_method`` on the synthetic task and the memory-op cost
    model over a recorded search, as ``benchmarks/fig2_proxy_metrics.py``
    drives them."""
    ets_kw = dict(lambda_b=2.0, lambda_d=1.0)
    tscfg = SearchConfig(method="ets", width=16, ets=ETSConfig(**ets_kw))
    jscfg = jcore.SearchConfig(method="ets", width=16,
                               ets=jcore.ETSConfig(**ets_kw))
    assert evaluate_method(tscfg, n_problems=4, seed=11) == \
        jcore.evaluate_method(jscfg, n_problems=4, seed=11)
    hw_kw = dict(model_bytes=2 * 34e9, kv_bytes_per_token=2 * 48 * 2 * 8
                 * 128 * 2 * 5)
    tprob = SyntheticProblem(SyntheticTaskConfig(), seed=7000)
    jprob = jcore.SyntheticProblem(jcore.SyntheticTaskConfig(), seed=7000)
    tres = run_search(tprob, tscfg, tree=tprob.make_tree())
    jres = jcore.run_search(jprob, jscfg, tree=jprob.make_tree())
    assert tres.tree.kv_trace == jres.tree.kv_trace
    for tree_attention in (True, False):
        got = simulate_search_cost(tres.tree.kv_trace, HardwareModel(**hw_kw),
                                   tree_attention=tree_attention)
        want = jcore.simulate_search_cost(
            jres.tree.kv_trace, jcore.HardwareModel(**hw_kw),
            tree_attention=tree_attention)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
