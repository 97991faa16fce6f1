"""The port's tracer (``repro_torch.tracing``): off it records nothing and
changes nothing; on, its spans nest as the serving loop runs, the
``decode`` span names its stream's dtype, and its counters equal what
the program computes (the PRM's bucket, the MoE's dispatch plan, the
decode step's copy-on-write pages)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.core import ETSConfig, Request, SearchConfig, ServingConfig
from repro_torch.core import ServingLoop
from repro_torch.models import moe
from repro_torch.models.model import build_model
from repro_torch.serving import (BackendConfig, EngineConfig, LMBackend,
                                 PagedEngine)

STEP, EOS = 10, 11
PROMPTS = [list(map(int, np.random.default_rng(i).integers(12, 64, n)))
           for i, n in enumerate((13, 21, 9))]


@pytest.fixture(autouse=True)
def tracer_off_after():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _moe_cfg(capacity_factor):
    return dataclasses.replace(
        get_config("tiny-lm"), name="tiny-moe", arch_type="moe", n_layers=1,
        d_model=64, d_ff=128, moe=MoEConfig(
            n_experts=4, n_shared_experts=1, top_k=2, d_expert=32,
            capacity_factor=capacity_factor))


@pytest.fixture(scope="module")
def models():
    """(lm, prm, embedder) and their params: a dense LM, a MoE PRM whose
    capacity drops replicas, an encoder."""
    cfgs = [dataclasses.replace(get_config("tiny-lm"), n_layers=1,
                                d_model=64, d_ff=128),
            _moe_cfg(0.5),
            dataclasses.replace(get_config("tiny-embedder"), n_layers=1,
                                d_model=32, d_ff=64)]
    out = []
    for i, cfg in enumerate(cfgs):
        m = build_model(cfg, with_value_head=i == 1, device="cpu")
        out.append((m, m.init(torch.Generator().manual_seed(i))))
    return out


def _backend(models):
    (lm, lp), (prm, pp), (emb, ep) = models
    engine = PagedEngine(lm, lp, EngineConfig(
        n_pages=256, page_size=8, max_batch=8, max_seq_len=96,
        attention="tree"), device="cpu")
    return LMBackend(engine, prm, pp, emb, ep, BackendConfig(
        step_token=STEP, eos_token=EOS, max_step_tokens=6, max_depth=4),
        answer_fn=lambda toks: None, seed=7, device="cpu")


def _serve(backend):
    """A tiny ETS run through the serving loop's token-level refill."""
    scfg = SearchConfig(method="ets", width=4, max_steps=3,
                        ets=ETSConfig(lambda_b=1.0, lambda_d=1.0,
                                      cluster_threshold=0.2))
    loop = ServingLoop(backend, scfg, [Request(prompt=p) for p in PROMPTS],
                       max_live=2, cfg=ServingConfig(refill=True))
    return loop.run()


def _view(results):
    return [[(n.id, n.parent, n.n_tokens, n.finished, n.reward,
              (n.payload or {}).get("tokens")) for n in r.tree.nodes]
            + [r.tree.decode_trace, r.tree.kv_trace, r.steps]
            for r in results]


def _traced_run(models):
    backend = _backend(models)
    tracing.enable()
    results = _serve(backend)
    tracing.disable()
    return backend, results, tracing.snapshot()


def test_off_records_nothing(models):
    _serve(_backend(models))
    snap = tracing.snapshot()
    assert snap["spans"] == [] and snap["dropped"] == 0
    # no counter of the tracer's own, so no MoE device sum was made
    assert not any(k.startswith(("moe.", "prm."))
                   for k in snap["counters"])
    assert tracing._counts == {}


def test_on_and_off_serve_identically(models):
    off = _view(_serve(_backend(models)))
    _, results, snap = _traced_run(models)
    assert snap["spans"]
    assert _view(results) == off


def test_spans_nest(models):
    _, _, snap = _traced_run(models)
    spans = snap["spans"]
    by_id = {s.id: s for s in spans}
    names = {s.name for s in spans}
    assert {"tick", "prefill", "decode", "prm", "embed", "select", "step",
            "step.rows"} <= names

    def inside(s, outer):
        return outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns

    def ancestors(s):
        while s.parent is not None:
            s = by_id[s.parent]
            yield s

    phases = [s for s in spans if s.name.startswith("decode.")]
    assert {s.name for s in phases} == {
        "decode.alloc", "decode.rows", "decode.meta", "decode.count",
        "decode.put", "decode.forward", "decode.sample", "decode.book"}
    for s in phases:
        parent = by_id[s.parent]
        assert parent.name == "decode" and inside(s, parent)
    for s in spans:
        if s.name in ("decode", "prm", "embed", "select"):
            ticks = [a for a in ancestors(s) if a.name == "tick"]
            assert len(ticks) == 1 and inside(s, ticks[0]), s
    for s in spans:
        if s.name == "decode":
            laps = sorted((p for p in phases if p.parent == s.id),
                          key=lambda p: p.start_ns)
            assert s.attrs["rows"] > 0
            assert [p.name for p in laps] == [
                "decode.alloc", "decode.rows", "decode.meta", "decode.count",
                "decode.put", "decode.forward", "decode.sample",
                "decode.book"]
            assert all(a.end_ns == b.start_ns for a, b in zip(laps, laps[1:]))
    # one problem's step spans tile its life: each opens where the last
    # closed, the first at its prefill's end; its rows lie inside them
    steps, rows = {}, {}
    for s in spans:
        if s.name == "step":
            steps.setdefault(s.attrs["ns"], []).append(s)
        elif s.name == "step.rows":
            rows.setdefault(s.attrs["ns"], []).append(s)
    assert len(steps) == len(PROMPTS)
    prefills = [s for s in spans if s.name == "prefill"]
    for ns, ss in steps.items():
        ss.sort(key=lambda s: s.start_ns)
        assert [s.attrs["step"] for s in ss] == list(range(1, len(ss) + 1))
        assert any(inside(ss[0], p) or p.start_ns <= ss[0].start_ns
                   <= p.end_ns for p in prefills)
        assert all(a.end_ns == b.start_ns for a, b in zip(ss, ss[1:]))
        for r in rows.get(ns, []):
            assert sum(inside(r, s) for s in ss) == 1
    for s in spans:
        if s.name == "select":
            assert s.attrs["ns"] in steps


def test_prm_counters_equal_the_bucket(models):
    backend = _backend(models)
    seen = {"slots": 0, "valid": 0}
    reward = backend.prm_model.reward

    def counted(params, batch):
        seen["slots"] += batch["tokens"].numel()
        seen["valid"] += int((batch["positions"] >= 0).sum())
        return reward(params, batch)
    backend.prm_model.reward = counted
    tracing.enable()
    _serve(backend)
    counters = tracing.snapshot()["counters"]
    assert seen["slots"] > seen["valid"] > 0
    assert counters["prm.slots"] == seen["slots"]
    assert counters["prm.valid"] == seen["valid"]
    # the PRM's drops were counted under its config's name
    assert counters["moe.routed/tiny-moe"] > 0


@pytest.mark.parametrize("capacity_factor,drops", [(0.5, True),
                                                   (4.0, False)])
def test_moe_counters_equal_the_dispatch_plan(capacity_factor, drops):
    cfg = _moe_cfg(capacity_factor)
    g = torch.Generator().manual_seed(3)
    p = moe.moe_init(g, cfg)
    x = torch.randn(48, cfg.d_model, generator=g)
    tracing.enable()
    moe.moe_apply(p, x, cfg)
    counters = tracing.snapshot()["counters"]
    _, idx, _ = moe.route(p["router"], x, cfg)
    C = moe._capacity(cfg, x.shape[0] * cfg.moe.top_k, 0)
    keep = moe.dispatch_plan(idx, cfg.moe.n_experts, C)[3]
    dropped = int((~keep).sum())
    assert counters["moe.routed/tiny-moe"] == keep.numel()
    assert counters["moe.dropped/tiny-moe"] == dropped
    assert (dropped > 0) == drops


@pytest.mark.parametrize("dtype,cast,reads", [
    pytest.param("float32", True, "float32", id="float32"),
    pytest.param("bfloat16", True, "bfloat16", id="bfloat16"),
    pytest.param("bfloat16", False, "float32",
                 id="bfloat16-float32-params")])
def test_decode_span_names_the_stream_dtype(models, dtype, cast, reads):
    """Each ``decode`` span carries the dtype its stream ends in: the
    configuration's on params cast to it, float32 where float32 params
    promote a bfloat16 configuration's stream."""
    lm, params = models[0]
    lm = build_model(dataclasses.replace(lm.cfg, dtype=dtype), device="cpu")
    eng = PagedEngine(lm, lm.cast_params(params) if cast else params,
                      EngineConfig(
        n_pages=64, page_size=8, max_batch=4, max_seq_len=64,
        attention="tree"), device="cpu")
    kids = eng.branch(eng.prefill(PROMPTS[0]), 2)
    tracing.enable()
    eng.decode(kids, 3, key=0)
    spans = [s for s in tracing.snapshot()["spans"] if s.name == "decode"]
    assert len(spans) == 3
    assert {s.attrs["dtype"] for s in spans} == {reads}


def test_cow_pages_equal_the_copy_ops(models):
    backend = _backend(models)
    eng = backend.engine
    ops = []
    append = eng.alloc.append_tokens

    def appended(seq_id, n):
        out = append(seq_id, n)
        ops.extend(out)
        return out
    eng.alloc.append_tokens = appended
    sid = eng.prefill(PROMPTS[0])       # 13 tokens: a part-filled page
    kids = eng.branch(sid, 3)
    tracing.enable()
    tracing.reset()
    before = eng.n_cow_pages
    eng.decode(kids, 2, key=0)
    assert len(ops) > 0
    assert eng.n_cow_pages - before == len(ops)
    assert tracing.snapshot()["counters"]["kv.cow_pages"] == len(ops)


def test_span_shares_the_profilers_clock():
    a, b = torch.randn(256, 256), torch.randn(256, 256)
    prof = torch.profiler
    tracing.enable()
    with prof.profile(activities=[prof.ProfilerActivity.CPU]) as p:
        with tracing.span("mm"):
            torch.mm(a, b)
    (s,) = tracing.snapshot()["spans"]
    mm = [e for e in p.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert len(mm) == 1
    e = mm[0]
    assert s.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() \
        <= s.end_ns


def test_records_past_the_cap_are_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 3)
    tracing.enable()
    for i in range(5):
        with tracing.span("s", i=i):
            pass
    snap = tracing.snapshot()
    assert [s.attrs["i"] for s in snap["spans"]] == [0, 1, 2]
    assert snap["dropped"] == 2
