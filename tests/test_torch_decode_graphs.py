"""The decode runner (``serving.engine.DecodeRunner``), on the CPU.

Every engine decodes through the runner's static operand buffers.  A
stand-in capture records the forward and replays it by calling it, so
the buffers, the shape keys and the counters are held here, where the
card's graphs cannot run: every iteration's logits and tokens equal the
eager engine's bit for bit, with every static buffer poisoned before
each refresh (so no entry of an earlier iteration, a pad entry of a
larger tree included, can survive), over tree buckets that grow, are
replayed out of capture order and shrink within a bucket; one capture
per key.  A 1-device-mesh engine's eager runner holds the same under
poisoned buffers.  Engines off the card, on a mesh or under the
expert-parallel MoE path never capture.  The tree wrapper's device live
count is checked as an operand.  The card's graphs themselves are held
to the eager runner by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config, tiny_variant
from repro_torch.kernels import ops
from repro_torch.kernels.ref import tree_attention_ref
from repro_torch.kvcache import build_tree_metadata
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as MOE
from repro_torch.models.model import build_model
from repro_torch.serving import EngineConfig, PagedEngine
from repro_torch.serving.engine import DecodeRunner

ARCHS = ["qwen2-vl-7b", "deepseek-moe-16b", "zamba2-7b"]


def _engine(arch, mode, seed=0, mesh=None):
    cfg = tiny_variant(get_config(arch))
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(seed))
    return PagedEngine(model, params, EngineConfig(
        n_pages=96, page_size=4, max_batch=8, max_seq_len=128,
        attention=mode, trace_logits=True, mesh=mesh), device="cpu")


class StandIn:
    """``capture(fn)`` records ``fn`` and replays it by calling it."""

    def __init__(self):
        self.recorded = []

    def __call__(self, fn):
        self.recorded.append(fn)
        return fn


def _poison(engine):
    """Every static buffer of ``engine``'s runner poisoned before each
    refresh; returns (keys put in order, live counts put in order)."""
    runner = engine.runner
    put, keys, lives = runner.put, [], []

    def poisoned_put(eng, rows, attn):
        bufs = list(runner.rows.values())
        for entry in runner._keys.values():
            bufs += entry["attn"].values()
        for b in bufs:
            b.fill_(True if b.dtype == torch.bool else 7)
        keys.append(put(eng, rows, attn))
        if "n_live" in attn:
            lives.append(int(attn["n_live"][0]))
        return keys[-1]

    runner.put = poisoned_put
    return keys, lives


def _install(engine):
    """A stand-in capture on ``engine``'s runner, its buffers poisoned
    (``_poison``); returns (stand-in, keys, live counts)."""
    stand_in = StandIn()
    engine.runner = DecodeRunner(stand_in)
    return (stand_in,) + _poison(engine)


def _drive(engine, vocab):
    """Two short prompts' rows decode throughout (budgets 40, 30 and 24); a
    long prompt's four rows join at iteration 8, two for 4 tokens and two
    for 8, and two more at iteration 20 for 3, so the tree's page list
    grows into larger buckets and returns to them, and shrinks within a
    bucket as rows finish.  Returns (tokens by row, iterations)."""
    rng = np.random.default_rng(5)
    short = [list(map(int, rng.integers(0, vocab, n))) for n in (5, 9)]
    long = list(map(int, rng.integers(0, vocab, 70)))
    a, b, c = engine.prefill_many(short + [long])
    stream = engine.open_stream(temperature=0.0)
    keys = np.arange(16, dtype=np.uint32).reshape(8, 2)
    stream.add(engine.branch(a, 2), keys[:2], 40)
    rows_b = engine.branch(b, 2)
    stream.add(rows_b[:1], keys[2:3], 30)
    stream.add(rows_b[1:], keys[3:4], 24)
    it = 0
    while stream.live:
        if it == 8:
            stream.add(engine.branch(c, 2), keys[4:6], 4)
            stream.add(engine.branch(c, 2), keys[6:], 8)
        if it == 20:
            stream.add(engine.branch(c, 2), keys[4:6], 3)
        stream.step()
        it += 1
    return stream.out, it


@pytest.mark.parametrize("mode", ["paged", "tree"])
@pytest.mark.parametrize("arch", ARCHS)
def test_stand_in_replay_matches_eager_bitwise(arch, mode):
    eager, graphed = _engine(arch, mode), _engine(arch, mode)
    stand_in, keys, lives = _install(graphed)
    vocab = eager.cfg.vocab_size
    (out_e, n), (out_g, n_g) = _drive(eager, vocab), _drive(graphed, vocab)
    assert n == n_g >= 32
    assert out_e == out_g
    assert len(eager.logits_trace) == len(graphed.logits_trace)
    for x, y in zip(eager.logits_trace, graphed.logits_trace):
        np.testing.assert_array_equal(x, y)
    distinct = list(dict.fromkeys(keys))
    assert graphed.n_decode_graph_captures == len(distinct) \
        == len(stand_in.recorded)
    assert graphed.n_decode_graph_replays == n - len(distinct)
    assert eager.n_decode_graph_captures == eager.n_decode_graph_replays == 0
    if mode == "paged":
        assert len(distinct) == 1
    else:
        # the bucket grew; a key replayed after one captured later; the
        # live count fell within a bucket after a larger tree
        sizes = [dict(k)["page_list"][0] for k in keys]
        assert len(distinct) >= 2
        first = {s: sizes.index(s) for s in sizes}
        assert any(first[sizes[i]] < first[sizes[i - 1]]
                   for i in range(1, len(sizes)))
        assert any(sizes[i] == sizes[i - 1] and lives[i] < lives[i - 1]
                   and max(sizes[:i]) > sizes[i]
                   for i in range(1, len(sizes)))
    for e in (eager, graphed):
        e.reset()
        e.alloc.check_invariants()


def test_stand_in_replays_count_in_the_tracer():
    """``decode.graph_replays`` and ``decode.graph_captures`` read the
    engine's counters; the ``decode`` span says whether a graph ran."""
    engine = _engine("qwen2-vl-7b", "tree")
    _install(engine)
    tracing.enable()
    tracing.reset()
    try:
        _, n = _drive(engine, engine.cfg.vocab_size)
        snap = tracing.snapshot()
    finally:
        tracing.disable()
    c = snap["counters"]
    assert c["decode.iters"] == n
    assert c["decode.graph_captures"] == engine.n_decode_graph_captures >= 2
    assert c["decode.graph_replays"] == n - c["decode.graph_captures"]
    spans = [s for s in snap["spans"] if s.name == "decode"]
    assert len(spans) == n and all(s.attrs["graph"] == 1 for s in spans)


def test_off_the_card_and_under_expert_parallel_moe_no_graph_runs():
    """A CPU engine's runner captures nothing, and a runner with a
    capture runs the forward eagerly while ``moe.MESH`` is set (the
    expert-parallel MoE path's collectives), through the same static
    buffers: the counters stay 0.  The model is dense, so nothing in
    its forward reads the sentinel mesh."""
    eager, engine = (_engine("qwen2-vl-7b", "tree") for _ in range(2))
    assert eager.runner.capture is None and not eager.runner.graphed
    stand_in, keys, _ = _install(engine)
    saved, MOE.MESH = MOE.MESH, object()
    try:
        assert not engine.runner.graphed
        outs = [_drive(e, e.cfg.vocab_size) for e in (eager, engine)]
    finally:
        MOE.MESH = saved
    assert outs[0] == outs[1]
    assert not stand_in.recorded and len(set(keys)) >= 2
    for e in (eager, engine):
        assert e.n_decode_graph_captures == e.n_decode_graph_replays == 0


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh(device="cpu")


@pytest.mark.parametrize("mode", ["paged", "tree"])
def test_mesh_engine_decodes_through_poisoned_static_buffers(mesh, mode):
    """A 1-device-mesh engine's runner, every buffer poisoned before each
    refresh, gives the mesh-less engine's tokens and logits bit for bit;
    its buffers are placed once per shape with no fallback, and it
    captures nothing."""
    plain, meshed = _engine("qwen2-vl-7b", mode), \
        _engine("qwen2-vl-7b", mode, mesh=mesh)
    keys, _ = _poison(meshed)
    vocab = plain.cfg.vocab_size
    (out_p, n), (out_m, n_m) = _drive(plain, vocab), _drive(meshed, vocab)
    assert n == n_m >= 32 and len(keys) == n
    assert out_p == out_m
    assert len(plain.logits_trace) == len(meshed.logits_trace)
    for x, y in zip(plain.logits_trace, meshed.logits_trace):
        np.testing.assert_array_equal(x, y)
    assert meshed.shard_fallbacks == []
    assert not meshed.runner.graphed
    assert meshed.n_decode_graph_captures == meshed.n_decode_graph_replays \
        == 0
    meshed.reset()
    meshed.alloc.check_invariants()


def _tree_operands(dev="cpu"):
    rng = np.random.default_rng(2)
    B, H, K, hd, S, P = 4, 4, 2, 32, 8, 16
    q, kp, vp = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
                 for s in ((B, H, hd), (P, S, K, hd), (P, S, K, hd)))
    meta = build_tree_metadata([[3, 4], [3, 5], [3, 6, 7], []],
                               [14, 12, 19, 0], S, pad_page=P - 1,
                               check=True)
    return (q, kp, vp) + tuple(torch.as_tensor(a) for a in (
        meta.page_list, meta.page_mask, meta.page_lens)), meta.n_unique


@pytest.mark.parametrize("bad,err", [
    (lambda n: torch.tensor([n], dtype=torch.int64), TypeError),
    (lambda n: torch.tensor([n, n], dtype=torch.int32), ValueError),
    (lambda n: torch.tensor(n, dtype=torch.int32), ValueError),
    (lambda n: torch.empty(1, dtype=torch.int32, device="meta"), ValueError),
    (lambda n: n, TypeError),
], ids=["int64", "shape-2", "scalar", "other-device", "host-int"])
def test_tree_wrapper_checks_the_device_live_count(bad, err):
    args, n = _tree_operands()
    with pytest.raises(err, match="n_live"):
        ops.tree_attention(*args, scale=0.2, n_live=bad(n))


def test_tree_wrapper_takes_a_device_live_count():
    """A (1,) int32 count on q's device: the plain version's result (the
    entries past the count are dump entries, inert either way)."""
    args, n = _tree_operands()
    torch.testing.assert_close(
        ops.tree_attention(*args, scale=0.2,
                           n_live=torch.tensor([n], dtype=torch.int32)),
        tree_attention_ref(*args, scale=0.2), rtol=0, atol=0)


def test_collect_keeps_counts_out_of_the_counters():
    """Inside ``collect`` every count goes to its list, tracing on or
    off, and the counters see none; ``on`` comes back as it was."""
    for was in (False, True):
        (tracing.enable if was else tracing.disable)()
        tracing.reset()
        try:
            with tracing.collect() as got:
                assert tracing.on
                tracing.count("a", 2)
                tracing.count("b", torch.tensor(3))
            assert tracing.on is was
            assert [(k, int(v)) for k, v in got] == [("a", 2), ("b", 3)]
            tracing.count("a", 1)
            assert tracing.snapshot()["counters"].get("a") == (
                1 if was else None)
        finally:
            tracing.disable()
