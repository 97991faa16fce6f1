"""The port's paged engine against ``repro``'s ``PagedEngine`` on the
CPU: the same prompts through ``prefill_many``, ``branch`` and greedy or
sampled ``decode`` give the same tokens, float32-allclose logits and the
same unique/logical page counters, in both attention modes.  A bfloat16
configuration decodes at bfloat16, as it prefills: no parameter is cast
to float32 but the norms and the MoE router, and decode's logits equal
the engine's own prefill's; a float32 one decodes bit for bit as a
float32 stream."""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
from _torch_stack import make_stacks
from torch.overrides import TorchFunctionMode

from repro.kvcache import KVPool as JaxKVPool
from repro.kvcache.allocator import CopyOp as JaxCopyOp
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import PagedEngine as JaxEngine

from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.kvcache import KVPool
from repro_torch.kvcache.allocator import CopyOp
from repro_torch.models.model import (build_model, tree_map,
                                      tree_map_with_path)
from repro_torch.serving import EngineConfig, PagedEngine
from repro_torch.serving.runtimes import DecodeCtx

LOGIT_TOL = 1e-4     # float32 logits; the two packages sum in other orders
# bfloat16 logits computed in two orders (decode against prefill, or the
# card against the CPU): 8 units of bf16 rounding (2**-8) at the largest
# logit, as each side rounds its stream once per op
BF16_TOL = 8 * 2.0 ** -8


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


def _tiny_cfg(kind, dtype):
    """A 2-layer tiny LM, dense or MoE (dropless: 4 experts, top 2, one
    shared), at ``dtype``."""
    cfg = dataclasses.replace(get_config("tiny-lm"), n_layers=2, d_model=128,
                              d_ff=256, dtype=dtype)
    if kind == "moe":
        cfg = dataclasses.replace(
            cfg, name="tiny-moe", arch_type="moe", moe=MoEConfig(
                n_experts=4, n_shared_experts=1, top_k=2, d_expert=64,
                capacity_factor=4.0))
    return cfg


def _tiny_engine(kind, dtype, mode, params_dtype=None):
    """An engine on the CPU whose params are the init cast to
    ``params_dtype`` (the configuration's dtype by default), as served."""
    model = build_model(_tiny_cfg(kind, dtype), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    pdt = params_dtype or model.compute_dtype
    params = tree_map(lambda a: a.to(pdt) if a.is_floating_point() else a,
                      params)
    return PagedEngine(model, params, EngineConfig(
        n_pages=64, page_size=8, max_batch=8, max_seq_len=64,
        attention=mode, trace_logits=True), device="cpu")


class _ParamCasts(TorchFunctionMode):
    """Records the parameters cast to float32 (by leaf path, views
    included: a layer's slice shares its stacked leaf's storage) and the
    operand dtypes of every ``torch.bmm``."""

    CASTS = (torch.Tensor.to, torch.Tensor.float, torch.Tensor.type)

    def __init__(self, params):
        super().__init__()
        self.paths = {}
        tree_map_with_path(lambda path, a: self.paths.setdefault(
            a.untyped_storage().data_ptr(), path), params)
        self.cast, self.bmm = set(), []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in self.CASTS and isinstance(out, torch.Tensor) \
                and out.dtype == torch.float32 \
                and args[0].dtype != torch.float32:
            path = self.paths.get(args[0].untyped_storage().data_ptr())
            if path is not None:
                self.cast.add(path)
        if func is torch.bmm:
            self.bmm.append((args[0].dtype, args[1].dtype))
        return out


def _float32_kept(path):
    """Leaves that compute in float32 at any dtype: norm weights, the MoE
    router."""
    leaf = path.rsplit("/", 1)[-1]
    return leaf.startswith("ln") or leaf.endswith("_norm") or leaf == "router"


@pytest.mark.parametrize("mode", ["paged", "tree"])
@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_bf16_decode_casts_no_weight_to_float32(kind, mode):
    """A bfloat16 engine's decode copies no weight matrix, expert bank or
    embedding table to float32: the projections, FFNs, expert ``bmm``s and
    head take bf16 operands."""
    e = _tiny_engine(kind, "bfloat16", mode)
    sid = e.prefill(_prompts(e.cfg.vocab_size, [11])[0])
    ids = e.branch(sid, 3)
    with _ParamCasts(e.params) as spy:
        e.decode(ids, 3, key=0, temperature=1.0)
    assert {p for p in spy.cast if not _float32_kept(p)} == set()
    if kind == "moe":
        assert spy.bmm and set(spy.bmm) == {(torch.bfloat16,
                                             torch.bfloat16)}
        assert any(p.endswith("router") for p in spy.cast)


@pytest.mark.parametrize("mode", ["paged", "tree"])
@pytest.mark.parametrize("kind,params_dtype", [
    pytest.param("dense", None, id="dense"),
    pytest.param("moe", None, id="moe"),
    pytest.param("dense", torch.float32, id="dense-float32-params"),
    pytest.param("moe", torch.float32, id="moe-float32-params")])
def test_bf16_decode_logits_match_own_prefill(kind, params_dtype, mode):
    """Each branch's logits at its second decoded token equal the same
    engine's prefill of the prompt extended by the tokens it decoded:
    decode writes and reads the pool as prefill does.  On bf16 params,
    as served, within bf16 rounding; on float32 master params within
    float32's, as both streams turn float32 at the first projection
    after the bf16 embedding rows (no bf16 rounding of layer 0's
    attention output in decode alone)."""
    e = _tiny_engine(kind, "bfloat16", mode, params_dtype)
    prompt = _prompts(e.cfg.vocab_size, [13])[0]
    ids = e.branch(e.prefill(prompt), 4)
    out = e.decode(ids, 2, key=0, temperature=1.0)
    dec = e.logits_trace[-1][:len(ids)]
    n = len(e.logits_trace)
    e.prefill_many([prompt + out[i] for i in ids])
    assert len(e.logits_trace) == n + 1
    pre = e.logits_trace[-1][:len(ids)]
    assert len({tuple(t) for t in out.values()}) > 1
    tol = BF16_TOL * np.abs(pre).max() if params_dtype is None \
        else LOGIT_TOL
    np.testing.assert_allclose(dec, pre, rtol=0, atol=tol)


@pytest.mark.parametrize("mode", ["paged", "tree"])
def test_bf16_decode_matches_float32_reference(stacks, mode):
    """A bfloat16 engine's logits, at prefill and at every greedy decode
    step, equal within bf16 rounding ``repro``'s engine decoding in
    float32 on the same (bf16-representable) params: an independent
    check of the port's model layer at bf16.  A row is compared while
    its tokens agree with the reference's; where they part, the port's
    token scores within the tolerance of the reference's best (a near
    tie that rounding breaks the other way)."""
    (jlm, jp), _, _ = stacks[0]
    (tlm, tp), _, _ = stacks[1]
    # the reference's params rounded to bf16 values, kept in float32
    jp = jax.tree.map(lambda a: jax.numpy.asarray(a, jax.numpy.bfloat16)
                      .astype(jax.numpy.float32), jp)
    tlm = build_model(dataclasses.replace(tlm.cfg, dtype="bfloat16"),
                      device="cpu")
    tp = tlm.cast_params(tp)
    ekw = dict(n_pages=96, page_size=8, max_batch=8, max_seq_len=96,
               attention=mode, trace_logits=True)
    je = JaxEngine(jlm, jp, JaxEngineConfig(**ekw))
    te = PagedEngine(tlm, tp, EngineConfig(**ekw), device="cpu")
    prompts = _prompts(je.cfg.vocab_size, [13, 5, 21], seed=2)
    sids = je.prefill_many(prompts)
    assert te.prefill_many(prompts) == sids
    ids = [e.branch(sids[0], 3) + e.branch(sids[2], 2) for e in (je, te)]
    assert ids[0] == ids[1]
    ids = ids[1]
    jout = je.decode(ids, 6, key=jax.random.key(0), temperature=0.0)
    tout = te.decode(ids, 6, key=0, temperature=0.0)
    ref, got = je.logits_trace, te.logits_trace
    assert len(ref) == len(got) == 7
    np.testing.assert_allclose(got[0], ref[0], rtol=0,
                               atol=BF16_TOL * np.abs(ref[0]).max())
    compared = 0
    for t, (a, b) in enumerate(zip(ref[1:], got[1:])):
        for j, i in enumerate(ids):
            if jout[i][:t] != tout[i][:t]:
                continue            # the rows' inputs differ from here on
            tol = BF16_TOL * np.abs(a[j]).max()
            np.testing.assert_allclose(b[j], a[j], rtol=0, atol=tol)
            assert a[j, tout[i][t]] >= a[j].max() - tol
            compared += 1
    assert compared >= 4 * len(ids)


def _float32_stream_decode_step(self, tokens, lengths, pages, slots, active,
                                srows, attend):
    """The engine's decode body with the stream forced to float32: the
    whole embedding table cast, then its rows looked up."""
    x = self.params["embed"].float()[tokens][:, None]
    ctx = DecodeCtx(lengths=lengths, pages=pages, slots=slots,
                    attend=attend, state_rows=srows)
    for rt in self.runtimes:
        x = rt.decode_step(self.params, x, ctx, self.pool.k, self.pool.v,
                           self._state_in())
    logits = self.model.logits(self.params, x[:, 0])
    return torch.where(active[:, None], logits, 0.0)


@pytest.mark.parametrize("params_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["paged", "tree"])
def test_float32_config_decodes_bit_identically(mode, params_dtype):
    """A float32 configuration's decode equals a float32 stream bit for
    bit, on float32 params and on bf16 params alike (the rows looked up
    then cast equal the table cast then looked up)."""
    runs = []
    for forced in (False, True):
        e = _tiny_engine("dense", "float32", mode, params_dtype)
        if forced:
            e._decode_step = types.MethodType(_float32_stream_decode_step, e)
        sids = e.prefill_many(_prompts(e.cfg.vocab_size, [13, 6], seed=4))
        ids = e.branch(sids[0], 3) + e.branch(sids[1], 2)
        runs.append((e.decode(ids, 5, key=1, temperature=1.0),
                     e.logits_trace))
    assert runs[0][0] == runs[1][0]
    assert len(runs[0][1]) == len(runs[1][1]) == 6
    for a, b in zip(runs[0][1], runs[1][1]):
        assert a.dtype == np.float32 and np.array_equal(a, b)
