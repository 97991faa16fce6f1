"""Meshes on the port's engine, and the dense-prefill oracle, on the CPU.

  * ``make_host_mesh``: the model=1 fast path and the divisibility guard
    (``tests/test_mesh.py:40-60``); ``check_mesh_compat`` refuses a
    multi-device mesh with kernels only;
  * a 1-device-mesh engine gives the mesh-less engine's trees in both
    attention modes, with its pool and row operands placed by the serve
    policy and the fallbacks recorded (the reference's own 1-device
    mesh test fails under its jax, so the mesh-less port engine is the
    oracle); a larger mesh on the plain path is refused;
  * ``EngineConfig(prefill="dense")``: flash prefill against the dense
    oracle — pool K/V, prefill logits, sampled streams, full ETS trees
    in both modes (``tests/test_prefill.py:57-133``) — the dense oracle
    against the reference's, and its refusal together with streamed
    prefill (``tests/test_engine_validation.py:47-50``);
  * ``launch.serve --mesh 1`` serves a workload to its end.
"""
import numpy as np
import pytest
import torch.distributed as dist
from _torch_stack import make_stacks

from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import PagedEngine as JaxEngine

from repro_torch.core import ETSConfig, SearchConfig, run_search, \
    run_search_many
from repro_torch.kernels.ops import check_mesh_compat
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import batch_axes, make_host_mesh
from repro_torch.serving import (BackendConfig, EngineConfig, LMBackend,
                                 PagedEngine)

ENGINE_KW = dict(n_pages=256, page_size=8, max_batch=16, max_seq_len=128)
VOCAB = 20                      # the arithmetic task's (``_torch_stack``)


def _prompt(n, start=4):
    return [start + i % (VOCAB - start) for i in range(n)]


LM_PROMPTS = [_prompt(n) for n in (17, 23, 9)]
LM_SCFG = SearchConfig(method="ets", width=4, max_steps=2,
                       ets=ETSConfig(lambda_b=1.0, lambda_d=1.0,
                                     cluster_threshold=0.2))


@pytest.fixture(scope="module")
def stacks():
    return make_stacks(seed=3)


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh(device="cpu")


class FakeBigMesh:
    """What the engine and the guard read of a 4-device mesh."""
    device_type = "cpu"
    ndim = 2
    mesh_dim_names = ("data", "model")
    shape = (4, 1)

    def size(self, dim=None):
        return 4 if dim is None else self.shape[dim]


# ---------------------------------------------------------------------------
# make_host_mesh and the kernel seam's guard
# ---------------------------------------------------------------------------

def test_make_host_mesh_model1_fast_path(mesh):
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (dist.get_world_size(), 1)
    assert mesh.device_type == "cpu"
    assert batch_axes(mesh) == ("data",)


def test_make_host_mesh_rejects_nondivisible_model(mesh):
    bad = dist.get_world_size() + 1
    with pytest.raises(ValueError, match="must be >= 1 and divide"):
        make_host_mesh(model=bad, device="cpu")
    with pytest.raises(ValueError, match="must be >= 1 and divide"):
        make_host_mesh(model=0, device="cpu")


def test_check_mesh_compat_guards_kernel_path(mesh):
    check_mesh_compat(None, use_kernel=True)             # no mesh: fine
    check_mesh_compat(FakeBigMesh(), use_kernel=False)   # plain path: fine
    check_mesh_compat(mesh, use_kernel=True)             # 1 device: fine
    with pytest.raises(ValueError, match="shard_map"):
        check_mesh_compat(FakeBigMesh(), use_kernel=True)


# ---------------------------------------------------------------------------
# 1-device mesh == mesh-less engine
# ---------------------------------------------------------------------------

def _backend(stacks, attention="tree", **ekw):
    (lm, lp), (prm, pp), (emb, ep) = stacks[1]
    engine = PagedEngine(lm, lp, EngineConfig(
        attention=attention, **{**ENGINE_KW, "max_batch": 32, **ekw}),
        device="cpu")
    return engine, LMBackend(engine, prm, pp, emb, ep,
                             BackendConfig(step_token=2, eos_token=3,
                                           max_step_tokens=6, max_depth=4),
                             answer_fn=lambda full: None, seed=13,
                             device="cpu")


def _view(res):
    return [(n.id, n.parent, n.n_tokens, n.finished, n.reward,
             (n.payload or {}).get("tokens")) for n in res.tree.nodes]


@pytest.mark.parametrize("attention", ["tree", "paged"])
def test_one_device_mesh_gives_the_meshless_trees(stacks, mesh, attention):
    _, base = _backend(stacks, attention)
    want = run_search_many(base, LM_SCFG, LM_PROMPTS)
    engine, backend = _backend(stacks, attention, mesh=mesh)
    got = run_search_many(backend, LM_SCFG, LM_PROMPTS)
    assert [_view(r) for r in got] == [_view(r) for r in want]
    assert [r.answer for r in got] == [r.answer for r in want]
    # the pool sits on the mesh, pages on "model"; on one device no rule
    # falls back
    k_dt, _ = engine.pool_dtensors
    assert k_dt.device_mesh == mesh
    assert k_dt.to_local().data_ptr() == engine.pool.k.data_ptr()
    assert engine.pool_placements[1].is_shard(1)
    assert engine.shard_fallbacks == []
    engine.alloc.check_invariants()


@pytest.mark.parametrize("attention", ["tree", "paged"])
def test_mesh_and_cpu_engines_never_capture_the_decode(stacks, mesh,
                                                       attention):
    """The decode forward is captured only on a card without a mesh
    (``serving.engine.DecodeRunner``): these engines' runners run it
    eagerly."""
    for m in (None, mesh):
        engine, backend = _backend(stacks, attention, mesh=m)
        run_search_many(backend, LM_SCFG, LM_PROMPTS[:1])
        assert engine.runner.capture is None and engine.n_decode_steps > 0
        assert engine.runner.rows
        assert engine.n_decode_graph_captures == 0
        assert engine.n_decode_graph_replays == 0


def test_multi_device_mesh_refused_on_the_plain_path(stacks):
    with pytest.raises(NotImplementedError, match="4-device mesh"):
        _backend(stacks, mesh=FakeBigMesh())


# ---------------------------------------------------------------------------
# prefill="dense": the one-shot oracle
# ---------------------------------------------------------------------------

def _engine(stacks, prefill="flash", **kw):
    (lm, lp), _, _ = stacks[1]
    return PagedEngine(lm, lp, EngineConfig(prefill=prefill, **ENGINE_KW,
                                            **kw), device="cpu")


def _kv(eng, sid, layer):
    h = eng.alloc.seqs[sid]
    k, v = eng.pool.gather_kv(layer, h.block_table, h.length)
    return np.asarray(k), np.asarray(v)


def test_flash_prefill_matches_dense_oracle(stacks):
    e_f = _engine(stacks, "flash", trace_logits=True)
    e_d = _engine(stacks, "dense", trace_logits=True)
    prompt = _prompt(37)
    sf, sd = e_f.prefill(prompt), e_d.prefill(prompt)
    for l in range(e_f.cfg.n_layers):
        for a, b in zip(_kv(e_f, sf, l), _kv(e_d, sd, l)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(e_f.logits_trace[0], e_d.logits_trace[0],
                               rtol=1e-4, atol=1e-4)
    out_f = e_f.decode([sf], 10, key=7, temperature=1.0)
    out_d = e_d.decode([sd], 10, key=7, temperature=1.0)
    assert out_f[sf] == out_d[sd]


def test_dense_oracle_matches_reference_dense(stacks):
    """The port's dense prefill against ``repro``'s: pool K/V and the
    prefill logits within 2e-5, batched prompts of three lengths."""
    (jlm, jp), _, _ = stacks[0]
    e_j = JaxEngine(jlm, jp, JaxEngineConfig(prefill="dense",
                                             trace_logits=True, **ENGINE_KW))
    e_d = _engine(stacks, "dense", trace_logits=True)
    prompts = [_prompt(n, 3) for n in (13, 29, 40)]
    sj, sd = e_j.prefill_many(prompts), e_d.prefill_many(prompts)
    np.testing.assert_allclose(e_d.logits_trace[0], e_j.logits_trace[0],
                               rtol=2e-5, atol=2e-5)
    for a, b in zip(sj, sd):
        for l in range(e_d.cfg.n_layers):
            for x, y in zip(_kv(e_j, a, l), _kv(e_d, b, l)):
                np.testing.assert_allclose(y, x, rtol=2e-5, atol=2e-5)


def _run_ets(backend):
    return run_search(backend, SearchConfig(
        method="ets", width=6, max_steps=3,
        ets=ETSConfig(lambda_b=1.0, lambda_d=1.0, cluster_threshold=0.2)),
        tree=backend.start(_prompt(17)))


@pytest.mark.parametrize("attention", ["paged", "tree"])
def test_flash_prefill_full_search_equivalence(stacks, attention):
    eng_f, be_f = _backend(stacks, attention, trace_logits=True)
    eng_d, be_d = _backend(stacks, attention, trace_logits=True,
                           prefill="dense")
    res_f, res_d = _run_ets(be_f), _run_ets(be_d)
    assert res_f.steps == res_d.steps >= 2
    assert [n.payload["tokens"] if n.payload else None
            for n in res_f.tree.nodes] == \
        [n.payload["tokens"] if n.payload else None
         for n in res_d.tree.nodes]
    np.testing.assert_allclose([n.reward for n in res_f.tree.nodes],
                               [n.reward for n in res_d.tree.nodes],
                               rtol=1e-5)
    assert len(eng_f.logits_trace) == len(eng_d.logits_trace) > 1
    for lf, ld in zip(eng_f.logits_trace, eng_d.logits_trace):
        np.testing.assert_allclose(lf, ld, rtol=1e-4, atol=1e-4)


def test_rejects_dense_prefill_with_chunking():
    with pytest.raises(ValueError, match="one-shot equivalence oracle"):
        EngineConfig(prefill="dense", prefill_chunk_tokens=16)
    with pytest.raises(ValueError, match="'flash' or 'dense'"):
        EngineConfig(prefill="sparse")


def test_serve_launcher_on_a_host_mesh(capsys):
    out = launch_serve.main(["--device", "cpu", "--requests", "2",
                             "--train-steps", "3", "--mesh", "1",
                             "--replicas", "2"])
    assert out["report"]["n_finished"] == 2
    for b in out["backends"]:
        assert b.engine.mesh is not None and b.engine.shard_fallbacks == []
        assert b.engine.alloc.used_pages == 0
    assert "replicas=2" in capsys.readouterr().out

