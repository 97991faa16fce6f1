"""The VLM and audio-encoder families on the port, against ``repro`` on
the CPU: qwen2-vl (M-RoPE, patch frontend) and hubert (frame frontend).

On the same numpy-seeded params (carried across through the bridge):

  * ``rope_angles`` with three distinct (t, h, w) position streams, at
    the tiny sections (8, 4, 4) and qwen2-vl-7b's (16, 24, 24) at θ 1e6;
  * ``forward`` / ``hidden`` / ``reward`` with patch embeds before the
    text tokens and distinct position streams over the patches, for
    qwen2-vl-tiny (G 2) and a G 7 variant (7 query heads over 1 kv head,
    hd 32): float32, rtol and atol 1e-5;
  * the paged engine on both variants: one-shot and streamed prefill
    logits and greedy decode (rtol and atol 2e-4, the families' bar), and
    a greedy ETS search in paged and tree mode that gives the
    reference's tree and tokens, PRM rewards within rtol 1e-5;
  * hubert-tiny ``forward`` / ``hidden`` on frames alone, and the engine
    refusing it (an encoder has no decode path).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_stack import numpy_params

from repro.configs import get_config as jax_get_config
from repro.configs import tiny_variant as jax_tiny_variant
from repro.core import ETSConfig as JaxETSConfig
from repro.core import SearchConfig as JaxSearchConfig
from repro.core import run_search as jax_run_search
from repro.models import layers as JL
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import PagedEngine as JaxEngine
from repro.serving.search_backend import BackendConfig as JaxBackendConfig
from repro.serving.search_backend import LMBackend as JaxBackend

from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, tiny_variant
from repro_torch.core import ETSConfig, SearchConfig, run_search
from repro_torch.models import layers as TL
from repro_torch.models.model import build_model
from repro_torch.serving import (BackendConfig, EngineConfig, LMBackend,
                                 PagedEngine)

TOL = 1e-5
TOL_ENGINE = 2e-4
# qwen2-vl-tiny: tiny_variant gives 4 query heads over 2 kv heads (G 2);
# the G 7 variant keeps qwen2-vl-7b's odd group size, not a power of two
VARIANTS = {"g2": {}, "g7": dict(n_heads=7, n_kv_heads=1)}
ENGINE_KW = dict(n_pages=128, page_size=8, max_batch=16, max_seq_len=64)
PROMPTS = [[3, 5, 7, 2, 9], [4, 4, 1], list(range(10, 39))]


def _configs(arch, **over):
    return (dataclasses.replace(jax_tiny_variant(jax_get_config(arch)),
                                **over),
            dataclasses.replace(tiny_variant(get_config(arch)), **over))


def _models(jcfg, tcfg, seed, value_head=False):
    jm = jax_build_model(jcfg, with_value_head=value_head, remat=False)
    tm = build_model(tcfg, with_value_head=value_head, device="cpu")
    npp = numpy_params(jm, seed)
    return ((jm, jax.tree.map(jnp.asarray, npp)),
            (tm, params_from_jax(npp, tcfg, "cpu")))


@pytest.fixture(scope="module")
def vlm():
    """variant -> ((jax lm, params), (torch lm, params)), and the same
    with a value head, built lazily."""
    cache = {}

    def get(variant, value_head=False):
        key = (variant, value_head)
        if key not in cache:
            cache[key] = _models(*_configs("qwen2-vl-7b",
                                           **VARIANTS[variant]),
                                 seed=5, value_head=value_head)
        return cache[key]
    return get


def _close(j, t, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd,sections,theta", [(32, (8, 4, 4), 1e6),
                                               (128, (16, 24, 24), 1e6)])
def test_rope_angles_three_streams(hd, sections, theta):
    rng = np.random.default_rng(1)
    pos = rng.integers(-1, 500, (3, 2, 9)).astype(np.int32)
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
    ja = JL.rope_angles(jnp.asarray(pos), hd, theta, sections)
    ta = TL.rope_angles(torch.as_tensor(pos), hd, theta, sections)
    assert ta.shape == (2, 9, hd // 2)
    _close(ja, ta)
    x = rng.normal(size=(2, 9, 4, hd)).astype(np.float32)
    _close(JL.apply_rope(jnp.asarray(x), ja),
           TL.apply_rope(torch.as_tensor(x), ta), tol=1e-4)
    # three equal streams are plain RoPE
    same = np.broadcast_to(pos[0], pos.shape).copy()
    _close(TL.rope_angles(torch.as_tensor(pos[0]), hd, theta),
           TL.rope_angles(torch.as_tensor(same), hd, theta, sections),
           tol=0)


def test_rope_angles_rejects_flat_positions_for_mrope():
    with pytest.raises(ValueError, match="M-RoPE"):
        TL.rope_angles(torch.zeros((2, 9), dtype=torch.int32), 32, 1e6,
                       (8, 4, 4))


# ---------------------------------------------------------------------------
# forward / hidden / reward with patch embeds
# ---------------------------------------------------------------------------

def _vlm_batch(cfg, B=2, n_patch=6, n_text=10, seed=0):
    """Patch embeds, text tokens after them, and M-RoPE positions: the
    patches share t and count over a (2, 3) grid in h and w, the text
    continues all three streams from the grid's end."""
    rng = np.random.default_rng(seed)
    embeds = rng.normal(size=(B, n_patch, cfg.frontend_dim)).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, n_text)).astype(np.int32)
    grid_h, grid_w = 2, n_patch // 2
    t = np.zeros(n_patch, np.int32)
    h = np.repeat(np.arange(grid_h), grid_w).astype(np.int32)
    w = np.tile(np.arange(grid_w), grid_h).astype(np.int32)
    start = max(grid_h, grid_w)
    text = np.arange(start, start + n_text, dtype=np.int32)
    pos = np.stack([np.concatenate([s, text]) for s in (t, h, w)])
    pos = np.broadcast_to(pos[:, None], (3, B, n_patch + n_text)).copy()
    return embeds, toks, pos


def _both(embeds, toks, pos):
    return ({"embeds": jnp.asarray(embeds), "tokens": jnp.asarray(toks),
             "positions": jnp.asarray(pos)},
            {"embeds": torch.as_tensor(embeds),
             "tokens": torch.as_tensor(toks).long(),
             "positions": torch.as_tensor(pos)})


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_hidden_with_patch_embeds(vlm, variant):
    (jm, jp), (tm, tp) = vlm(variant)
    assert tm.cfg.n_heads // tm.cfg.n_kv_heads == (7 if variant == "g7"
                                                    else 2)
    jb, tb = _both(*_vlm_batch(tm.cfg))
    jl, _ = jm.forward(jp, jb)
    tl, _ = tm.forward(tp, tb)
    assert tl.shape == (2, 16, tm.cfg.vocab_size)
    _close(jl, tl)
    _close(jm.hidden(jp, jb), tm.hidden(tp, tb))
    # default positions: 0..S-1 broadcast to the three streams
    jb.pop("positions"), tb.pop("positions")
    _close(jm.forward(jp, jb)[0], tm.forward(tp, tb)[0])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_reward_with_patch_embeds(vlm, variant):
    (jm, jp), (tm, tp) = vlm(variant, value_head=True)
    jb, tb = _both(*_vlm_batch(tm.cfg, seed=1))
    r = tm.reward(tp, tb)
    assert r.shape == (2, 16) and r.dtype == torch.float32
    _close(jm.reward(jp, jb), r)


def test_embeds_only_and_tokens_only(vlm):
    (jm, jp), (tm, tp) = vlm("g2")
    embeds, toks, _ = _vlm_batch(tm.cfg, n_patch=4, n_text=5, seed=2)
    jl, _ = jm.forward(jp, {"embeds": jnp.asarray(embeds)})
    tl, _ = tm.forward(tp, {"embeds": torch.as_tensor(embeds)})
    assert tl.shape[1] == 4
    _close(jl, tl)
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.forward(tp, {"tokens": torch.as_tensor(toks).long()})
    _close(jl, tl)


# ---------------------------------------------------------------------------
# the paged engine on the VLM (text prompts, as in the reference)
# ---------------------------------------------------------------------------

def _engines(vlm, variant, mode="paged", **over):
    (jm, jp), (tm, tp) = vlm(variant)
    kw = dict(ENGINE_KW, attention=mode, **over)
    return (JaxEngine(jm, jp, JaxEngineConfig(**kw)),
            PagedEngine(tm, tp, EngineConfig(**kw), device="cpu"))


@pytest.mark.parametrize("mode", ["paged", "tree"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_greedy_decode_match_reference(vlm, variant, mode):
    je, te = _engines(vlm, variant, mode, trace_logits=True)
    js, ts = je.prefill_many(PROMPTS), te.prefill_many(PROMPTS)
    np.testing.assert_allclose(te.logits_trace[0], je.logits_trace[0],
                               rtol=TOL_ENGINE, atol=TOL_ENGINE)
    kids_j = [b for s in js for b in je.branch(s, 2)]
    kids_t = [b for s in ts for b in te.branch(s, 2)]
    jo = je.decode(kids_j, 8, jax.random.key(1), temperature=0.0)
    to = te.decode(kids_t, 8, key=1, temperature=0.0)
    assert [jo[s] for s in kids_j] == [to[s] for s in kids_t]
    for a, b in zip(je.logits_trace[1:], te.logits_trace[1:]):
        np.testing.assert_allclose(b, a, rtol=TOL_ENGINE, atol=TOL_ENGINE)
    te.alloc.check_invariants()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_streamed_prefill_matches_reference(vlm, variant):
    prompt = list(map(int, np.random.default_rng(3).integers(1, 500, 40)))
    je, te = _engines(vlm, variant, prefill_chunk_tokens=16,
                      trace_logits=True)
    js, ts = je.prefill(prompt), te.prefill(prompt)
    assert te.n_prefill_calls == 3
    np.testing.assert_allclose(te.logits_trace[-1], je.logits_trace[-1],
                               rtol=TOL_ENGINE, atol=TOL_ENGINE)
    jo = je.decode([js], 6, jax.random.key(2), temperature=0.0)
    to = te.decode([ts], 6, key=2, temperature=0.0)
    assert jo[js] == to[ts]


def _prm_emb(vocab):
    """(jax, torch) tiny dense PRM and embedder at ``vocab`` (the
    backend scores text with (B,S) positions, so the PRM is a text
    model, as on the card)."""
    out = ([], [])
    for i, (name, vh) in enumerate([("tiny-lm", True),
                                    ("tiny-embedder", False)]):
        over = dict(n_layers=1, d_model=64, n_heads=2, n_kv_heads=2,
                    d_ff=128, vocab_size=vocab)
        (j, t) = _models(dataclasses.replace(jax_get_config(name), **over),
                         dataclasses.replace(get_config(name), **over),
                         seed=11 + i, value_head=vh)
        out[0].append(j)
        out[1].append(t)
    return out


BACKEND_KW = dict(step_token=2, eos_token=3, max_step_tokens=6, max_depth=3,
                  temperature=0.0)
SEARCH_KW = dict(method="ets", width=4, max_steps=3)
ETS_KW = dict(lambda_b=1.0, lambda_d=1.0, cluster_threshold=0.2)
SEARCH_PROMPT = list(range(4, 21))


def _tree_view(res):
    return [(n.parent, n.depth, n.n_tokens, n.finished,
             (n.payload or {}).get("tokens")) for n in res.tree.nodes]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_ets_search_matches_reference(vlm, variant):
    (jm, jp), (tm, tp) = vlm(variant)
    (jprm, jemb), (tprm, temb) = _prm_emb(tm.cfg.vocab_size)
    engine = JaxEngine(jm, jp, JaxEngineConfig(**ENGINE_KW))
    backend = JaxBackend(engine, *jprm, *jemb, JaxBackendConfig(**BACKEND_KW),
                         answer_fn=lambda full: None, seed=13)
    ref = jax_run_search(backend, JaxSearchConfig(
        ets=JaxETSConfig(**ETS_KW), **SEARCH_KW),
        tree=backend.start(SEARCH_PROMPT))
    assert len(ref.tree.nodes) > 1
    for mode in ("paged", "tree"):
        engine = PagedEngine(tm, tp, EngineConfig(attention=mode,
                                                  **ENGINE_KW), device="cpu")
        backend = LMBackend(engine, *tprm, *temb, BackendConfig(**BACKEND_KW),
                            answer_fn=lambda full: None, seed=13,
                            device="cpu")
        got = run_search(backend, SearchConfig(ets=ETSConfig(**ETS_KW),
                                               **SEARCH_KW),
                         tree=backend.start(SEARCH_PROMPT))
        assert got.steps == ref.steps
        assert _tree_view(got) == _tree_view(ref), mode
        np.testing.assert_allclose([n.reward for n in got.tree.nodes],
                                   [n.reward for n in ref.tree.nodes],
                                   rtol=1e-5, atol=0)
        engine.alloc.check_invariants()
        assert engine.alloc.used_pages == 0


# ---------------------------------------------------------------------------
# hubert: the audio encoder on frames
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hubert():
    return _models(*_configs("hubert-xlarge"), seed=7)


def test_hubert_forward_and_hidden_on_frames(hubert):
    (jm, jp), (tm, tp) = hubert
    assert not tm.cfg.causal and tm.cfg.arch_type == "encoder"
    frames = np.random.default_rng(4).normal(
        size=(2, 12, tm.cfg.frontend_dim)).astype(np.float32)
    jb, tb = {"embeds": jnp.asarray(frames)}, {"embeds":
                                               torch.as_tensor(frames)}
    jl, _ = jm.forward(jp, jb)
    tl, _ = tm.forward(tp, tb)
    assert tl.shape == (2, 12, tm.cfg.vocab_size)
    _close(jl, tl)
    _close(jm.hidden(jp, jb), tm.hidden(tp, tb))


def test_engine_refuses_hubert(hubert):
    _, (tm, tp) = hubert
    with pytest.raises(ValueError, match="no decode path"):
        PagedEngine(tm, tp, EngineConfig(**ENGINE_KW), device="cpu")


def test_bridge_round_trips_frontend_proj(hubert):
    (jm, jp), (tm, tp) = hubert
    assert tp["frontend_proj"].shape == (tm.cfg.frontend_dim,
                                         tm.cfg.d_model)
    np.testing.assert_array_equal(tp["frontend_proj"].numpy(),
                                  np.asarray(jp["frontend_proj"]))
    no_frontend = dict(jp)
    no_frontend.pop("frontend_proj")
    with pytest.raises(ValueError, match="frontend_proj"):
        params_from_jax(jax.tree.map(np.asarray, no_frontend), tm.cfg, "cpu")
