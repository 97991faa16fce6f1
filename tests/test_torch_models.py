"""Port layers and models against ``repro.models`` on the same inputs
(made with numpy from a seed) and the same params (through the bridge),
in float32 with atol 1e-5."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_stack import family_models, make_stacks

from repro.configs import get_config as jax_get_config
from repro.models import attention as JA
from repro.models import layers as JL

from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL

RNG = np.random.default_rng(7)
ATOL = 1e-5


def _pair(shape):
    x = RNG.normal(size=shape).astype(np.float32)
    return jnp.asarray(x), torch.as_tensor(x)


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               rtol=ATOL, atol=atol)


@pytest.fixture(scope="module")
def stacks():
    return make_stacks(seed=3)


def test_rms_norm():
    (jx, tx), (jw, tw) = _pair((3, 5, 64)), _pair((64,))
    _close(JL.rms_norm(jw, jx, 1e-5), TL.rms_norm(tw, tx, 1e-5))


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_rope(theta):
    jx, tx = _pair((2, 9, 4, 32))
    pos = RNG.integers(-1, 300, (2, 9)).astype(np.int32)
    ja = JL.rope_angles(jnp.asarray(pos), 32, theta)
    ta = TL.rope_angles(torch.as_tensor(pos), 32, theta)
    _close(ja, ta)
    _close(JL.apply_rope(jx, ja), TL.apply_rope(tx, ta), atol=1e-4)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_apply(act):
    jx, tx = _pair((2, 5, 32))
    names = ["w_up", "w_down"] + (["w_gate"] if act == "swiglu" else [])
    shapes = {"w_up": (32, 48), "w_down": (48, 32), "w_gate": (32, 48)}
    jp, tp = {}, {}
    for n in names:
        jp[n], tp[n] = _pair(shapes[n])
    _close(JL.mlp_apply(jp, jx, act), TL.mlp_apply(tp, tx, act))


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 3)])
def test_make_mask(causal, window):
    qp = RNG.integers(-1, 12, (2, 7)).astype(np.int32)
    kp = RNG.integers(-1, 12, (2, 9)).astype(np.int32)
    valid = RNG.random((2, 9)) < 0.8
    j = JA.make_mask(jnp.asarray(qp), jnp.asarray(kp), causal=causal,
                     window=window, kv_valid=jnp.asarray(valid))
    t = TA.make_mask(torch.as_tensor(qp), torch.as_tensor(kp),
                     causal=causal, window=window,
                     kv_valid=torch.as_tensor(valid))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_masked_attention():
    (jq, tq), (jk, tk), (jv, tv) = (_pair((2, 6, 4, 16)),
                                    _pair((2, 8, 2, 16)),
                                    _pair((2, 8, 2, 16)))
    pos_q = np.tile(np.arange(6, dtype=np.int32), (2, 1))
    pos_k = np.tile(np.arange(8, dtype=np.int32), (2, 1))
    pos_k[1, 6:] = -1
    jm = JA.make_mask(jnp.asarray(pos_q), jnp.asarray(pos_k), causal=True)
    tm = TA.make_mask(torch.as_tensor(pos_q), torch.as_tensor(pos_k),
                      causal=True)
    _close(JA.masked_attention(jq, jk, jv, jm, scale=0.25),
           TA.masked_attention(tq, tk, tv, tm, scale=0.25))


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_blocked_attention(causal, window):
    (jq, tq), (jk, tk), (jv, tv) = (_pair((2, 64, 4, 16)),
                                    _pair((2, 64, 2, 16)),
                                    _pair((2, 64, 2, 16)))
    pos = np.tile(np.arange(64, dtype=np.int32), (2, 1))
    pos[1, 50:] = -1
    kw = dict(scale=0.25, causal=causal, window=window, block_q=16,
              block_k=32)
    _close(JA.blocked_attention(jq, jk, jv, jnp.asarray(pos),
                                jnp.asarray(pos), **kw),
           TA.blocked_attention(tq, tk, tv, torch.as_tensor(pos),
                                torch.as_tensor(pos), **kw))


def test_project_qkv_with_qk_norm():
    kw = dict(qk_norm=True, d_model=64, n_heads=4, n_kv_heads=2,
              head_dim=16)
    cfg_j = dataclasses.replace(jax_get_config("tiny-lm"), **kw)
    cfg_t = dataclasses.replace(get_config("tiny-lm"), **kw)
    jp, tp = {}, {}
    for n, shp in [("wq", (64, 64)), ("wk", (64, 32)), ("wv", (64, 32)),
                   ("q_norm", (16,)), ("k_norm", (16,))]:
        jp[n], tp[n] = _pair(shp)
    jx, tx = _pair((2, 5, 64))
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    for j, t in zip(JA._project_qkv(jp, jx, cfg_j, jnp.asarray(pos)),
                    TA._project_qkv(tp, tx, cfg_t, torch.as_tensor(pos))):
        _close(j, t, atol=1e-4)


def _batch(n, T, vocab, pad=True):
    toks = RNG.integers(0, vocab, (n, T)).astype(np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (n, 1))
    if pad:
        pos[0, T - 3:] = -1          # right padding, masked by position
    return toks, pos


def test_lm_forward(stacks):
    (jlm, jp), _, _ = stacks[0]
    (tlm, tp), _, _ = stacks[1]
    toks, _ = _batch(2, 11, jlm.cfg.vocab_size, pad=False)
    jl, _ = jlm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, aux = tlm.forward(tp, {"tokens": torch.as_tensor(toks)})
    assert aux == 0.0
    _close(jl, tl)


def test_prm_reward_and_hidden(stacks):
    _, (jprm, jp), _ = stacks[0]
    _, (tprm, tp), _ = stacks[1]
    toks, pos = _batch(3, 16, jprm.cfg.vocab_size)
    jb = {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)}
    tb = {"tokens": torch.as_tensor(toks), "positions": torch.as_tensor(pos)}
    _close(jprm.reward(jp, jb), tprm.reward(tp, tb))
    _close(jprm.hidden(jp, jb), tprm.hidden(tp, tb))


def test_embedder_hidden_noncausal_with_padding(stacks):
    _, _, (jemb, jp) = stacks[0]
    _, _, (temb, tp) = stacks[1]
    assert not temb.cfg.causal
    toks, pos = _batch(3, 8, jemb.cfg.vocab_size)
    j = jemb.hidden(jp, {"tokens": jnp.asarray(toks),
                         "positions": jnp.asarray(pos)})
    t = temb.hidden(tp, {"tokens": torch.as_tensor(toks),
                         "positions": torch.as_tensor(pos)})
    _close(j, t)


def test_bridge_rejects_mismatched_params(stacks):
    (_, jp), _, _ = stacks[0]
    (tlm, _), _, _ = stacks[1]
    bad = dict(jp, frontend_proj=np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="frontend_proj"):
        params_from_jax(bad, tlm.cfg, "cpu")
    small = dataclasses.replace(tlm.cfg, vocab_size=tlm.cfg.vocab_size + 1)
    with pytest.raises(ValueError):
        params_from_jax({k: np.asarray(v) for k, v in jp.items()
                         if k != "groups"}, small, "cpu")


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def test_init_matches_reference_shapes(stacks):
    """Port init: the reference's tree and shapes, with its scales
    (embed std 0.02, dense std 1/sqrt(d_in))."""
    (jlm, jp), (jprm, jpp), _ = stacks[0]
    (tlm, _), (tprm, _), _ = stacks[1]
    for jparams, tmodel in ((jp, tlm), (jpp, tprm)):
        tp = tmodel.init(torch.Generator().manual_seed(0))
        assert _shapes(tp) == _shapes(jparams)
        assert all(a.dtype == torch.float32
                   for a in [tp["embed"], tp["ln_f"]])
    assert abs(float(tp["embed"].std()) - 0.02) < 2e-3
    w_up = tp["groups"][0]["mlp"]["w_up"]
    assert abs(float(w_up.std()) * tlm.cfg.d_model ** 0.5 - 1.0) < 0.05


# ---------------------------------------------------------------------------
# Every registered family at tiny size
# ---------------------------------------------------------------------------

DENSE_ARCHS = ["phi3-mini-3.8b", "qwen3-14b", "yi-6b", "llemma-34b"]
FAMILY_ARCHS = ["mixtral-8x7b", "deepseek-moe-16b", "mamba2-370m",
                "rwkv6-7b", "zamba2-7b"]


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_tiny_dense_variant_forward(arch):
    """The dense configs the engine's attention runtime serves (qk-norm,
    GQA ratios, rope thetas), at their tiny variants: same logits."""
    (jlm, jp), (tlm, tp) = family_models(arch, seed=5)
    toks, _ = _batch(2, 11, jlm.cfg.vocab_size, pad=False)
    jl, _ = jlm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tlm.forward(tp, {"tokens": torch.as_tensor(toks)})
    _close(jl, tl, atol=1e-4)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_tiny_family_forward_and_init(arch):
    """MoE, SSM and hybrid forwards (full-sequence scans from zero state,
    the shared attention block, the MoE aux loss) against the reference
    at the mixer tolerance (2e-4), and the port init's tree and shapes
    against the reference init's."""
    (jlm, jp), (tlm, tp) = family_models(arch, seed=6)
    toks, _ = _batch(2, 40, jlm.cfg.vocab_size, pad=False)
    jl, jaux = jlm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, taux = tlm.forward(tp, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    init = tlm.init(torch.Generator().manual_seed(0))
    assert _shapes(init) == _shapes(jp)
