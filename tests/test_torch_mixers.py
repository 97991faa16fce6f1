"""The port's family mixers against ``repro.models`` on the CPU: mamba2
(chunked SSD), rwkv6 (chunked WKV) and the sort-dispatch MoE, on the
same numpy-seeded params and inputs, at the reference tests' tolerances
(``tests/test_mixers.py``: 2e-4 to 5e-4).  Also the port's own chunked
scans against its per-token recurrences, state carried across calls,
right-padded rows (``lengths``), the MoE against its dense oracle, with
capacity drops (capacity factor 1.25) and int8 expert banks."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_stack import numpy_tree

import repro.models.moe as JMOE
from repro.configs import SSMConfig as JaxSSMConfig
from repro.configs import get_config as jax_get_config
from repro.configs import tiny_variant as jax_tiny_variant
from repro.models import layers as JL
from repro.models import mamba2 as JM
from repro.models import rwkv6 as JR

from repro_torch.bridge import params_to_numpy
from repro_torch.configs import SSMConfig, get_config, tiny_variant
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import rwkv6 as TR
from repro_torch.models.model import tree_map


def _cfgs(arch, **over):
    """(reference cfg, port cfg) of ``arch``'s tiny variant, with the
    same overrides (``ssm`` given as SSMConfig kwargs)."""
    ssm = over.pop("ssm", None)
    out = []
    for get, tiny, ssm_cls in ((jax_get_config, jax_tiny_variant,
                                JaxSSMConfig),
                               (get_config, tiny_variant, SSMConfig)):
        kw = dict(over)
        if ssm is not None:
            kw["ssm"] = ssm_cls(**ssm)
        out.append(dataclasses.replace(tiny(get(arch)), **kw))
    return out


def _mamba_cfgs(chunk=16):
    return _cfgs("zamba2-7b", d_model=64, ssm=dict(
        kind="mamba2", d_state=8, d_conv=4, head_dim=16, expand=2,
        chunk_size=chunk))


def _rwkv_cfgs(chunk=16):
    return _cfgs("rwkv6-7b", d_model=64, d_ff=128, ssm=dict(
        kind="rwkv6", head_dim=16, chunk_size=chunk))


def _params(init, cfg, seed=0):
    """The same numpy-drawn params as jnp (reference) and torch (port)."""
    npp = numpy_tree(lambda k: init(k, cfg), seed)
    return (jax.tree.map(jnp.asarray, npp),
            tree_map(lambda a: torch.tensor(np.asarray(a)), npp))


def _x(shape, seed=0, scale=1.0):
    x = (np.random.default_rng(seed).normal(size=shape) * scale
         ).astype(np.float32)
    return jnp.asarray(x), torch.tensor(x)


def _close(ref, got, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def _state_close(ref, got, tol):
    for k in ref:
        _close(ref[k], got[k].float().numpy(), tol)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_and_group_norms_match_reference(dtype):
    jx, tx = _x((3, 5, 64), seed=1)
    jz, tz = _x((3, 5, 64), seed=2)
    jw, tw = _x((64,), seed=3)
    jb, tb = _x((64,), seed=4)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    tol = 2e-6 if dtype == "float32" else 1e-2
    _close(JL.rms_norm_gated(jw, jx.astype(jdt), jz.astype(jdt)),
           TL.rms_norm_gated(tw, tx.to(tdt), tz.to(tdt)).float(), tol)
    _close(JL.group_norm_heads(jw, jb, jx.astype(jdt), 4),
           TL.group_norm_heads(tw, tb, tx.to(tdt), 4).float(), tol)
    got = TL.softplus(tx * 10)
    _close(jax.nn.softplus(jx * 10), got, 2e-6)


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [16, 32, 48, 40])   # incl. non-chunk-multiple
def test_mamba_full_matches_reference(T):
    jcfg, tcfg = _mamba_cfgs()
    jp, tp = _params(JM.mamba_init, jcfg)
    jx, tx = _x((2, T, 64))
    jy, js = JM.mamba_apply_full(jp, jx, jcfg)
    ty, ts = TM.mamba_apply_full(tp, tx, tcfg)
    _close(jy, ty, 2e-4)
    _state_close(js, ts, 2e-4)
    # the port's chunked scan against its own per-token recurrence
    ry, rs = TM.mamba_apply_recurrent(tp, tx, tcfg)
    _close(ry, ty, 2e-4)
    _state_close(rs, ts, 2e-4)


def test_mamba_state_carries_across_calls():
    jcfg, tcfg = _mamba_cfgs()
    jp, tp = _params(JM.mamba_init, jcfg, seed=1)
    jx, tx = _x((1, 32, 64), seed=1)
    jy, _ = JM.mamba_apply_full(jp, jx, jcfg)
    y1, s1 = TM.mamba_apply_full(tp, tx[:, :16], tcfg)
    y2, _ = TM.mamba_apply_full(tp, tx[:, 16:], tcfg, s1)
    _close(jy, torch.cat([y1, y2], 1), 3e-4)


def test_mamba_right_padded_rows_match_reference():
    """``lengths``: identity steps past each row's end, the conv tail at
    the last valid token; a zero-length row keeps its incoming state."""
    jcfg, tcfg = _mamba_cfgs()
    jp, tp = _params(JM.mamba_init, jcfg, seed=2)
    jx, tx = _x((3, 40, 64), seed=2)
    jst = {k: v for k, v in JM.init_mamba_state(jcfg, 3).items()}
    jst = {k: v + 0.1 for k, v in jst.items()}
    tst = {k: torch.tensor(np.asarray(v)) for k, v in jst.items()}
    lens = np.array([40, 7, 0], np.int32)
    jy, js = JM.mamba_apply_full(jp, jx, jcfg, jst,
                                 lengths=jnp.asarray(lens))
    ty, ts = TM.mamba_apply_full(tp, tx, tcfg, tst,
                                 lengths=torch.tensor(lens))
    _state_close(js, ts, 2e-4)
    _close(jy[0], ty[0], 2e-4)
    _close(jy[1, :7], ty[1, :7], 2e-4)
    # row 1's state is the state after its 7 tokens alone
    _, s7 = TM.mamba_apply_full(tp, tx[1:2, :7], tcfg,
                                {k: v[1:2] for k, v in tst.items()})
    _state_close({k: np.asarray(v[1:2]) for k, v in js.items()}, s7, 2e-4)
    assert all(torch.equal(ts[k][2], tst[k][2]) for k in ts)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_step_matches_reference(dtype):
    jcfg, tcfg = _mamba_cfgs()
    jp, tp = _params(JM.mamba_init, jcfg, seed=3)
    jx, tx = _x((4, 1, 64), seed=3)
    jst = {k: v + 0.05 for k, v in JM.init_mamba_state(jcfg, 4).items()}
    tst = {k: torch.tensor(np.asarray(v)) for k, v in jst.items()}
    jy, js = JM.mamba_decode_step(jp, jx.astype(dtype), jcfg, jst)
    ty, ts = TM.mamba_decode_step(tp, tx.to(getattr(torch, dtype)), tcfg,
                                  tst)
    tol = 2e-4 if dtype == "float32" else 3e-2
    _close(jy.astype(jnp.float32), ty.float(), tol)
    _state_close(js, ts, tol)


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [16, 32, 24])
def test_rwkv_full_matches_reference(T):
    jcfg, tcfg = _rwkv_cfgs()
    jp, tp = _params(JR.rwkv_init, jcfg)
    jx, tx = _x((2, T, 64))
    jy, js = JR.rwkv_apply_full(jp, jx, jcfg)
    ty, ts = TR.rwkv_apply_full(tp, tx, tcfg)
    _close(jy, ty, 5e-4)
    _state_close(js, ts, 5e-4)
    ry, rs = TR.rwkv_apply_recurrent(tp, tx, tcfg)
    _close(ry, ty, 5e-4)
    _state_close(rs, ts, 5e-4)


def test_rwkv_state_carries_and_padded_rows_match_reference():
    jcfg, tcfg = _rwkv_cfgs()
    jp, tp = _params(JR.rwkv_init, jcfg, seed=1)
    jx, tx = _x((3, 32, 64), seed=1)
    jy, _ = JR.rwkv_apply_full(jp, jx, jcfg)
    y1, s1 = TR.rwkv_apply_full(tp, tx[:, :16], tcfg)
    y2, _ = TR.rwkv_apply_full(tp, tx[:, 16:], tcfg, s1)
    _close(jy, torch.cat([y1, y2], 1), 5e-4)
    lens = np.array([32, 9, 0], np.int32)
    jst = {k: v + 0.1 for k, v in JR.init_rwkv_state(jcfg, 3).items()}
    tst = {k: torch.tensor(np.asarray(v)) for k, v in jst.items()}
    jy, js = JR.rwkv_apply_full(jp, jx, jcfg, jst, lengths=jnp.asarray(lens))
    ty, ts = TR.rwkv_apply_full(tp, tx, tcfg, tst, lengths=torch.tensor(lens))
    _state_close(js, ts, 5e-4)
    _close(jy[1, :9], ty[1, :9], 5e-4)
    assert all(torch.equal(ts[k][2], tst[k][2]) for k in ts)


def test_rwkv_decode_step_and_channel_mix_match_reference():
    jcfg, tcfg = _rwkv_cfgs()
    jp, tp = _params(JR.rwkv_init, jcfg, seed=2)
    jx, tx = _x((4, 1, 64), seed=2)
    jst = {k: v + 0.05 for k, v in JR.init_rwkv_state(jcfg, 4).items()}
    tst = {k: torch.tensor(np.asarray(v)) for k, v in jst.items()}
    jy, js = JR.rwkv_decode_step(jp, jx, jcfg, jst)
    ty, ts = TR.rwkv_decode_step(tp, tx, tcfg, tst)
    _close(jy, ty, 5e-4)
    _state_close(js, ts, 5e-4)
    jcp, tcp = _params(JR.channel_mix_init, jcfg, seed=3)
    jsh, tsh = _x((4, 5, 64), seed=4)
    jx, tx = _x((4, 5, 64), seed=5)
    _close(JR.channel_mix_apply(jcp, jx, jsh),
           TR.channel_mix_apply(tcp, tx, tsh), 2e-4)


def test_rwkv_decay_clamped():
    """The LOG_W_MIN clamp keeps the factorized chunk finite under an
    extreme decay bias."""
    _, tcfg = _rwkv_cfgs(chunk=32)
    jcfg, _ = _rwkv_cfgs(chunk=32)
    _, tp = _params(JR.rwkv_init, jcfg)
    tp["w_bias"] = torch.full_like(tp["w_bias"], 5.0)
    _, tx = _x((1, 64, 64), scale=3.0)
    y, _ = TR.rwkv_apply_full(tp, tx, tcfg)
    assert torch.isfinite(y).all()


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe(capacity_factor=None, seed=0):
    jcfg, tcfg = _cfgs("deepseek-moe-16b")
    if capacity_factor is not None:
        jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=capacity_factor)) for c in (jcfg, tcfg))
    jp, tp = _params(JMOE.moe_init, jcfg, seed)
    jx, tx = _x((64, jcfg.d_model), seed)
    return jcfg, tcfg, jp, tp, jx, tx


def test_moe_matches_reference_and_dense_oracle():
    """Tiny variants are dropless: dispatch equals the dense loop."""
    jcfg, tcfg, jp, tp, jx, tx = _moe()
    jy, jaux = JMOE.moe_apply(jp, jx, jcfg)
    ty, taux = TMOE.moe_apply_auto(tp, tx, tcfg)
    _close(jy, ty, 2e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    dy, daux = TMOE.moe_apply_dense(tp, tx, tcfg)
    _close(dy, ty, 2e-4)
    np.testing.assert_allclose(float(daux), float(taux), rtol=1e-6)


@pytest.mark.parametrize("capacity_factor,capacity", [(1.25, 0), (4.0, 8)])
def test_moe_capacity_drops_match_reference(capacity_factor, capacity):
    """Capacity factor 1.25 (the full configs') and a tight explicit
    capacity drop replicas; the stable sort drops the same ones as the
    reference, and the dropped replicas contribute zeros."""
    jcfg, tcfg, jp, tp, jx, tx = _moe(capacity_factor, seed=1)
    # skew the router: every token ranks expert 0 high, so it overflows
    col = np.full(jcfg.d_model, 0.3, np.float32)
    jp["router"] = jp["router"].at[:, 0].set(jnp.asarray(col))
    tp["router"][:, 0] = torch.tensor(col)
    jx, tx = jx + 0.5, tx + 0.5
    jy, _ = JMOE.moe_apply(jp, jx, jcfg, capacity=capacity)
    ty, _ = TMOE.moe_apply(tp, tx, tcfg, capacity=capacity)
    _close(jy, ty, 2e-4)
    dy, _ = TMOE.moe_apply_dense(tp, tx, tcfg)
    assert float((dy - ty).abs().max()) > 1e-3      # drops happened
    assert torch.isfinite(ty).all()


def test_moe_top_k_breaks_ties_like_lax():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    tv, ti = TMOE.top_k(torch.tensor(probs), 2)
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert np.array_equal(np.asarray(jv), tv.numpy())


def test_moe_quantized_banks_match_reference():
    jcfg, tcfg, jp, tp, jx, tx = _moe(seed=2)
    jq, tq = dict(jp), dict(tp)
    for n in ("w_up", "w_gate", "w_down"):
        jq[n] = JMOE.quantize_bank(jp[n])
        tq[n] = TMOE.quantize_bank(tp[n])
        assert tq[n]["q"].dtype == torch.int8
        assert np.array_equal(np.asarray(jq[n]["q"]), tq[n]["q"].numpy())
        _close(jq[n]["s"], tq[n]["s"], 1e-7)
    jy, _ = JMOE.moe_apply(jq, jx, jcfg)
    ty, _ = TMOE.moe_apply(tq, tx, tcfg)
    _close(jy, ty, 2e-4)
    fy, _ = TMOE.moe_apply(tp, tx, tcfg)
    rel = float((ty - fy).abs().max() / (fy.abs().max() + 1e-9))
    assert rel < 0.05
    # the int8 banks round-trip through the host layout unchanged
    back = params_to_numpy(tq)
    assert back["w_up"]["q"].dtype == np.int8
