"""The port's contiguous KV/state cache — ``LM.prefill`` / ``init_cache``
/ ``decode_step`` for all four plans — against its own ``forward`` and
against the reference on the CPU (the port's mirror of
``tests/test_models.py``): every decode arch's prefill and decode steps,
the VLM's multimodal prefill, the sliding-window ring, long mode, int8
KV, and caches carried across the bridge in both directions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_stack import family_models

from repro.configs import get_config as jax_get_config
from repro.configs import tiny_variant as jax_tiny_variant
from repro.models.model import LM as JaxLM

from repro_torch.bridge import cache_from_numpy, cache_to_numpy
from repro_torch.configs import get_config, list_configs, tiny_variant
from repro_torch.launch import steps
from repro_torch.models.model import LM, build_model, tree_leaves

ARCHES = [
    "deepseek-moe-16b", "zamba2-7b", "hubert-xlarge", "phi3-mini-3.8b",
    "qwen2-vl-7b", "llama3.2-1b", "mixtral-8x7b", "qwen3-14b",
    "rwkv6-7b", "yi-6b",
]
DECODE_ARCHES = [a for a in ARCHES if get_config(a).supports_decode
                 and not get_config(a).frontend_dim]
# the reference's own bars (tests/test_models.py)
TOL_PREFILL, TOL_DECODE, TOL_RING = 3e-3, 6e-3, 8e-3
# the port against the reference: same function, fp32, other op order
TOL_REF = 1e-4


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = family_models(arch, seed=5)
        return cache[arch]

    return get


class Ref:
    """The reference model's jitted prefill and decode step."""

    def __init__(self, jm, jp):
        self.jp = jp
        self.prefill = jax.jit(jm.prefill, static_argnums=2)
        self.decode = jax.jit(jm.decode_step)

    def run_prefill(self, batch, cache_len):
        lg, c = self.prefill(self.jp, {k: jnp.asarray(v)
                                       for k, v in batch.items()}, cache_len)
        return np.asarray(lg), c

    def step(self, tok, cache):
        lg, c = self.decode(self.jp, jnp.asarray(tok), cache)
        return np.asarray(lg), c


def tt(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def assert_cache_close(model, got, want, tol=TOL_REF):
    got = flat(cache_to_numpy(got, model))
    want = flat(jax.tree.map(np.asarray, want))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                   err_msg=k)


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# forward + train step smoke, every arch
# ---------------------------------------------------------------------------

def make_batch(cfg, B=2, S=40, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.arch_type == "encoder":
        batch = {"embeds": rng.normal(size=(B, S, cfg.frontend_dim))
                 .astype(np.float32)}
    elif cfg.arch_type == "vlm":
        s_img = S // 4
        batch = {"embeds": rng.normal(size=(B, s_img, cfg.frontend_dim))
                 .astype(np.float32),
                 "tokens": rng.integers(0, cfg.vocab_size, (B, S - s_img)),
                 "positions": np.broadcast_to(
                     np.arange(S, dtype=np.int32), (3, B, S)).copy()}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    batch["labels"] = np.zeros((B, S), np.int64)
    batch["loss_mask"] = np.ones((B, S), np.float32)
    return tt(batch)


@pytest.mark.parametrize("arch", ARCHES)
def test_smoke_forward_and_train_step(arch):
    cfg = tiny_variant(get_config(arch))
    model = build_model(cfg, remat=False, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = make_batch(cfg)
    logits, aux = model.forward(params, batch)
    assert logits.shape[0] == 2 and logits.shape[-1] == cfg.vocab_size
    assert not torch.isnan(logits).any()
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    assert torch.isfinite(loss)
    gnorm = sum(float(g.abs().sum()) for g in grads)
    assert np.isfinite(gnorm) and gnorm > 0


# ---------------------------------------------------------------------------
# prefill + decode: forward and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DECODE_ARCHES)
def test_prefill_decode_matches_forward_and_reference(models, arch):
    """Prefill 32 tokens into a cache of 40, then 3 decode steps: the
    logits against the port's forward at the reference's bars, logits
    and every cache leaf against the reference's within 1e-4."""
    (jm, jp), (tm, tp) = models(arch)
    ref = Ref(jm, jp)
    B, S = 2, 32
    toks = np.random.default_rng(2).integers(0, tm.cfg.vocab_size,
                                             (B, S + 3))
    with torch.no_grad():
        full, _ = tm.forward(tp, {"tokens": torch.as_tensor(toks)})
        lg, cache = tm.prefill(tp, {"tokens": torch.as_tensor(toks[:, :S])},
                               cache_len=S + 8)
    jlg, jcache = ref.run_prefill({"tokens": toks[:, :S]}, S + 8)
    close(lg, full[:, S - 1], TOL_PREFILL)
    close(lg, jlg, TOL_REF)
    assert_cache_close(tm, cache, jcache)
    for t in range(3):
        tok = toks[:, S + t:S + t + 1]
        with torch.no_grad():
            lg, cache = tm.decode_step(tp, torch.as_tensor(tok), cache)
        jlg, jcache = ref.step(tok, jcache)
        close(lg, full[:, S + t], TOL_DECODE)
        close(lg, jlg, TOL_REF)
        assert_cache_close(tm, cache, jcache)
    assert cache["next_pos"].tolist() == [S + 3] * B


@pytest.mark.parametrize("text_from", ["patch_count", "grid_side"])
def test_vlm_decode_after_multimodal_prefill(models, text_from):
    """qwen2-vl-tiny: 8 patch embeds (a 2 x 4 grid) with distinct t/h/w
    streams before 24 text tokens, then 2 decode steps (positions
    broadcast to (3,B,1)), against the reference.  The text's positions
    count on from the patches' count, or from the grid's side as
    Qwen2-VL numbers them: then the next position is lower than the
    prompt's length, and the linear cache (slot = position) overwrites
    prompt slots in both packages (ROADMAP F5)."""
    (jm, jp), (tm, tp) = models("qwen2-vl-7b")
    ref = Ref(jm, jp)
    rng = np.random.default_rng(3)
    B, S_img, S_txt = 2, 8, 24
    grid = np.arange(S_img)
    t0 = S_img if text_from == "patch_count" else 4
    text = np.arange(t0, t0 + S_txt)
    streams = [np.concatenate([x, text]) for x in
               (np.zeros(S_img, int), grid // 4, grid % 4)]
    batch = {"embeds": rng.normal(size=(B, S_img, tm.cfg.frontend_dim))
             .astype(np.float32),
             "tokens": rng.integers(0, tm.cfg.vocab_size, (B, S_txt)),
             "positions": np.broadcast_to(np.stack(streams)[:, None],
                                          (3, B, S_img + S_txt))
             .astype(np.int32).copy()}
    with torch.no_grad():
        lg, cache = tm.prefill(tp, tt(batch), cache_len=S_img + S_txt + 4)
    jlg, jcache = ref.run_prefill(batch, S_img + S_txt + 4)
    assert lg.shape == (B, tm.cfg.vocab_size)
    assert cache["next_pos"].tolist() == [t0 + S_txt] * B
    close(lg, jlg, TOL_REF)
    assert_cache_close(tm, cache, jcache)
    for t in range(2):
        tok = rng.integers(0, tm.cfg.vocab_size, (B, 1))
        with torch.no_grad():
            lg, cache = tm.decode_step(tp, torch.as_tensor(tok), cache)
        jlg, jcache = ref.step(tok, jcache)
        assert torch.isfinite(lg).all()
        close(lg, jlg, TOL_REF)
        assert_cache_close(tm, cache, jcache)


def test_swa_ring_cache_matches_full_attention(models):
    """Mixtral's window: prefill 96 tokens into a ring of 64 slots, then
    4 decode steps: forward at 8e-3, the reference within 1e-4."""
    (jm, jp), (tm, tp) = models("mixtral-8x7b")
    assert tm.cfg.sliding_window == 64
    ref = Ref(jm, jp)
    toks = np.random.default_rng(1).integers(0, tm.cfg.vocab_size, (1, 100))
    with torch.no_grad():
        full, _ = tm.forward(tp, {"tokens": torch.as_tensor(toks)})
        lg, cache = tm.prefill(tp, {"tokens": torch.as_tensor(toks[:, :96])},
                               cache_len=96)
    jlg, jcache = ref.run_prefill({"tokens": toks[:, :96]}, 96)
    assert cache["groups"][0]["k"].shape[2] == 64           # ring = window
    close(lg, jlg, TOL_REF)
    assert_cache_close(tm, cache, jcache)
    for t in range(4):
        tok = toks[:, 96 + t:97 + t]
        with torch.no_grad():
            lg, cache = tm.decode_step(tp, torch.as_tensor(tok), cache)
        jlg, jcache = ref.step(tok, jcache)
        close(lg, full[:, 96 + t], TOL_RING)
        close(lg, jlg, TOL_REF)
        assert_cache_close(tm, cache, jcache)


def test_long_mode_window_applies_only_in_long_mode():
    cfg = tiny_variant(get_config("zamba2-7b"))
    assert cfg.long_context_window > 0 and cfg.sliding_window == 0
    m_short = build_model(cfg, remat=False, device="cpu")
    m_long = build_model(cfg, long_mode=True, remat=False, device="cpu")
    assert m_short.window == 0
    assert m_long.window == cfg.long_context_window
    assert m_long.attn_cache_len(10_000) == cfg.long_context_window
    cache = m_long.init_cache(1, 10_000)
    assert cache["groups"][0]["attn"]["k"].shape[2] == 64


@pytest.mark.parametrize("S", [60, 96])
def test_long_mode_prefill_and_decode_match_reference(models, S):
    """zamba2-tiny in long mode (window 64): a prompt of S tokens, then 6
    decode steps whose ring wraps past the window.  Logits and caches
    match the reference's.  With S within the window they also match the
    long-mode (windowed) forward; past it the reference's prefill keeps
    the first 64 tokens and masks without the window (ROADMAP F4), and
    the port keeps that behaviour."""
    (jm, jp), (tm, tp) = models("zamba2-7b")
    jl = JaxLM(jm.cfg, long_mode=True, remat=False)
    tl = LM(tm.cfg, long_mode=True, device="cpu")
    ref = Ref(jl, jp)
    toks = np.random.default_rng(4).integers(0, tm.cfg.vocab_size,
                                             (1, S + 6))
    with torch.no_grad():
        full, _ = tl.forward(tp, {"tokens": torch.as_tensor(toks)})
        lg, cache = tl.prefill(tp, {"tokens": torch.as_tensor(toks[:, :S])},
                               cache_len=S + 6)
    jlg, jcache = ref.run_prefill({"tokens": toks[:, :S]}, S + 6)
    assert cache["groups"][0]["attn"]["k"].shape[2] == 64
    close(lg, jlg, TOL_REF)
    assert_cache_close(tl, cache, jcache)
    for t in range(6):
        tok = toks[:, S + t:S + t + 1]
        with torch.no_grad():
            lg, cache = tl.decode_step(tp, torch.as_tensor(tok), cache)
        jlg, jcache = ref.step(tok, jcache)
        close(lg, jlg, TOL_REF)
        assert_cache_close(tl, cache, jcache)
        if S <= tl.window:
            close(lg, full[:, S + t], TOL_DECODE)


# ---------------------------------------------------------------------------
# int8 KV
# ---------------------------------------------------------------------------

def test_int8_kv_cache_decode_close_to_fp_and_reference(models):
    """``init_cache`` with ``quant_kv``: 20 decode steps track the fp
    forward (rel < 0.05, the reference's bar), and the int8 codes equal
    the reference's except +-1 at rounding ties."""
    (jm, jp), (tm, tp) = models("llama3.2-1b")
    m_q = LM(tm.cfg, quant_kv=True, device="cpu")
    ref = Ref(JaxLM(jm.cfg, quant_kv=True, remat=False), jp)
    B, S = 2, 20
    toks = np.random.default_rng(1).integers(0, tm.cfg.vocab_size, (B, S))
    with torch.no_grad():
        full, _ = tm.forward(tp, {"tokens": torch.as_tensor(toks)})
    cache = m_q.init_cache(B, 32)
    jcache = JaxLM(jm.cfg, quant_kv=True).init_cache(B, 32)
    assert cache["groups"][0]["k"]["q"].dtype == torch.int8
    assert cache["groups"][0]["k"]["s"].shape == \
        (2, B, 32, tm.cfg.n_kv_heads, 1)
    for t in range(S):
        tok = toks[:, t:t + 1]
        with torch.no_grad():
            lg, cache = m_q.decode_step(tp, torch.as_tensor(tok), cache)
        jlg, jcache = ref.step(tok, jcache)
        rel = float((lg - full[:, t]).abs().max()
                    / (full[:, t].abs().max() + 1e-9))
        assert rel < 0.05, (t, rel)
    got, want = flat(cache_to_numpy(cache, m_q)), \
        flat(jax.tree.map(np.asarray, jcache))
    for k in want:
        if k.endswith("/q"):
            diff = np.abs(got[k].astype(int) - want[k].astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=TOL_REF,
                                       atol=TOL_REF, err_msg=k)
    close(lg, jlg, 1e-3)


# ---------------------------------------------------------------------------
# param counts, registry
# ---------------------------------------------------------------------------

def test_param_count_matches_init():
    for arch in ["llama3.2-1b", "qwen3-14b", "mixtral-8x7b", "rwkv6-7b"]:
        cfg = get_config(arch)
        specs = steps.params_specs(build_model(cfg, device="cpu"),
                                   serve=False)
        n_actual = sum(int(np.prod(s.shape)) for s in tree_leaves(specs))
        n_analytic = cfg.param_count()
        # analytic formula tracks the real tree within 5%
        assert abs(n_actual - n_analytic) / n_actual < 0.05, \
            (arch, n_actual, n_analytic)


def test_registry_complete():
    for arch in ARCHES:
        assert arch in list_configs()
        assert get_config(arch).citation


# ---------------------------------------------------------------------------
# caches across the bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-7b", "mamba2-370m",
                                  "mixtral-8x7b", "llama3.2-1b:int8"])
def test_cache_crosses_the_bridge_both_ways(models, arch):
    """A reference cache continues in the port and a port cache in the
    reference: the next two decode steps give the other package's logits
    and caches (int8: the reference's quantized cache after 4 steps)."""
    name, _, quant = arch.partition(":")
    (jm, jp), (tm, tp) = models(name)
    if quant:
        jm = JaxLM(jm.cfg, quant_kv=True, remat=False)
        tm = LM(tm.cfg, quant_kv=True, device="cpu")
    ref = Ref(jm, jp)
    toks = np.random.default_rng(6).integers(0, tm.cfg.vocab_size, (2, 30))
    if quant:
        jcache = jm.init_cache(2, 40)
        for t in range(4):
            _, jcache = ref.step(toks[:, t:t + 1], jcache)
        with torch.no_grad():
            tcache = tm.init_cache(2, 40)
            for t in range(4):
                _, tcache = tm.decode_step(tp, torch.as_tensor(
                    toks[:, t:t + 1]), tcache)
        start = 4
    else:
        _, jcache = ref.run_prefill({"tokens": toks[:, :24]}, 32)
        with torch.no_grad():
            _, tcache = tm.prefill(tp, {"tokens": torch.as_tensor(
                toks[:, :24])}, cache_len=32)
        start = 24
    # reference -> port, and port -> reference
    from_ref = cache_from_numpy(jax.tree.map(np.asarray, jcache), tm, "cpu")
    to_ref = jax.tree.map(jnp.asarray, cache_to_numpy(tcache, tm))
    for t in range(start, start + 2):
        tok = toks[:, t:t + 1]
        with torch.no_grad():
            lg_p, from_ref = tm.decode_step(tp, torch.as_tensor(tok),
                                            from_ref)
            lg_own, tcache = tm.decode_step(tp, torch.as_tensor(tok), tcache)
        jlg, jcache = ref.step(tok, jcache)
        jlg_p, to_ref = ref.step(tok, to_ref)
        close(lg_p, jlg, TOL_REF)
        close(jlg_p, lg_own, TOL_REF)
        assert_cache_close(tm, from_ref, jcache)
        assert_cache_close(tm, tcache, to_ref)


def test_bridge_refuses_a_foreign_cache():
    cfg = tiny_variant(get_config("llama3.2-1b"))
    m = build_model(cfg, device="cpu")
    other = build_model(tiny_variant(get_config("zamba2-7b")), device="cpu")
    cache = cache_to_numpy(m.init_cache(1, 8), m)
    with pytest.raises(ValueError, match="groups"):
        cache_from_numpy({"groups": cache["groups"]}, m)
    zc = cache_to_numpy(other.init_cache(1, 8), other)
    zc["groups"] = zc["groups"] * 2
    with pytest.raises(ValueError, match="groups"):
        cache_from_numpy(zc, other)
    # same structure as the reference's init_cache
    jm = JaxLM(jax_tiny_variant(jax_get_config("llama3.2-1b")))
    want = flat(jax.tree.map(np.asarray, jm.init_cache(1, 8)))
    got = flat(cache)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and \
            got[k].dtype == want[k].dtype, k


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b"])
def test_run_full_continues_from_init_states(models, arch):
    """``_run_full(init_states=)``: a second stretch of tokens run from
    the recurrent states a first prefill left gives the reference's
    hidden states and states from the same ``init_states``."""
    (jm, jp), (tm, tp) = models(arch)
    toks = np.random.default_rng(7).integers(0, tm.cfg.vocab_size, (2, 40))
    _, jcache = Ref(jm, jp).run_prefill({"tokens": toks[:, :24]}, 24)
    with torch.no_grad():
        _, tcache = tm.prefill(tp, {"tokens": torch.as_tensor(toks[:, :24])},
                               cache_len=24)
    jstates = jcache["groups"]
    if arch == "zamba2-7b":         # the attention cache does not carry
        jstates = [dict(g, attn=None) if "attn" in g else g
                   for g in jstates]
    pos = np.broadcast_to(np.arange(24, 40, dtype=np.int32), (2, 16)).copy()
    jp_c = jm.cast_params(jp)
    jx, _ = jm.embed_inputs(jp_c, {"tokens": jnp.asarray(toks[:, 24:])})
    jout, jc, _ = jm._run_full(jp_c, jx, jnp.asarray(pos), cache_len=16,
                               init_states=jstates)
    with torch.no_grad():
        tp_c = tm.cast_params(tp)
        tx, _ = tm.embed_inputs(tp_c, {"tokens": torch.as_tensor(
            toks[:, 24:])})
        tout, tc, _ = tm._run_full(tp_c, tx, torch.as_tensor(pos),
                                   cache_len=16,
                                   init_states=tcache["groups"])
    close(tout, jout, TOL_REF)
    assert_cache_close(tm, {"groups": tc, "next_pos": torch.zeros(2)},
                       {"groups": jc, "next_pos": np.zeros(2)})
