"""Training of the MoE, SSM and hybrid families on the port, against the
reference on the CPU: ``LM.loss`` and every gradient leaf against
``jax.value_and_grad(model.loss)`` on the same numpy-seeded params and
batch (tiny mixtral, deepseek-moe, mamba2, rwkv6, zamba2); the MoE's
gather-only dispatch and combine (``gradcheck`` in float64, backwards
that gather, capacity drops against the reference's ``moe_apply``);
remat; three ``train_lm`` steps against the reference's; and
``launch.train --tiny`` for every family."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_stack import family_models
from torch.utils._python_dispatch import TorchDispatchMode

from repro import training as jtraining
from repro.models import moe as JMOE
from repro.training.task import ArithmeticTask as JArithmeticTask

from repro_torch.bridge import params_to_numpy
from repro_torch.launch import train as launch_train
from repro_torch.models import moe as MOE
from repro_torch.models.model import LM, tree_leaves, tree_map
from repro_torch.training import TrainConfig, train_lm
from repro_torch.training.task import ArithmeticTask

FAMILIES = ["mixtral-8x7b", "deepseek-moe-16b", "mamba2-370m", "rwkv6-7b",
            "zamba2-7b"]
RTOL_LOSS = 1e-5
RTOL_GRAD, ATOL_GRAD = 1e-4, 1e-5
# rwkv6's chunked WKV gradient in fp32: at 24 tokens the reference's own
# embed gradient is 4.4e-5 from a float64 run of the same algorithm (the
# port's 4.0e-5; largest |g| 1.68), so no fp32 version meets 1e-5 there
ATOL_GRAD_RWKV = 5e-5
# the MoE block's loss sum(y^2) over 64 tokens has gradients up to |g|
# 384, where both packages' fp32 grads lie up to 8x the 1e-4 / 1e-5 bar
# from float64: the block is held at the reference's own MoE grad
# tolerance (tests/test_mixers.py), the model-level cases at the bar
TOL_MOE_BLOCK = 3e-3
# the model-level capacity case: 48 tokens x top-2 over 4 experts at
# capacity 8 keep 32 of 96 replicas
SMALL_CAPACITY_FACTOR = 0.25


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = family_models(arch, seed=3)
        return cache[arch]

    return get


def batch_np(cfg, B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)),
            "loss_mask": (rng.random((B, S)) < 0.8).astype(np.float32)}


def flat(tree, prefix=""):
    """{path: array} of a nested dict/list of arrays."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def torch_loss_and_grads(model, params, batch):
    leaves = [p.detach().clone().requires_grad_(True)
              for p in tree_leaves(params)]
    it = iter(leaves)
    p = tree_map(lambda _: next(it), params)
    loss = model.loss(p, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    it = iter(grads)
    return float(loss.detach()), params_to_numpy(tree_map(lambda _: next(it), params))


def assert_grads_close(got, want, rtol=RTOL_GRAD, atol=ATOL_GRAD):
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def small_capacity(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=SMALL_CAPACITY_FACTOR))


@pytest.mark.parametrize("arch", FAMILIES + ["deepseek-moe-16b:capacity"])
def test_loss_and_grads_match_reference(models, arch):
    """``:capacity`` forces a small expert capacity in both packages, so
    replicas are dropped inside ``LM.loss``."""
    name, _, variant = arch.partition(":")
    (jm, jp), (tm, tp) = models(name)
    if variant:
        jm = type(jm)(small_capacity(jm.cfg), remat=False)
        tm = LM(small_capacity(tm.cfg), device="cpu")
        m = tm.cfg.moe
        replicas = 2 * 24 * m.top_k                 # batch_np's tokens
        cap = int(m.capacity_factor * replicas / m.n_experts) + 1
        assert m.n_experts * (-(-cap // 8) * 8) == 32 < replicas
    b = batch_np(tm.cfg)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, bb: jm.loss(p, bb)))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tl, tg = torch_loss_and_grads(tm, tp, {k: torch.as_tensor(v)
                                           for k, v in b.items()})
    np.testing.assert_allclose(tl, float(jl), rtol=RTOL_LOSS)
    assert_grads_close(tg, jax.tree.map(np.asarray, jg),
                       atol=ATOL_GRAD_RWKV if name == "rwkv6-7b"
                       else ATOL_GRAD)


def test_remat_gives_the_same_grads(models):
    """Per-layer (per super-block) recompute changes nothing: the MoE's
    aux term and the hybrid's shared block go through it too."""
    for arch in ("mixtral-8x7b", "zamba2-7b"):
        _, (tm, tp) = models(arch)
        b = {k: torch.as_tensor(v) for k, v in batch_np(tm.cfg).items()}
        out = [torch_loss_and_grads(LM(tm.cfg, remat=r, device="cpu"), tp, b)
               for r in (True, False)]
        assert out[0][0] == out[1][0]
        for k, v in flat(out[1][1]).items():
            np.testing.assert_array_equal(flat(out[0][1])[k], v, err_msg=k)


# ---------------------------------------------------------------------------
# MoE dispatch and combine
# ---------------------------------------------------------------------------

def _routing(S=6, E=3, k=2, C=3, seed=0):
    """Random top-k routes with capacity drops, and their maps."""
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(np.stack([rng.permutation(E)[:k]
                                    for _ in range(S)]))
    return MOE.dispatch_plan(idx, E, C), k


def test_dispatch_and_combine_pass_gradcheck():
    (src_token, slot_valid, slot, keep, src_replica), k = _routing()
    assert not keep.all() and slot_valid.any()          # drops happen
    x = torch.randn(6, 4, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a: MOE._Dispatch.apply(a, src_token, slot_valid, slot, keep,
                                      k), (x,))
    ye = torch.randn(slot_valid.numel(), 4, dtype=torch.float64,
                     requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a: MOE._Combine.apply(a, slot, keep, src_replica,
                                     slot_valid), (ye,))


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.__name__)
        return func(*args, **(kwargs or {}))


def test_dispatch_and_combine_backwards_are_gathers():
    """Neither backward scatters (autograd's gradient of ``x[idx]`` would
    be an ``index_put`` with accumulation)."""
    (src_token, slot_valid, slot, keep, src_replica), k = _routing()
    x = torch.randn(6, 4, requires_grad=True)
    xe = MOE._Dispatch.apply(x, src_token, slot_valid, slot, keep, k)
    ys = MOE._Combine.apply(xe * 2.0, slot, keep, src_replica, slot_valid)
    with _Ops() as ops:
        ys.sum().backward()
    assert any(n.startswith("index") for n in ops.names), ops.names
    bad = [n for n in ops.names if "scatter" in n or "put" in n
           or "index_add" in n]
    assert not bad, ops.names
    # token t's gradient counts the kept replicas of t, times 2
    want = 2.0 * keep.reshape(6, k).sum(1).float()[:, None].expand(6, 4)
    np.testing.assert_array_equal(x.grad.numpy(), want.numpy())


@pytest.fixture(scope="module")
def moe_setup(models):
    (jm, jp), (tm, tp) = models("deepseek-moe-16b")
    jblk = jax.tree.map(lambda a: a[0], jp["groups"][0]["moe"])
    tblk = tree_map(lambda a: a[0], tp["groups"][0]["moe"])
    x = np.random.default_rng(0).normal(size=(64, tm.cfg.d_model)) \
        .astype(np.float32)
    return jm.cfg, jblk, tm.cfg, tblk, x


@pytest.mark.parametrize("capacity", [0, 8])
def test_moe_grads_match_reference_with_capacity_drops(moe_setup, capacity):
    """Loss sum(y^2) + aux of one MoE block, grads to every weight and to
    x, against the reference's ``moe_apply`` at the same capacity (8
    drops replicas: 128 of them over 4 experts), at ``TOL_MOE_BLOCK``."""
    jcfg, jblk, tcfg, tblk, x = moe_setup

    def jloss(p, xx):
        y, aux = JMOE.moe_apply(p, xx, jcfg, capacity=capacity)
        return (y ** 2).sum() + aux

    jl, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jblk, jnp.asarray(x))
    tp = tree_map(lambda a: a.clone().requires_grad_(True), tblk)
    tx = torch.as_tensor(x).requires_grad_(True)
    y, aux = MOE.moe_apply(tp, tx, tcfg, capacity=capacity)
    tl = (y ** 2).sum() + aux
    tl.backward()
    if capacity:
        y_full, _ = MOE.moe_apply(tblk, torch.as_tensor(x), tcfg)
        assert not torch.allclose(y.detach(), y_full)    # replicas dropped
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL_LOSS)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                               rtol=TOL_MOE_BLOCK, atol=TOL_MOE_BLOCK)
    assert_grads_close(tree_map(lambda a: a.grad.numpy(), tp),
                       jax.tree.map(np.asarray, jgp), rtol=TOL_MOE_BLOCK,
                       atol=TOL_MOE_BLOCK)


def test_moe_grads_match_dense_oracle(moe_setup):
    """The port's mirror of the reference's sparse-vs-dense grad test:
    dropless dispatch and the loop over experts give the same grads."""
    _, _, cfg, blk, x = moe_setup
    grads = []
    for fn in (MOE.moe_apply, MOE.moe_apply_dense):
        p = tree_map(lambda a: a.clone().requires_grad_(True), blk)
        xx = torch.as_tensor(x).requires_grad_(True)
        (fn(p, xx, cfg)[0] ** 2).sum().backward()
        grads.append((p, xx.grad))
    for name in ("w_up", "w_down", "w_gate"):
        np.testing.assert_allclose(grads[0][0][name].grad.numpy(),
                                   grads[1][0][name].grad.numpy(),
                                   rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(grads[0][1].numpy(), grads[1][1].numpy(),
                               rtol=3e-3, atol=3e-3)


# ---------------------------------------------------------------------------
# The training loop and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-370m"])
def test_train_lm_history_matches_reference(models, arch):
    """Three ``train_lm`` steps (the same batches) from bridged params:
    the loss history and the params after the last step."""
    (jm, jp), (tm, tp) = models(arch)
    tcfg = dict(steps=3, batch=4, log_every=1)
    jparams, jhist = jtraining.train_lm(
        jm, jp, JArithmeticTask(n_ops=3, seq_len=32),
        jtraining.TrainConfig(**tcfg))
    tparams, thist = train_lm(tm, tp, ArithmeticTask(n_ops=3, seq_len=32),
                              TrainConfig(**tcfg))
    np.testing.assert_allclose(thist, jhist, rtol=RTOL_LOSS)
    want = flat(jax.tree.map(np.asarray, jparams))
    for k, v in flat(params_to_numpy(tparams)).items():
        np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_launcher_runs_every_family_tiny(arch):
    model, params, hist = launch_train.main(
        ["--arch", arch, "--tiny", "--steps", "2", "--batch", "4",
         "--device", "cpu"])
    assert model.cfg.name == f"{arch}-tiny" and not model.remat
    assert len(hist) == 2 and np.all(np.isfinite(hist))
