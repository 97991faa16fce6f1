"""The port's training substrate (``repro_torch.training``): the 8 tests
of ``tests/test_training.py`` on the port, then parity with
``repro.training`` on the CPU from bridged params and the same batches —
the schedule, one AdamW update, the loss and grads of ``LM.loss`` and
``prm_loss_fn``, one ``_fit`` step, 20-step loss histories, and
checkpoints read across the two packages."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_stack import make_stacks
from repro import training as jtraining
from repro.training import checkpoint as jcheckpoint
from repro.training.task import ArithmeticTask as JArithmeticTask

from repro_torch.bridge import params_to_numpy
from repro_torch.configs import get_config
from repro_torch.models.model import build_model, tree_leaves, tree_map
from repro_torch.training import (AdamWConfig, ArithmeticTask, TrainConfig,
                                  adamw_init, adamw_update, cosine_lr,
                                  prm_loss_fn, train_lm, train_prm)
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import global_norm
from repro_torch.training.task import VOCAB_SIZE, decode, encode


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

def test_cosine_schedule():
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    assert float(cosine_lr(cfg, 0)) == 0.0
    assert abs(float(cosine_lr(cfg, 10)) - 1e-3) < 1e-9
    assert abs(float(cosine_lr(cfg, 100)) - 1e-4) < 1e-6
    assert float(cosine_lr(cfg, 55)) > float(cosine_lr(cfg, 90))


def test_adamw_reduces_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                      weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state = adamw_update(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 0.05


def test_adamw_grad_clip():
    cfg = AdamWConfig(lr=0.1, grad_clip=1.0, warmup_steps=0)
    params = {"w": torch.zeros(3)}
    state = adamw_init(params)
    huge = {"w": torch.full((3,), 1e9)}
    params2, _ = adamw_update(cfg, params, huge, state)
    assert float(params2["w"].abs().max()) < 1.0  # clipped step


# ---------------------------------------------------------------------------
# Task
# ---------------------------------------------------------------------------

def test_task_roundtrip_and_oracle():
    task = ArithmeticTask(n_ops=3)
    rng = np.random.default_rng(0)
    prompt, steps, ans = task.sample_problem(rng)
    text = prompt + "".join(steps) + f"A{ans}\n"
    toks = encode(text)
    assert decode(toks) == text
    assert task.extract_answer(toks) == ans
    assert task.check_trajectory(toks)
    # corrupt a step result -> oracle rejects
    bad = text.replace(steps[1], steps[1][:-2] +
                       str((int(steps[1][-2]) + 3) % 10) + "\n")
    assert not task.check_trajectory(encode(bad))


def test_prm_labels_flip_after_corruption():
    task = ArithmeticTask(n_ops=3)
    rng = np.random.default_rng(3)
    for _ in range(10):
        b = task.prm_batch(rng, 1, corrupt_p=1.0)
        lab = b["labels"][0][b["loss_mask"][0] > 0]
        # monotone: once wrong, stays wrong
        assert (np.diff(lab) <= 0).all()
        assert lab[-1] == 0.0


# ---------------------------------------------------------------------------
# Checkpointing
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.ones((3, 4)), "b": [torch.zeros(2), torch.arange(5)],
            "c": {"d": torch.tensor(2.0)}}
    path = os.path.join(tmp_path, "ckpt.npz")
    checkpoint.save(path, tree)
    like = tree_map(torch.zeros_like, tree)
    out = checkpoint.load(path, like)
    for x, y in zip(tree_leaves(tree), tree_leaves(out)):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# Short fits (loss decreases)
# ---------------------------------------------------------------------------

def _short_fit_model(with_value_head: bool, seed: int):
    cfg = dataclasses.replace(get_config("tiny-lm"), vocab_size=VOCAB_SIZE,
                              n_layers=2, d_model=128, n_heads=4,
                              n_kv_heads=2, d_ff=256)
    model = build_model(cfg, with_value_head=with_value_head, device="cpu")
    return model, model.init(torch.Generator().manual_seed(seed))


def test_lm_short_fit():
    task = ArithmeticTask(n_ops=2, seq_len=48)
    model, params = _short_fit_model(False, 0)
    trained, hist = train_lm(model, params, task,
                             TrainConfig(steps=60, batch=16, log_every=30))
    assert hist[-1] < hist[0] * 0.75
    # detached leaves without grad; the caller's tree is untouched
    for p, q in zip(tree_leaves(trained), tree_leaves(params)):
        assert p.is_leaf and not p.requires_grad and p.grad_fn is None
        assert not q.requires_grad
    assert not torch.equal(trained["ln_f"], params["ln_f"])


def test_prm_short_fit():
    task = ArithmeticTask(n_ops=2, seq_len=48)
    model, params = _short_fit_model(True, 1)
    _, hist = train_prm(model, params, task,
                        TrainConfig(steps=60, batch=16, log_every=30))
    assert hist[-1] < hist[0]


# ---------------------------------------------------------------------------
# Parity with repro.training
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stacks():
    return make_stacks(0)


def test_task_batches_equal_reference():
    task, jtask = ArithmeticTask(n_ops=3, seq_len=64), \
        JArithmeticTask(n_ops=3, seq_len=64)
    for make in ("lm_batch", "prm_batch"):
        a = getattr(task, make)(np.random.default_rng(5), 6)
        b = getattr(jtask, make)(np.random.default_rng(5), 6)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_cosine_lr_matches_reference():
    """Warmup steps equal; cosine steps within what one ulp of jnp's
    float32 cosine can carry: one ulp of (1 + cos) times 0.5 (1 -
    min_lr_frac) lr, plus one ulp of the result for each of the two
    roundings after it.  jnp's cosine is not always correctly rounded
    and near the end of the schedule (1 + cos) amplifies its last bit
    (jax's own eager and jitted schedules differ by up to 8 ulp there);
    the port rounds the cosine once from float64."""
    for cfg in (AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100),
                AdamWConfig(), AdamWConfig(lr=3e-4, warmup_steps=0,
                                           total_steps=7),
                AdamWConfig(total_steps=400)):
        jcfg = jtraining.AdamWConfig(**dataclasses.asdict(cfg))
        steps = np.arange(cfg.total_steps + 1)
        got = np.array([float(cosine_lr(cfg, int(s))) for s in steps],
                       np.float32)
        want = np.array([np.asarray(jtraining.cosine_lr(jcfg, int(s)))
                         for s in steps])
        warm = steps < cfg.warmup_steps
        np.testing.assert_array_equal(got[warm], want[warm])
        prog = np.clip((steps - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
        one_plus_cos = (1 + np.cos(np.pi * prog)).astype(np.float32)
        bound = 2 * np.spacing(np.abs(want)) + 0.5 * (
            1 - cfg.min_lr_frac) * cfg.lr * np.spacing(one_plus_cos)
        assert np.all(np.abs(got.astype(np.float64) - want)[~warm]
                      <= bound[~warm])


@pytest.mark.parametrize("clipped", [False, True])
def test_adamw_update_matches_reference(clipped):
    """One update from a state with nonzero moments (step 4), with the
    global norm below and far above the clip."""
    rng = np.random.default_rng(11)
    shapes = {"a": (3, 4), "b": [(5,), (2, 3)], "c": {"d": (7,)}}

    def draw(scale=1.0, positive=False):
        def one(shape):
            x = rng.normal(size=shape) * scale
            return (np.abs(x) if positive else x).astype(np.float32)
        return jax.tree.map(one, shapes, is_leaf=lambda s: isinstance(
            s, tuple))

    np_params, np_grads = draw(), draw(1e3 if clipped else 1e-2)
    np_m, np_v = draw(0.1), draw(0.01, positive=True)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=20)
    jcfg = jtraining.AdamWConfig(**dataclasses.asdict(cfg))
    jp, jstate = jtraining.adamw_update(
        jcfg, jax.tree.map(jnp.asarray, np_params),
        jax.tree.map(jnp.asarray, np_grads),
        {"m": jax.tree.map(jnp.asarray, np_m),
         "v": jax.tree.map(jnp.asarray, np_v),
         "step": jnp.asarray(4, jnp.int32)})
    to_t = lambda t: jax.tree.map(torch.tensor, t)  # noqa: E731
    tgrads = to_t(np_grads)
    gnorm = float(global_norm(tgrads))
    assert (gnorm > cfg.grad_clip) == clipped
    tp, tstate = adamw_update(
        cfg, to_t(np_params), tgrads,
        {"m": to_t(np_m), "v": to_t(np_v),
         "step": torch.tensor(4, dtype=torch.int32)})
    assert int(tstate["step"]) == int(jstate["step"]) == 5
    for got, want in ((tp, jp), (tstate["m"], jstate["m"]),
                      (tstate["v"], jstate["v"])):
        got = params_to_numpy(got)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6,
                                       atol=0)


def _batches(kind: str, batch: int = 6):
    b = getattr(ArithmeticTask(n_ops=3, seq_len=48), kind)(
        np.random.default_rng(2), batch)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.as_tensor(v) for k, v in b.items()})


def _leaf_grads(loss_fn, params):
    """(loss, grads as a numpy tree) with autograd on leaf copies."""
    leaves = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                      params)
    loss = loss_fn(leaves)
    value = float(loss.detach())
    grads = iter(torch.autograd.grad(loss, tree_leaves(leaves),
                                     allow_unused=True,
                                     materialize_grads=True))
    return value, params_to_numpy(tree_map(lambda _: next(grads), leaves))


@pytest.mark.parametrize("which", ["lm_loss", "prm_loss"])
def test_loss_and_grads_match_reference(stacks, which):
    (jlm, jprm, _), (tlm, tprm, _) = stacks
    if which == "lm_loss":
        (jm, jp), (tm, tp) = jlm, tlm
        jb, tb = _batches("lm_batch")
        jfn = lambda p: jm.loss(p, jb)  # noqa: E731
        tfn = lambda p: tm.loss(p, tb)  # noqa: E731
    else:
        (jm, jp), (tm, tp) = jprm, tprm
        jb, tb = _batches("prm_batch")
        jfn = lambda p: jtraining.prm_loss_fn(jm, p, jb)  # noqa: E731
        tfn = lambda p: prm_loss_fn(tm, p, tb)  # noqa: E731
    jloss, jgrads = jax.value_and_grad(jfn)(jp)
    tloss, tgrads = _leaf_grads(tfn, tp)
    np.testing.assert_allclose(tloss, float(jloss), rtol=1e-5)
    got, want = jax.tree.leaves(tgrads), jax.tree.leaves(jgrads)
    assert len(want) == len(got)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-6)


def _train_both(stacks, which, steps, batch=8, log_every=1):
    (jlm, jprm, _), (tlm, tprm, _) = stacks
    (jm, jp), (tm, tp) = (jlm, tlm) if which == "lm" else (jprm, tprm)
    jfit = jtraining.train_lm if which == "lm" else jtraining.train_prm
    tfit = train_lm if which == "lm" else train_prm
    jout = jfit(jm, jp, JArithmeticTask(n_ops=3, seq_len=48),
                jtraining.TrainConfig(steps=steps, batch=batch,
                                      log_every=log_every))
    tout = tfit(tm, tp, ArithmeticTask(n_ops=3, seq_len=48),
                TrainConfig(steps=steps, batch=batch, log_every=log_every))
    return jout, tout


@pytest.mark.parametrize("which", ["lm", "prm"])
def test_one_fit_step_matches_reference(stacks, which):
    (jparams, jhist), (tparams, thist) = _train_both(stacks, which, 1)
    np.testing.assert_allclose(thist, jhist, rtol=1e-5)
    got = jax.tree.leaves(params_to_numpy(tparams))
    want = jax.tree.leaves(jparams)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)


def test_on_step_sees_each_loss_and_the_clipped_grad_norm(stacks):
    _, (tlm, _, _) = stacks
    tm, tp = tlm
    seen = []
    task = ArithmeticTask(n_ops=3, seq_len=48)
    _, hist = train_lm(tm, tp, task, TrainConfig(steps=2, batch=8,
                                                 log_every=1),
                       on_step=lambda *a: seen.append(a))
    assert [i for i, _, _ in seen] == [0, 1]
    assert [float(l) for _, l, _ in seen] == hist
    # step 0's norm is that of the grads of the loss on the first batch
    batch = {k: torch.as_tensor(v) for k, v in
             task.lm_batch(np.random.default_rng(0), 8).items()}
    _, grads = _leaf_grads(lambda p: tm.loss(p, batch), tp)
    want = np.sqrt(sum(np.sum(np.square(g.astype(np.float64)))
                       for g in jax.tree.leaves(grads)))
    np.testing.assert_allclose(float(seen[0][2]), want, rtol=1e-5)


@pytest.mark.parametrize("which", ["lm", "prm"])
def test_loss_history_matches_reference(stacks, which):
    (_, jhist), (_, thist) = _train_both(stacks, which, 20)
    assert len(thist) == len(jhist) == 20
    np.testing.assert_allclose(thist, jhist, rtol=1e-4)


def test_checkpoints_cross_packages(stacks, tmp_path):
    """A reference-written file loads into the port and a port-written
    file into the reference, bitwise, for params and AdamW state."""
    (jlm, _, _), (tlm, _, _) = stacks
    (jm, jp), (tm, tp) = jlm, tlm
    jtree = {"params": jp,
             "opt": jtraining.adamw_init(jp)}
    ttree = {"params": tp, "opt": adamw_init(tp)}
    ref_file = os.path.join(tmp_path, "from_ref.npz")
    jcheckpoint.save(ref_file, jtree)
    loaded = checkpoint.load(ref_file, tree_map(torch.zeros_like, ttree),
                             device="cpu")
    for g, w in zip(jax.tree.leaves(params_to_numpy(loaded)),
                    jax.tree.leaves(jtree)):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))

    port_file = os.path.join(tmp_path, "from_port")
    trained = tree_map(lambda p: p * 1.5 + 0.25, tp)
    checkpoint.save(port_file, {"params": trained, "opt": adamw_init(tp)})
    back = jcheckpoint.load(port_file, jax.tree.map(jnp.zeros_like, jtree))
    for g, w in zip(jax.tree.leaves(back["params"]),
                    jax.tree.leaves(params_to_numpy(trained))):
        np.testing.assert_array_equal(np.asarray(g), w)
    assert int(back["opt"]["step"]) == 0


def test_checkpoint_load_rejects_shape_and_places_on_device(tmp_path):
    path = os.path.join(tmp_path, "c.npz")
    checkpoint.save(path, {"w": torch.ones(3, 2)})
    out = checkpoint.load(path, {"w": torch.zeros(3, 2,
                                                  dtype=torch.float64)},
                          device="cpu")
    assert out["w"].dtype == torch.float64 and out["w"].device.type == "cpu"
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load(path, {"w": torch.zeros(2, 3)})

