"""``repro_torch.launch.steps`` against ``repro.launch.steps`` on the CPU:
input, cache and param specs (shapes, dtype names, skip reasons) for the
10 architectures x 4 input shapes without allocating, ``materialize``,
and one train, prefill and decode step on tiny configs against the
reference's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_stack import family_models

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import steps as jsteps
from repro.training.optimizer import adamw_init as jax_adamw_init

from repro_torch.bridge import cache_to_numpy, params_to_numpy
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch import steps
from repro_torch.models.model import LM, tree_map
from repro_torch.training.optimizer import adamw_init

ARCHES = [
    "deepseek-moe-16b", "zamba2-7b", "hubert-xlarge", "phi3-mini-3.8b",
    "qwen2-vl-7b", "llama3.2-1b", "mixtral-8x7b", "qwen3-14b",
    "rwkv6-7b", "yi-6b",
]
TOL_REF = 1e-4


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def same_specs(got, want):
    """Port ``Spec``s against the reference's ShapeDtypeStructs."""
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert (tuple(g.shape), str(g.dtype).split(".")[-1]) == \
            (tuple(w.shape), np.dtype(w.dtype).name), k


@pytest.mark.parametrize("arch", ARCHES)
def test_specs_match_reference(arch):
    """For each input shape: the skip reason; the batch specs; for decode
    shapes that run, the cache specs (long mode for long_500k); params
    as master fp32 and as served (int8 expert banks for the MoE)."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        jshape = JAX_SHAPES[name]
        reason = steps.skip_reason(cfg, shape)
        assert reason == jsteps.skip_reason(jcfg, jshape)
        assert steps.is_long(shape) == jsteps.is_long(jshape)
        same_specs(steps.input_specs(cfg, shape),
                   jsteps.input_specs(jcfg, jshape))
        if shape.kind == "decode" and reason is None:
            model = steps.build_model_for(cfg, shape, device="cpu")
            jmodel = jsteps.build_model_for(jcfg, jshape)
            assert model.long_mode == jmodel.long_mode
            same_specs(steps.cache_specs(model, shape),
                       jsteps.cache_specs(jmodel, jshape))
    model = LM(cfg, device="cpu")
    jmodel = jsteps.build_model_for(jcfg, JAX_SHAPES["train_4k"])
    # served with quant_moe: cast to the compute dtype, and for the MoE
    # archs int8 expert banks
    for kw in (dict(serve=False), dict(serve=True, quant_moe=True)):
        same_specs(steps.params_specs(model, **kw),
                   jsteps.params_specs(jmodel, **kw))


def test_cache_specs_allocate_nothing_and_mark_empty_slots():
    cfg = get_config("zamba2-7b")
    shape = INPUT_SHAPES["long_500k"]
    model = steps.build_model_for(cfg, shape, device="cpu")
    assert model.long_mode and model.window == cfg.long_context_window
    spec = steps.cache_specs(model, shape)
    attn = spec["groups"][0]["attn"]
    assert attn["k"].shape[2] == cfg.long_context_window     # the ring
    assert attn["pos"].fill == "empty" and attn["k"].fill == "zeros"
    cache = steps.materialize(spec, "cpu", torch.Generator())
    assert int(cache["groups"][0]["attn"]["pos"].max()) == -1
    assert cache["next_pos"].tolist() == [0]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-vl-7b",
                                  "hubert-xlarge"])
def test_materialize_gives_the_specs(arch):
    cfg = dataclasses.replace(get_config(arch), vocab_size=1000)
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], global_batch=2,
                                seq_len=64)
    specs = steps.input_specs(cfg, shape)
    batch = steps.materialize(specs, "cpu", torch.Generator().manual_seed(0))
    for k, s in specs.items():
        assert tuple(batch[k].shape) == s.shape and batch[k].dtype == s.dtype
    assert int(batch["labels"].max()) < 1000 and int(batch["labels"].min()) >= 0
    assert bool((batch["loss_mask"] == 1).all())
    if "positions" in batch:
        assert batch["positions"][2, 1].tolist() == list(range(64))


# ---------------------------------------------------------------------------
# the steps on tiny configs against the reference's
# ---------------------------------------------------------------------------

def np_batch(cfg, shape, seed=0):
    """The same batch for both packages: materialized on the port,
    handed to the reference as jnp arrays."""
    b = steps.materialize(steps.input_specs(cfg, shape), "cpu",
                          torch.Generator().manual_seed(seed))
    return b, {k: jnp.asarray(v.numpy()) for k, v in b.items()}


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x7b",
                                  "zamba2-7b"])
def test_train_step_matches_reference(arch):
    """One ``build_train_step`` step (loss, grads, AdamW) from the same
    params and batch: the loss and the params after the step."""
    (jm, jp), (tm, tp) = family_models(arch, seed=7)
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], global_batch=2,
                                seq_len=32)
    b, jb = np_batch(tm.cfg, shape)
    jparams, _, jloss = jax.jit(jsteps.build_train_step(jm))(
        jp, jax_adamw_init(jp), jb)
    params = tree_map(lambda a: a.clone(), tp)
    params, state, loss = steps.build_train_step(
        steps.build_model_for(tm.cfg, shape, device="cpu"))(
        params, adamw_init(params), b)
    assert int(state["step"]) == 1
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = flat(jax.tree.map(np.asarray, jparams))
    for k, v in flat(params_to_numpy(params)).items():
        np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-vl-7b", "rwkv6-7b",
                                  "hubert-xlarge"])
def test_prefill_and_decode_steps_match_reference(arch):
    """``build_prefill_step`` (an encoder's is ``forward``) and two
    ``build_decode_step`` steps on its cache."""
    (jm, jp), (tm, tp) = family_models(arch, seed=8)
    shape = dataclasses.replace(INPUT_SHAPES["prefill_32k"], global_batch=2,
                                seq_len=32)
    b, jb = np_batch(tm.cfg, shape)
    out = steps.build_prefill_step(tm, 40)(tp, b)
    jout = jax.jit(jsteps.build_prefill_step(jm, 40))(jp, jb)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jout[0]),
                               rtol=TOL_REF, atol=TOL_REF)
    if tm.cfg.arch_type == "encoder":
        assert out[1] is None and jout[1] is None
        return
    cache, jcache = out[1], jout[1]
    decode = steps.build_decode_step(tm)
    jdecode = jax.jit(jsteps.build_decode_step(jm))
    dshape = dataclasses.replace(INPUT_SHAPES["decode_32k"], global_batch=2)
    for seed in (1, 2):
        tb, jtb = np_batch(tm.cfg, dshape, seed)
        lg, cache = decode(tp, tb, cache)
        jlg, jcache = jdecode(jp, jtb, jcache)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg),
                                   rtol=TOL_REF, atol=TOL_REF)
    assert not lg.requires_grad
    got = flat(cache_to_numpy(cache, tm))
    for k, v in flat(jax.tree.map(np.asarray, jcache)).items():
        np.testing.assert_allclose(got[k], v, rtol=TOL_REF, atol=TOL_REF,
                                   err_msg=k)
