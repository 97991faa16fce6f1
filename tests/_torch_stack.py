"""Shared fixtures of the port's parity tests: the same tiny LM, PRM and
embedder in both packages, and the tiny variants of the model families,
on the CPU.  Params are made with numpy from
a seed in the reference's pytree layout and scales (the tree from
``jax.eval_shape`` of the reference init, so nothing compiles), handed
to ``repro`` as jnp arrays and to the port through ``repro_torch.bridge``.
Norm weights are 1 + noise rather than ones, so a misrouted norm weight
cannot hide."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import tiny_variant as jax_tiny_variant
from repro.models.model import build_model as jax_build_model
from repro.training.task import VOCAB_SIZE

from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs import tiny_variant as torch_tiny_variant
from repro_torch.models.model import build_model as torch_build_model

# The parity tests run at tiny sizes beside other test workers: a few
# intra-op threads per process keep them from oversubscribing the cores.
torch.set_num_threads(2)

TINY_LM = dict(vocab_size=VOCAB_SIZE, n_layers=2, d_model=128, n_heads=4,
               n_kv_heads=2, d_ff=256)


def configs(getter):
    """(lm, embedder) tiny configs from one package's registry."""
    lm = dataclasses.replace(getter("tiny-lm"), **TINY_LM)
    emb = dataclasses.replace(getter("tiny-embedder"), vocab_size=VOCAB_SIZE)
    return lm, emb


def numpy_params(model, seed: int):
    """Reference-layout params for ``model`` drawn with numpy, in the
    reference init's scales per leaf name (every family's leaves)."""
    return numpy_tree(model.init, seed)


def numpy_tree(init, seed: int):
    """The tree ``init(key)`` returns (its shapes from ``jax.eval_shape``,
    so nothing compiles), drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)

    def fill(path, sd):
        name = str(getattr(path[-1], "key", ""))
        shape = sd.shape
        if name.startswith("ln") or name.endswith("_norm") \
                or name in ("norm_w", "gn_w"):
            x = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "embed":
            x = 0.02 * rng.normal(size=shape)
        elif name == "mu":                     # token-shift mix in (0, 1)
            x = rng.uniform(0.25, 0.75, size=shape)
        elif name == "A_log":
            x = np.log(np.linspace(1.0, 8.0, shape[-1])) \
                + 0.05 * rng.normal(size=shape)
        elif name == "D":
            x = 1.0 + 0.1 * rng.normal(size=shape)
        elif name in ("dt_bias", "conv_b", "gn_b", "u", "conv_w"):
            x = 0.1 * rng.normal(size=shape)
        elif name == "w_bias":
            x = -0.5 + 0.1 * rng.normal(size=shape)
        elif name == "w2":                     # rwkv decay lora, scale 0.1
            x = 0.1 * rng.normal(size=shape) / np.sqrt(shape[-2])
        else:                                  # dense: std 1/sqrt(d_in)
            x = rng.normal(size=shape) / np.sqrt(shape[-2])
        return x.astype(np.float32)

    shapes = jax.eval_shape(init, jax.random.key(0))
    return jax.tree_util.tree_map_with_path(fill, shapes)


def family_models(arch: str, seed: int = 0):
    """((jax lm, params), (torch lm, params)) of ``arch``'s tiny variant
    (``tiny_variant`` of both registries), the same numpy params."""
    jcfg = jax_tiny_variant(jax_get_config(arch))
    tcfg = torch_tiny_variant(torch_get_config(arch))
    jm = jax_build_model(jcfg, remat=False)
    tm = torch_build_model(tcfg, device="cpu")
    npp = numpy_params(jm, seed)
    return ((jm, jax.tree.map(jnp.asarray, npp)),
            (tm, params_from_jax(npp, tcfg, "cpu")))


def make_stacks(seed: int = 0):
    """((lm, params), (prm, params), (emb, params)) for jax and torch."""
    jlm_cfg, jemb_cfg = configs(jax_get_config)
    tlm_cfg, temb_cfg = configs(torch_get_config)
    jax_models = [jax_build_model(jlm_cfg, remat=False),
                  jax_build_model(jlm_cfg, with_value_head=True, remat=False),
                  jax_build_model(jemb_cfg, remat=False)]
    torch_models = [torch_build_model(tlm_cfg, device="cpu"),
                    torch_build_model(tlm_cfg, with_value_head=True,
                                      device="cpu"),
                    torch_build_model(temb_cfg, device="cpu")]
    jstack, tstack = [], []
    for i, (jm, tm) in enumerate(zip(jax_models, torch_models)):
        npp = numpy_params(jm, seed + i)
        jstack.append((jm, jax.tree.map(jnp.asarray, npp)))
        tstack.append((tm, params_from_jax(npp, tm.cfg, "cpu")))
    return tuple(jstack), tuple(tstack)
