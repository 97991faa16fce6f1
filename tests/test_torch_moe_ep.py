"""Expert-parallel MoE on the port (``moe_apply_expert_parallel``) against
``moe_apply`` and against the reference's ``shard_map`` path, on the CPU.

  * a 1x1 mesh (a world-size-1 gloo group in this process) gives
    ``moe_apply``'s output within the reference's 2e-4
    (``tests/test_mixers.py::test_moe_expert_parallel_matches_baseline``);
  * 2 and 4 ranks of a gloo group on (1,2) and (2,2) meshes: rank 0's
    output equals ``moe_apply`` on all the tokens (the tiny config's
    capacity drops nothing), and output and aux loss equal the
    reference's ``shard_map`` path on a jax CPU mesh of the same shape;
  * the baseline (``MESH`` None) is ``moe_apply``.

Every spawned process is joined with a timeout and killed after it, so
a hung collective fails one test instead of stalling the suite.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import tiny_variant as jax_tiny_variant
from repro.models import moe as JMOE

from repro_torch.configs import get_config, tiny_variant
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as MOE

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-4
TIMEOUT = 120


@pytest.fixture(scope="module")
def moe_setup():
    cfg = tiny_variant(get_config("deepseek-moe-16b"))
    jp = jax.tree.map(np.asarray, JMOE.moe_init(
        jax.random.key(0), jax_tiny_variant(jax_get_config(
            "deepseek-moe-16b"))))
    x = np.random.default_rng(0).standard_normal(
        (32, cfg.d_model)).astype(np.float32)
    return cfg, jp, x


def _torch_params(jp):
    return {k: (torch.tensor(v) if not isinstance(v, dict)
                else {kk: torch.tensor(vv) for kk, vv in v.items()})
            for k, v in jp.items()}


@pytest.fixture
def mesh_globals():
    saved = (MOE.MESH, MOE.DATA_AXES, MOE.N_GROUPS)
    yield
    MOE.MESH, MOE.DATA_AXES, MOE.N_GROUPS = saved


def test_one_by_one_mesh_matches_moe_apply(moe_setup, mesh_globals):
    cfg, jp, x = moe_setup
    p, xt = _torch_params(jp), torch.tensor(x)
    y_ref, aux_ref = MOE.moe_apply(p, xt, cfg)
    assert MOE.moe_apply_auto(p, xt, cfg)[0].equal(y_ref)   # no mesh
    MOE.MESH = make_host_mesh(device="cpu")
    MOE.DATA_AXES, MOE.N_GROUPS = ("data",), 1
    n0 = MOE.N_ALL_TO_ALL
    y, aux = MOE.moe_apply_auto(p, xt, cfg)
    assert MOE.N_ALL_TO_ALL - n0 == 4
    assert type(y) is torch.Tensor and y.shape == y_ref.shape
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-6)


def _run_all(cmds, env):
    procs = [subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = []
    try:
        for pr in procs:
            outs.append(pr.communicate(timeout=TIMEOUT)[0])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    for pr, out in zip(procs, outs):
        assert pr.returncode == 0, out[-3000:]


@pytest.mark.parametrize("n_data,n_model", [(1, 2), (2, 2)])
def test_gloo_ranks_match_moe_apply_and_shard_map(moe_setup, tmp_path,
                                                  n_data, n_model):
    cfg, jp, x = moe_setup
    np.savez(tmp_path / "inputs.npz", x=x,
             **{k: v for k, v in jp.items() if k != "shared"},
             **{"shared_" + k: v for k, v in jp["shared"].items()})
    world = n_data * n_model
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    d = str(tmp_path)
    cmds = [[sys.executable, str(ROOT / "tests" / "_torch_ep_worker.py"),
             d, str(r), str(world), str(n_data), str(n_model)]
            for r in range(world)]
    cmds.append([sys.executable, str(ROOT / "tests" / "_jax_ep_reference.py"),
                 d, str(n_data), str(n_model)])
    _run_all(cmds, env)
    got, ref = np.load(tmp_path / "ep.npz"), np.load(tmp_path / "ref.npz")
    assert int(got["n_a2a"]) == 4
    y_all, _ = MOE.moe_apply(_torch_params(jp), torch.tensor(x), cfg)
    np.testing.assert_allclose(got["y"], y_all.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["y"], ref["y"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["aux"], ref["aux"], rtol=1e-5)
