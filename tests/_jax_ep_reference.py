"""The reference's expert-parallel MoE (``shard_map``) on a jax CPU mesh
of placeholder devices, for the port's gloo runs to be held against.

    python tests/_jax_ep_reference.py DIR DATA MODEL

The device count is set before jax starts, as ``repro.launch.dryrun``
sets it; writes ``y`` and ``aux`` to ``DIR/ref.npz``.
"""
import os
import sys

n_data, n_model = int(sys.argv[2]), int(sys.argv[3])
os.environ["XLA_FLAGS"] = (
    f"--xla_force_host_platform_device_count={n_data * n_model} "
    + os.environ.get("XLA_FLAGS", ""))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, tiny_variant  # noqa: E402
from repro.models import moe as MOE  # noqa: E402


def main(out_dir):
    cfg = tiny_variant(get_config("deepseek-moe-16b"))
    z = np.load(os.path.join(out_dir, "inputs.npz"))
    p = {k: jnp.asarray(z[k]) for k in ("router", "w_gate", "w_up",
                                         "w_down")}
    p["shared"] = {k: jnp.asarray(z["shared_" + k])
                   for k in ("w_gate", "w_up", "w_down")}
    MOE.MESH = jax.make_mesh((n_data, n_model), ("data", "model"))
    MOE.DATA_AXES, MOE.N_GROUPS = ("data",), n_data
    y, aux = MOE.moe_apply_auto(p, jnp.asarray(z["x"]), cfg)
    np.savez(os.path.join(out_dir, "ref.npz"), y=np.asarray(y),
             aux=np.asarray(aux))


if __name__ == "__main__":
    main(sys.argv[1])
