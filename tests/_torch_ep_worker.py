"""One rank of an expert-parallel MoE run on a gloo group (no jax).

    python tests/_torch_ep_worker.py DIR RANK WORLD DATA MODEL

Reads ``DIR/inputs.npz`` (the MoE block's params and the tokens), joins
a gloo group of WORLD ranks through a file store in DIR, runs
``moe_apply_expert_parallel`` on a (DATA, MODEL) mesh and, on rank 0,
writes ``y`` and ``aux`` to ``DIR/ep.npz``.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import get_config, tiny_variant
from repro_torch.models import moe as MOE


def main(out_dir, rank, world, n_data, n_model):
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
        rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (n_data, n_model),
                                mesh_dim_names=("data", "model"))
        cfg = tiny_variant(get_config("deepseek-moe-16b"))
        z = np.load(os.path.join(out_dir, "inputs.npz"))
        p = {k: torch.tensor(z[k]) for k in ("router", "w_gate", "w_up",
                                             "w_down")}
        p["shared"] = {k: torch.tensor(z["shared_" + k])
                       for k in ("w_gate", "w_up", "w_down")}
        MOE.MESH, MOE.DATA_AXES, MOE.N_GROUPS = mesh, ("data",), n_data
        y, aux = MOE.moe_apply_auto(p, torch.tensor(z["x"]), cfg)
        if rank == 0:
            np.savez(os.path.join(out_dir, "ep.npz"), y=y.numpy(),
                     aux=aux.numpy(), n_a2a=MOE.N_ALL_TO_ALL)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], *map(int, sys.argv[2:]))
