"""Tiny dry runs on small fake meshes, in a process of their own (the
dry run owns its default process group).

    python tests/_torch_dryrun_worker.py OUT_DIR

Writes one JSON record per combo to OUT_DIR, named
``{arch}__{shape}__{mesh}[__opt].json``.
"""
import json
import os
import sys

from repro_torch.configs import InputShape, get_config, tiny_variant
from repro_torch.launch.dryrun import lower_combo

SHAPES = {"train_4k": InputShape("train_4k", 64, 8, "train"),
          "prefill_32k": InputShape("prefill_32k", 64, 8, "prefill"),
          "decode_32k": InputShape("decode_32k", 128, 8, "decode")}
COMBOS = [  # arch, shape, mesh shape, multi-pod, opt
    ("llama3.2-1b", "train_4k", (1, 1), False, False),
    ("llama3.2-1b", "prefill_32k", (1, 1), False, False),
    ("llama3.2-1b", "train_4k", (2, 2), False, False),
    ("llama3.2-1b", "prefill_32k", (2, 2), False, False),
    ("llama3.2-1b", "decode_32k", (2, 2), False, False),
    ("llama3.2-1b", "prefill_32k", (2, 2, 2), True, False),
    ("llama3.2-1b", "decode_32k", (2, 2, 2), True, False),
    ("deepseek-moe-16b", "train_4k", (2, 2), False, True),
]


def main(out_dir):
    os.makedirs(out_dir, exist_ok=True)
    for arch, shape, mesh, mp, opt in COMBOS:
        rec = lower_combo(arch, shape, multi_pod=mp, opt=opt,
                          cfg=tiny_variant(get_config(arch)),
                          shape=SHAPES[shape], mesh_shape=mesh)
        tag = f"{arch}__{shape}__{rec['mesh']}" + ("__opt" if opt else "")
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f)


if __name__ == "__main__":
    main(sys.argv[1])
