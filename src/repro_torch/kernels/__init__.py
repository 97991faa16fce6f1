"""Kernels of the serving path, hand-written in CUDA for Hopper.

  paged_attention — decode over block-tabled paged KV
  tree_attention  — DeFT-style decode: each unique tree page read once
                    per kv head for all its descendant leaves (a split
                    pass over the page list, then a combine pass)
  flash_prefill   — causal / sliding-window flash attention for prefill
                    on the tensor cores
  gumbel_sample   — the decode sampler's draw: threefry bits, Gumbel
                    noise and the row argmax in registers

``csrc/`` holds the CUDA sources, ``build.py`` compiles them with nvcc
at first use, ``ops.py`` holds the wrappers (kernel on a CUDA tensor,
plain version on a CPU tensor) and ``ref.py`` the attention kernels'
plain versions (the sampler's is ``serving/sampler.py``'s
``gumbel_argmax``).
"""
from . import ops  # noqa: F401
from .ops import flash_prefill, paged_attention, tree_attention  # noqa: F401
