"""PyTorch + CUDA port of the ETS serving stack (``repro`` is the JAX
reference).

Layout mirrors ``repro``: ``configs``, ``core`` (host-side search, copied
from the reference), ``kvcache`` (allocator, tree metadata, paged pool),
``kernels`` (hand-written CUDA kernels for Hopper plus their plain
PyTorch versions), ``models`` (every family: dense, VLM, encoder, MoE,
SSM, hybrid; the contiguous KV/state cache), ``serving`` (paged engine,
sampler, search backend), ``training``, ``launch`` (train and serve
launchers, the step builders, meshes, the sharding policy, the dry
run), ``analysis`` (roofline, report), ``eval`` and ``bridge``
(reference params and caches <-> the port's).

The package imports ``torch``, numpy and scipy only.  Entry points run
on the CUDA device unless the caller passes ``device="cpu"``; on the
CPU every kernel call takes its plain PyTorch version.
"""
