"""PyTorch + CUDA port of the ETS serving stack (``repro`` is the JAX
reference).

Layout mirrors ``repro``: ``configs``, ``core`` (host-side search, copied
from the reference), ``kvcache`` (allocator, tree metadata, paged pool),
``kernels`` (hand-written CUDA kernels for Hopper plus their plain
PyTorch versions), ``models`` (dense GQA decoder and encoder),
``serving`` (paged engine, sampler, search backend) and ``bridge``
(reference params -> port params).

The package imports ``torch``, numpy and scipy only.  Entry points run
on the CUDA device unless the caller passes ``device="cpu"``; on the
CPU every kernel call takes its plain PyTorch version.
"""
