"""Paged KV cache with tree sharing.

Host: refcounted page allocator + per-sequence block tables with
copy-on-write branching (allocator.py, copied from ``repro``) and the
tree-attention metadata (tree_meta.py).  Device: the paged pool
(pool.py), and the recurrent families' state pool.
"""
from .allocator import (PageAllocator, SequenceHandle,  # noqa: F401
                        VictimCandidate, select_victim)
from .pool import KVPool, StatePool  # noqa: F401
from .tree_meta import TreeMetadata, build_tree_metadata  # noqa: F401
