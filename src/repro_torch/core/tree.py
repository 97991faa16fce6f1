"""Search-tree bookkeeping for PRM-guided tree search.

The tree records, for every node, its parent, its token count (the KV
segment this node contributes), its PRM reward, and arbitrary payload
(tokens / text / semantic embedding).  The KV-centric quantities the paper
optimizes are all derived here:

  * ``nodes_for_leaves(leaves)``  — V_S: every node on a root path of any
    selected leaf (the coupling that makes pruning an ILP).
  * ``kv_tokens_for_leaves``      — unique KV tokens the selected set keeps
    alive (what a radix/paged cache with tree sharing actually stores).
  * ``unshared_kv_tokens``        — sum over leaves of their full path
    length (what per-sequence contiguous caches would store).

The per-step time series of these is the paper's "average KV cache size
during the search process" metric (Table 1's "KV Red." denominator).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence, Set


@dataclass
class Node:
    id: int
    parent: int                  # -1 for root
    depth: int
    n_tokens: int                # tokens this node appends to the trajectory
    reward: float = 0.0          # PRM score of the partial trajectory
    finished: bool = False       # trajectory ended (EOS / final answer)
    payload: Any = None          # tokens / text / embedding etc.
    children: List[int] = field(default_factory=list)


class SearchTree:
    def __init__(self, root_tokens: int = 0, root_payload: Any = None):
        self.nodes: List[Node] = [
            Node(id=0, parent=-1, depth=0, n_tokens=root_tokens,
                 payload=root_payload)]
        # KV time-series bookkeeping (appended by the controller each step)
        self.kv_trace: List[Dict[str, float]] = []
        # decode-boundary trace: the step's decoded-branch set (node
        # ids), appended by the controller the moment an expansion's
        # children are noted — BEFORE scoring/pruning, so entry k pairs
        # 1:1 with the k-th engine KV-trace entry of this problem (the
        # engine books attention IO per decode, i.e. per branch set,
        # while ``kv_trace`` above snapshots the post-prune live set).
        # This alignment is what lets the fig2 costsim validation check
        # measured page IO at count level instead of ratio level.
        self.decode_trace: List[List[int]] = []
        # First-Finish truncation marker: number of trailing
        # ``decode_trace`` entries whose post-decode stages never ran
        # because the search halted mid-step (the engine KV trace has
        # no twin for them).  Consumers pairing the two traces use the
        # non-truncated prefix ``decode_trace[:len - truncated_steps]``
        # instead of skipping halted problems outright.
        self.truncated_steps: int = 0

    # ------------------------------------------------------------------
    def add(self, parent: int, n_tokens: int, reward: float = 0.0,
            finished: bool = False, payload: Any = None) -> int:
        nid = len(self.nodes)
        node = Node(id=nid, parent=parent, depth=self.nodes[parent].depth + 1,
                    n_tokens=n_tokens, reward=reward, finished=finished,
                    payload=payload)
        self.nodes.append(node)
        self.nodes[parent].children.append(nid)
        return nid

    def __len__(self) -> int:
        return len(self.nodes)

    def node(self, nid: int) -> Node:
        return self.nodes[nid]

    # ------------------------------------------------------------------
    def path(self, nid: int) -> List[int]:
        """Root -> nid node ids (inclusive, excluding the root id 0)."""
        out = []
        while nid != 0:
            out.append(nid)
            nid = self.nodes[nid].parent
        return out[::-1]

    def path_tokens(self, nid: int) -> int:
        """Total tokens on the root path (incl. root prompt)."""
        total = self.nodes[0].n_tokens
        while nid != 0:
            total += self.nodes[nid].n_tokens
            nid = self.nodes[nid].parent
        return total

    # ------------------------------------------------------------------
    def nodes_for_leaves(self, leaves: Sequence[int]) -> Set[int]:
        """V_S — union of root paths of the given leaves (excluding root)."""
        out: Set[int] = set()
        for leaf in leaves:
            nid = leaf
            while nid != 0 and nid not in out:
                out.add(nid)
                nid = self.nodes[nid].parent
        return out

    def kv_tokens_for_leaves(self, leaves: Sequence[int]) -> int:
        """Unique KV tokens stored with tree sharing (radix-style)."""
        shared = self.nodes_for_leaves(leaves)
        total = self.nodes[0].n_tokens if leaves else 0
        for nid in shared:
            total += self.nodes[nid].n_tokens
        return total

    def unshared_kv_tokens(self, leaves: Sequence[int]) -> int:
        """KV tokens if every leaf kept a private contiguous cache."""
        return sum(self.path_tokens(l) for l in leaves)

    # ------------------------------------------------------------------
    def record_decode(self, candidates: Sequence[int]) -> None:
        """Record one step's decoded-branch set (see ``decode_trace``)."""
        self.decode_trace.append([int(c) for c in candidates])

    def mark_truncated(self) -> None:
        """Stamp the First-Finish truncation marker: any decode
        boundary recorded beyond the last completed step (``kv_trace``
        snapshots one entry per *completed* step) was halted mid-step
        and has no engine-trace twin."""
        self.truncated_steps = max(
            len(self.decode_trace) - len(self.kv_trace), 0)

    # ------------------------------------------------------------------
    def record_step(self, live_leaves: Sequence[int]) -> None:
        """Append a snapshot of KV occupancy for the live leaf set."""
        self.kv_trace.append({
            "n_leaves": len(live_leaves),
            "n_nodes": len(self.nodes_for_leaves(live_leaves)),
            "kv_tokens_shared": self.kv_tokens_for_leaves(live_leaves),
            "kv_tokens_unshared": self.unshared_kv_tokens(live_leaves),
        })

    def kv_summary(self) -> Dict[str, float]:
        """Averages over the recorded search steps."""
        if not self.kv_trace:
            return {"avg_kv_shared": 0.0, "avg_kv_unshared": 0.0,
                    "peak_kv_shared": 0.0, "total_nodes": len(self.nodes)}
        sh = [t["kv_tokens_shared"] for t in self.kv_trace]
        un = [t["kv_tokens_unshared"] for t in self.kv_trace]
        return {
            "avg_kv_shared": sum(sh) / len(sh),
            "avg_kv_unshared": sum(un) / len(un),
            "peak_kv_shared": max(sh),
            "total_nodes": len(self.nodes),
            "steps": len(self.kv_trace),
        }
