"""Synthetic multi-step reasoning task with an oracle generator + noisy PRM.

This is the controlled environment for reproducing the paper's *search
dynamics* (Table 1/3 qualitatively, Fig. 2's KV-size gaps) without GPUs or
the Llemma checkpoints:

  * A problem is a chain of up to ``depth`` reasoning steps.
  * At each step there are ``n_semantics`` semantically-distinct ways to
    continue.  Correctness is a hidden *transition table*: whether semantic
    s is a valid move depends on (depth, previous semantic).  Some locally
    valid moves are traps whose continuations are rare or absent — a
    high-reward prefix can dead-end.  One golden path is guaranteed.
  * Sampling picks semantics from a skewed (zipf) popularity distribution —
    popular semantics are drawn repeatedly, producing the redundant
    paraphrases ETS prunes (§4.2's "two steps, same meaning").
  * The PRM is noisy (reward ~ clip(N(mu, sigma))), so exploitation-only
    search (beam) collapses onto locally-plausible prefixes and loses to
    methods that keep semantically diverse alternatives alive — the
    paper's core accuracy-vs-diversity trade-off.
  * Embeddings: each (depth, semantic) has a fixed random unit vector plus
    small per-sample noise, so agglomerative clustering recovers the
    semantic groups.

Everything is seeded and pure-numpy; tests assert the qualitative paper
claims (ETS ~ REBASE accuracy at materially lower average KV).

The backend implements the batched step API (``expand_many`` /
``score_many`` / ``embed_many``) by looping the single-node methods in
controller call order, so batched and serial searches consume the RNG
stream identically and produce bit-identical trees — the equivalence
tests rely on this.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .controllers import (Backend, _serial_embed, _serial_expand,
                          _serial_score)
from .tree import SearchTree


@dataclass
class SyntheticTaskConfig:
    depth: int = 5
    n_semantics: int = 6           # distinct meanings available per step
    p_transition_ok: float = 0.45  # chance a (prev, next) move is valid
    trap_p: float = 0.40           # chance a (depth, prev) family dead-ends
    p_recover: float = 0.12        # a flawed prefix can still be salvaged
    zipf_s: float = 1.3            # skew of semantic popularity (redundancy)
    reward_mu_correct: float = 0.62
    reward_mu_wrong: float = 0.40
    reward_sigma: float = 0.28
    # complete solutions are easier to verify than partial ones
    final_mu_correct: float = 0.80
    final_mu_wrong: float = 0.25
    final_sigma: float = 0.15
    emb_dim: int = 16
    emb_noise: float = 0.08
    tokens_per_step: Tuple[int, int] = (24, 56)
    prompt_tokens: int = 64
    n_wrong_answers: int = 12
    early_finish_depth: int = 3    # concluding moves possible from here
    early_finish_p: float = 0.20   # a correct chain concludes readily
    early_finish_p_wrong: float = 0.05  # wrong chains ramble on


class SyntheticProblem(Backend):
    """One problem instance implementing the controller Backend protocol."""

    ROOT_SEM = -1  # previous-semantic index used at the root

    def __init__(self, cfg: SyntheticTaskConfig, seed: int):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        ns = cfg.n_semantics
        # fixed semantic embedding dictionary: (depth, sem) -> unit vector
        self._emb = self.rng.normal(size=(cfg.depth, ns, cfg.emb_dim))
        self._emb /= np.linalg.norm(self._emb, axis=-1, keepdims=True)
        # hidden transition validity: (depth, prev_sem+1, sem).  Row 0 is
        # the root context.
        self._ok = self.rng.random((cfg.depth, ns + 1, ns)) \
            < cfg.p_transition_ok
        # traps: some semantic families dead-end (no valid continuation) —
        # a locally-plausible prefix that cannot be completed.  This is why
        # exploration pays: exploitation-only search that collapses onto a
        # trapped family loses the problem.
        trap = self.rng.random((cfg.depth, ns + 1)) < cfg.trap_p
        self._ok &= ~trap[:, :, None]
        # guarantee one golden path
        golden = [int(self.rng.integers(ns)) for _ in range(cfg.depth)]
        prev = self.ROOT_SEM
        for d, g in enumerate(golden):
            self._ok[d, prev + 1, g] = True
            prev = g
        # zipf-ish popularity, shuffled so popularity != correctness
        ranks = np.arange(1, ns + 1, dtype=np.float64)
        pop = ranks ** (-cfg.zipf_s)
        self.rng.shuffle(pop)
        self._pop = pop / pop.sum()
        self.correct_answer = "ANS_TRUE"
        self.n_model_calls = 0     # proxy-metric bookkeeping (Fig. 2)
        self.gen_tokens = 0
        # batched-step bookkeeping: how many *_many calls the controller
        # issued (one per step stage on the batched path)
        self.n_expand_batches = 0
        self.n_score_batches = 0
        self.n_embed_batches = 0

    # -- Backend ---------------------------------------------------------
    def expand(self, tree: SearchTree, leaf: int, n: int) -> List[int]:
        cfg = self.cfg
        node = tree.node(leaf)
        depth = node.depth          # root = 0 -> children at depth 1
        if depth >= cfg.depth:
            return []
        pl = node.payload or {}
        prefix_ok = pl.get("correct", True)
        prev_sem = pl.get("sem", self.ROOT_SEM)
        kids = []
        for _ in range(n):
            sem = int(self.rng.choice(cfg.n_semantics, p=self._pop))
            ok = bool(prefix_ok and self._ok[depth, prev_sem + 1, sem])
            if not ok and self.rng.random() < cfg.p_recover:
                # a mistake is not always fatal — the chain recovers
                ok = bool(self._ok[depth, prev_sem + 1, sem])
            emb = self._emb[depth, sem] + \
                self.rng.normal(scale=cfg.emb_noise, size=cfg.emb_dim)
            ntok = int(self.rng.integers(*cfg.tokens_per_step))
            fin_p = cfg.early_finish_p if ok else cfg.early_finish_p_wrong
            finished = (depth + 1 >= cfg.depth) or (
                depth + 1 >= cfg.early_finish_depth
                and self.rng.random() < fin_p)
            payload = {"sem": sem, "correct": ok, "emb": emb}
            kid = tree.add(leaf, n_tokens=ntok, finished=finished,
                           payload=payload)
            kids.append(kid)
            self.n_model_calls += 1
            self.gen_tokens += ntok
        return kids

    def score(self, tree: SearchTree, node: int) -> float:
        cfg = self.cfg
        nd = tree.node(node)
        ok = nd.payload["correct"]
        if nd.finished:
            mu = cfg.final_mu_correct if ok else cfg.final_mu_wrong
            sd = cfg.final_sigma
        else:
            mu = cfg.reward_mu_correct if ok else cfg.reward_mu_wrong
            sd = cfg.reward_sigma
        return float(np.clip(self.rng.normal(mu, sd), 0.0, 1.0))

    def embed(self, tree: SearchTree, node: int) -> np.ndarray:
        return tree.node(node).payload["emb"]

    def answer(self, tree: SearchTree, leaf: int) -> Any:
        if tree.node(leaf).payload["correct"]:
            return self.correct_answer
        # wrong answers collide a little (finitely many wrong outcomes)
        return f"ANS_WRONG_{self.rng.integers(self.cfg.n_wrong_answers)}"

    # -- batched step API -------------------------------------------------
    # The oracle draws from one sequential RNG stream, so the batched
    # implementations delegate to the canonical serial loops — batched
    # and serial searches are bit-identical for a fixed seed (asserted
    # by tests).  The batch counters let tests assert the controller
    # makes O(1) calls per step.
    def expand_many(self, tree: SearchTree, leaf_counts) -> List[int]:
        self.n_expand_batches += 1
        return _serial_expand(self, tree, leaf_counts)

    def score_many(self, tree: SearchTree, nodes) -> List[float]:
        self.n_score_batches += 1
        return _serial_score(self, tree, nodes)

    def embed_many(self, tree: SearchTree, nodes) -> np.ndarray:
        self.n_embed_batches += 1
        return _serial_embed(self, tree, nodes)

    def make_tree(self) -> SearchTree:
        return SearchTree(root_tokens=self.cfg.prompt_tokens,
                          root_payload={"correct": True, "sem": self.ROOT_SEM,
                                        "emb": np.zeros(self.cfg.emb_dim)})


class SyntheticSweep:
    """Multi-problem synthetic backend for the sweep scheduler.

    Each tree is owned by exactly one :class:`SyntheticProblem`; every
    Backend call dispatches to the owner by tree identity, so problems'
    RNG streams stay fully independent no matter how the scheduler
    interleaves their steps.  Because dispatch preserves each problem's
    call order, a cross-problem sweep is bit-identical to running the
    same problems serially — the property the sweep equivalence tests
    pin down.  There are no ``*_multi`` overrides: the controller's
    per-problem fallback loop is the point (the oracle has no batch
    axis to fill).
    """

    def __init__(self, problems: List["SyntheticProblem"]):
        self.problems = list(problems)
        # id -> (tree, problem): the tree reference keeps every owned
        # tree alive, so a recycled id() can never alias a stale entry
        self._owner: Dict[int, Tuple[SearchTree, SyntheticProblem]] = {}

    def make_trees(self) -> List[SearchTree]:
        trees = []
        for prob in self.problems:
            t = prob.make_tree()
            self._owner[id(t)] = (t, prob)
            trees.append(t)
        return trees

    def _prob(self, tree: SearchTree) -> "SyntheticProblem":
        owned, prob = self._owner[id(tree)]
        assert owned is tree, "tree not started by this sweep backend"
        return prob

    def expand(self, tree, leaf, n):
        return self._prob(tree).expand(tree, leaf, n)

    def score(self, tree, node):
        return self._prob(tree).score(tree, node)

    def embed(self, tree, node):
        return self._prob(tree).embed(tree, node)

    def answer(self, tree, leaf):
        return self._prob(tree).answer(tree, leaf)

    def expand_many(self, tree, leaf_counts):
        return self._prob(tree).expand_many(tree, leaf_counts)

    def score_many(self, tree, nodes):
        return self._prob(tree).score_many(tree, nodes)

    def embed_many(self, tree, nodes):
        return self._prob(tree).embed_many(tree, nodes)


# ---------------------------------------------------------------------------
# Batch evaluation harness
# ---------------------------------------------------------------------------

def evaluate_method(scfg, task_cfg: Optional[SyntheticTaskConfig] = None,
                    n_problems: int = 50, seed: int = 0) -> Dict[str, float]:
    """Run `n_problems` searches; return accuracy + KV/proxy metrics."""
    from .controllers import run_search
    task_cfg = task_cfg or SyntheticTaskConfig()
    acc = 0
    kv_shared, kv_unshared, calls, toks, nodes = [], [], [], [], []
    for i in range(n_problems):
        prob = SyntheticProblem(task_cfg, seed=seed * 100003 + i)
        res = run_search(prob, scfg, tree=prob.make_tree())
        acc += int(res.answer == prob.correct_answer)
        s = res.kv_summary
        kv_shared.append(s["avg_kv_shared"])
        kv_unshared.append(s["avg_kv_unshared"])
        calls.append(prob.n_model_calls)
        toks.append(prob.gen_tokens)
        nodes.append(s["total_nodes"])
    n = float(n_problems)
    return {
        "accuracy": acc / n,
        "avg_kv_shared": float(np.mean(kv_shared)),
        "avg_kv_unshared": float(np.mean(kv_unshared)),
        "model_calls": float(np.mean(calls)),
        "gen_tokens": float(np.mean(toks)),     # FLOPs proxy (Pope et al.)
        "tree_nodes": float(np.mean(nodes)),
    }
