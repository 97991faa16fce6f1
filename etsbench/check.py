"""Whether what the timed window served is right: the served search
held against the plain reference (``reference/``) after the window.

A sample drawn from the seed of the problems that closed a search step
in the window (a step is closed once its candidates are decoded, scored
and pruned), the problem with the longest prompt always among them, is
judged on the nodes of its closed steps, by four numbers, each against
its limit (``limits/<cell>.json``):

  * ``lm_gap`` — LM prefill and decode through the pool.  For a sample
    of each problem's leaves (its deepest among them), every token the
    search served on the leaf's path: the reference's float32 logits
    over the served token path, divided by the temperature, plus the
    token's Gumbel noise worked out from the seed (``reference/
    sampler.py``), should put the served token first.  The number is
    the widest gap by which a served token lies below the best.
  * ``prm_gap`` — the PRM: the widest gap between a scored node's
    reward and the reference's.  Dense PRMs are judged node by node; a
    PRM with a fixed expert capacity drops tokens by their place in the
    whole padded call, so its sample is one whole call, rebuilt as the
    server padded it.
  * ``embed_err`` — the embedder: the widest relative L2 gap between a
    candidate's last-step embedding, as ETS received it, and the
    reference's.
  * ``ets_mismatch`` — ETS's retained set: the selection steps whose
    retained candidates or continuation counts differ from the frozen
    selection (``reference/ets.py``) given the served rewards and
    embeddings.

``control`` replaces the served outputs by the reference's own in a
lower precision and reads the same numbers: the control of the
readings the limits rest on.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .reference import ets as ets_ref
from .reference import model as ref
from .reference import sampler

N_PROBLEMS = 2          # problems judged per run
N_LEAVES = 4            # leaves per problem whose served paths are judged
N_PRM_NODES = 8         # nodes per problem whose rewards are judged (dense)
ROWS_PER_CHUNK = 64     # logits rows worked out at a time


def _pow2(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class Served:
    """What the window served, as the benchmark recorded it."""

    def __init__(self, prompts, trees: Dict[int, object], stepped,
                 done: Dict[int, int], ets_calls: Dict[object, List[Dict]],
                 score_calls: List[List[tuple]], key_seed: int,
                 temperature: float):
        self.prompts = prompts
        self.trees = trees              # request index -> SearchTree
        self.stepped = list(stepped)    # problems that closed a step in
        #                                 the window
        self.done = done                # request index -> steps closed
        self.ets_calls = ets_calls      # namespace -> captured steps
        self.score_calls = score_calls  # [(namespace, node)] per call
        self.key_seed = key_seed
        self.temperature = temperature

    def ns(self, idx):
        return self.trees[idx].node(0).payload["ns"]

    def nodes(self, idx) -> List[int]:
        """The problem's nodes of closed steps (scored and pruned)."""
        tree = self.trees[idx]
        return [n for n in range(1, len(tree))
                if tree.node(n).depth <= self.done.get(idx, 0)]

    def leaves(self, idx) -> List[int]:
        ok = set(self.nodes(idx))
        return [n for n in sorted(ok)
                if not any(c in ok for c in self.trees[idx].node(n).children)]

    def seq(self, idx, nid) -> List[int]:
        tree = self.trees[idx]
        out = list(self.prompts[idx])
        for n in tree.path(nid):
            out += tree.node(n).payload["tokens"]
        return out


def sample(served: Served, seed: int) -> List[int]:
    cands = sorted(served.stepped)
    if not cands:
        raise RuntimeError("the window closed no search step to judge")
    longest = max(cands, key=lambda i: (len(served.prompts[i]), -i))
    rest = [i for i in cands if i != longest]
    rng = np.random.default_rng(int(seed))
    pick = list(rng.permutation(rest)[:N_PROBLEMS - 1]) if rest else []
    return [longest] + [int(i) for i in pick]


def _branch_index(tree) -> Dict[int, int]:
    by_depth: Dict[int, List[int]] = {}
    for n in range(1, len(tree)):
        by_depth.setdefault(tree.node(n).depth, []).append(n)
    return {n: i for ids in by_depth.values() for i, n in enumerate(ids)}


def lm_gap(served: Served, probs: Sequence[int], w, spec, seed: int,
           control: Optional[str] = None):
    rng = np.random.default_rng(int(seed) + 1)
    seqs, rows, toks, keys = [], [], [], []
    for idx in probs:
        tree = served.trees[idx]
        bidx = _branch_index(tree)
        leaves = served.leaves(idx)
        deepest = max(leaves, key=lambda n: (tree.path_tokens(n), -n))
        others = [n for n in leaves if n != deepest]
        chosen = [deepest] + [int(n) for n in
                              rng.permutation(others)[:N_LEAVES - 1]]
        done = set()
        for leaf in chosen:
            seq = list(served.prompts[idx])
            r, t, k = [], [], []
            for n in tree.path(leaf):
                node = tree.node(n)
                ntok = node.payload["tokens"]
                if n not in done:
                    dk = sampler.draw_keys(served.key_seed, node.depth,
                                           bidx[n], len(ntok))
                    for j, tok in enumerate(ntok):
                        r.append(len(seq) + j - 1)
                        t.append(int(tok))
                        k.append(dk[j])
                    done.add(n)
                seq += ntok
            if r:
                seqs.append(seq)
                rows.append(r)
                toks.append(t)
                keys.append(k)
    dev = w["embed"].device
    hs = ref.hidden(w, spec, seqs, "fp32")
    hc = ref.hidden(w, spec, seqs, control) if control else None
    gaps, gaps_c = [], []
    T = served.temperature
    for i in range(len(seqs)):
        for a in range(0, len(rows[i]), ROWS_PER_CHUNK):
            rr = torch.as_tensor(rows[i][a:a + ROWS_PER_CHUNK], device=dev)
            tt = torch.as_tensor(toks[i][a:a + ROWS_PER_CHUNK], device=dev)
            g = sampler.gumbel(keys[i][a:a + ROWS_PER_CHUNK],
                               spec["vocab_size"], dev)
            z = ref.logits_at(w, spec, hs[i], rr, "fp32").double() / T + g
            best = z.max(dim=1).values
            gap = best - z.gather(1, tt[:, None])[:, 0]
            gaps.append(gap.cpu())
            if hc is not None:
                zc = ref.logits_at(w, spec, hc[i], rr,
                                   control).double() / T + g
                tc = zc.argmax(dim=1)
                gaps_c.append((best - z.gather(1, tc[:, None])[:, 0]).cpu())
            del z, g
    info = {"tokens": sum(len(r) for r in rows), "leaves": len(seqs)}
    return _gap_readings(gaps), \
        (_gap_readings(gaps_c) if control else {}), info


def _gap_readings(gaps) -> Dict[str, float]:
    """Widest gap, share of tokens not put first, 99th percentile gap."""
    g = torch.cat(gaps)
    return {"lm_gap": float(g.max()),
            "lm_off_share": float((g > 0).double().mean()),
            "lm_gap_p99": float(torch.quantile(g, 0.99))}


def _reward_rows(served, calls_nodes):
    return [served.trees[i].node(n).reward for i, n in calls_nodes]


def prm_gap(served: Served, probs: Sequence[int], w, spec, seed: int,
            control: Optional[str] = None):
    rng = np.random.default_rng(int(seed) + 2)
    ns_to_idx = {served.ns(i): i for i in served.trees}
    if spec.get("moe"):
        # the call that scored the first problem's deepest node, whole
        tree = served.trees[probs[0]]
        deepest = max(served.nodes(probs[0]),
                      key=lambda n: (tree.path_tokens(n), -n))
        ns0 = served.ns(probs[0])
        call = next(c for c in served.score_calls if (ns0, deepest) in c)
        nodes = [(ns_to_idx[ns], n) for ns, n in call]
        seqs = [served.seq(i, n) for i, n in nodes]
        B, T = _pow2(len(seqs), 1), _pow2(max(map(len, seqs)), 8)
        toks = np.zeros((B, T), np.int64)
        pos = np.full((B, T), -1, np.int64)
        for r, s in enumerate(seqs):
            toks[r, :len(s)] = s
            pos[r, :len(s)] = np.arange(len(s))
        dev = w["embed"].device
        tt = torch.as_tensor(toks, device=dev)
        pp = torch.as_tensor(pos, device=dev)
        last = torch.as_tensor([len(s) - 1 for s in seqs], device=dev)
        ar = torch.arange(len(seqs), device=dev)
        stats: Dict = {}

        def rewards(prec, st=None):
            h = ref.bucket_hidden(w, spec, tt, pp, prec, st)
            return ref.reward_of(w, h[ar, last], prec).double().cpu()

        r_ref = rewards("fp32", stats)
        r_ctl = rewards(control) if control else None
        info = {"bucket": [B, T], "dropped_replicas": stats.get("dropped")}
    else:
        nodes = []
        for idx in probs:
            tree = served.trees[idx]
            ids = served.nodes(idx)
            deepest = max(ids, key=lambda n: (tree.path_tokens(n), -n))
            rest = [n for n in ids if n != deepest]
            nodes += [(idx, deepest)] + [
                (idx, int(n)) for n in rng.permutation(rest)[:N_PRM_NODES - 1]]
        seqs = [served.seq(i, n) for i, n in nodes]

        def rewards(prec):
            hs = ref.hidden(w, spec, seqs, prec)
            last = torch.stack([h[-1] for h in hs])
            return ref.reward_of(w, last, prec).double().cpu()

        r_ref = rewards("fp32")
        r_ctl = rewards(control) if control else None
        info = {}
    got = torch.as_tensor(_reward_rows(served, nodes), dtype=torch.float64)
    info["nodes"] = len(nodes)

    def readings(r):
        d = (r - r_ref).abs()
        return {"prm_gap": float(d.max()), "prm_mean_gap": float(d.mean())}
    return readings(got), (readings(r_ctl) if control else {}), info


def embed_err(served: Served, probs: Sequence[int], w, spec,
              control: Optional[str] = None):
    steps, got = [], []
    for idx in probs:
        tree = served.trees[idx]
        for call in served.ets_calls.get(served.ns(idx), []):
            if call["embs"] is None:
                continue
            for c, e in zip(call["candidates"], call["embs"]):
                toks = tree.node(c).payload["tokens"]
                if toks:
                    steps.append(toks)
                    got.append(np.asarray(e, np.float64))
    if not steps:
        return {"embed_err": 0.0}, ({"embed_err": 0.0} if control else {}), \
            {"steps": 0}

    def embs(prec):
        return torch.stack([h.mean(0) for h in ref.hidden(w, spec, steps,
                                                          prec)]
                           ).double().cpu()

    r = embs("fp32")

    def readings(e):
        rel = (e - r).norm(dim=1) / r.norm(dim=1).clamp(min=1e-30)
        return {"embed_err": float(rel.max())}
    return readings(torch.as_tensor(np.stack(got))), \
        (readings(embs(control)) if control else {}), {"steps": len(steps)}


def ets_mismatch(served: Served, probs: Sequence[int], ets_cfg: Dict):
    bad = n = 0
    for idx in probs:
        tree = served.trees[idx]
        for call in served.ets_calls.get(served.ns(idx), []):
            paths = [tree.path(c) for c in call["candidates"]]
            sel, counts = ets_ref.select(
                paths, call["rewards"], call["embs"], call["n_total"],
                lambda_b=ets_cfg["lambda_b"], lambda_d=ets_cfg["lambda_d"],
                temperature=ets_cfg["rebase_temperature"],
                threshold=ets_cfg["cluster_threshold"])
            n += 1
            if sel != list(call["selected"]) or counts != list(call["counts"]):
                bad += 1
    return {"ets_mismatch": float(bad)}, {}, {"steps": n}


def judge(served: Served, seed: int, models: Dict, ets_cfg: Dict,
          limits: Dict, control: Optional[Dict] = None):
    """(checks, readings, info): ``checks`` maps each number the cell
    compares (the keys of its limits) to its value, its limit and, with
    ``control`` (lm / prm / embedder -> the control's precision), the
    control's reading; ``readings`` holds every number read, compared
    or not, and the control's beside them."""
    probs = sample(served, seed)
    ctl = control or {}
    lw, ls = models["lm"]
    pw, ps = models["prm"]
    ew, es = models["embedder"]
    read, read_c, info = {}, {}, {"problems": probs}
    for name, (r, rc, i) in {
            "lm": lm_gap(served, probs, lw, ls, seed, ctl.get("lm")),
            "prm": prm_gap(served, probs, pw, ps, seed, ctl.get("prm")),
            "embedder": embed_err(served, probs, ew, es,
                                  ctl.get("embedder")),
            "ets": ets_mismatch(served, probs, ets_cfg)}.items():
        read.update(r)
        read_c.update(rc)
        info[name] = i
    checks = {}
    for k, lim in limits.items():
        checks[k] = {"value": read[k], "limit": lim}
        if k in read_c:
            checks[k]["control"] = read_c[k]
    return checks, {"served": read, "control": read_c}, info
