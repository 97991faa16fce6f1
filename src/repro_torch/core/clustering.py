"""Semantic clustering of trajectory steps (paper §4.2).

The paper embeds the *last step* of each candidate with a math-finetuned
BERT and runs hierarchical agglomerative clustering (cosine similarity,
fixed distance threshold).  The similarity metric is explicitly arbitrary
("our algorithm is also compatible with alternate methods"); here the
embedding source is pluggable:

  * tests / synthetic search — embeddings come with the candidates;
  * the end-to-end LM driver — a small in-repo JAX encoder
    (``repro.models.embedder``) stands in for the math-BERT.

``cluster_embeddings`` mirrors the paper: scipy hierarchical agglomerative
clustering on cosine distance with a fixed threshold.  A pure-numpy
fallback implements single-linkage agglomeration for environments without
scipy.
"""
from __future__ import annotations


import numpy as np


def cosine_distance_matrix(embs: np.ndarray) -> np.ndarray:
    """(L, D) -> (L, L) cosine distances in [0, 2]."""
    x = np.asarray(embs, dtype=np.float64)
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    x = x / np.maximum(norms, 1e-12)
    sim = np.clip(x @ x.T, -1.0, 1.0)
    return 1.0 - sim


def cluster_embeddings(embs: np.ndarray, threshold: float = 0.3,
                       method: str = "average") -> np.ndarray:
    """Agglomerative clustering; returns integer labels (L,).

    threshold: cosine-distance cut — candidates closer than this merge.
    """
    embs = np.asarray(embs)
    L = embs.shape[0]
    if L <= 1:
        return np.zeros((L,), dtype=np.int64)
    try:
        from scipy.cluster.hierarchy import fcluster, linkage
        from scipy.spatial.distance import squareform
        dm = cosine_distance_matrix(embs)
        condensed = squareform(dm, checks=False)
        Z = linkage(condensed, method=method)
        return fcluster(Z, t=threshold, criterion="distance").astype(np.int64)
    except ImportError:
        return _single_linkage(cosine_distance_matrix(embs), threshold)


def _single_linkage(dm: np.ndarray, threshold: float) -> np.ndarray:
    """Union-find single-linkage fallback."""
    L = dm.shape[0]
    parent = list(range(L))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i in range(L):
        for j in range(i + 1, L):
            if dm[i, j] < threshold:
                ra, rb = find(i), find(j)
                if ra != rb:
                    parent[ra] = rb
    roots = [find(i) for i in range(L)]
    uniq = {r: k for k, r in enumerate(dict.fromkeys(roots))}
    return np.array([uniq[r] for r in roots], dtype=np.int64)
