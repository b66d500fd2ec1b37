"""Trust- and communication-aware client clustering (ELSA §III.B.1,
Stages 1–4).

Host-side orchestration (numpy/scipy): N is tens-to-hundreds of clients.
The JAX package's ``repro/core/clustering.py``, copied.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import scipy.linalg


@dataclasses.dataclass
class ClusterResult:
    groups: Dict[int, List[int]]        # edge k -> client ids (the N_k)
    escalated: List[int]                # clients escalated to cloud-level
    excluded: List[int]                 # out-of-range / untrusted clients
    assignment: Dict[int, Optional[int]]  # client -> edge (None = excluded)
    group_trust: Dict[int, float]       # edge k -> mean trust of its group


def feasible_edges(latency: np.ndarray, tau_max: float) -> List[List[int]]:
    """Stage 0: E_n = {k | tau_nk <= tau_max}.  latency: (N, K)."""
    return [list(np.nonzero(latency[n] <= tau_max)[0])
            for n in range(latency.shape[0])]


def _kmeans(x: np.ndarray, k: int, iters: int = 50, seed: int = 0):
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    centers = x[rng.choice(n, size=k, replace=False)]
    labels = np.zeros(n, np.int64)
    for _ in range(iters):
        d = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
        new = d.argmin(1)
        if (new == labels).all():
            break
        labels = new
        for c in range(k):
            pts = x[labels == c]
            if len(pts):
                centers[c] = pts.mean(0)
    return labels


def spectral_cluster(affinity: np.ndarray, n_clusters: int,
                     seed: int = 0) -> np.ndarray:
    """Normalized spectral clustering (Ng–Jordan–Weiss)."""
    n = affinity.shape[0]
    n_clusters = min(n_clusters, n)
    if n_clusters <= 1 or n <= 2:
        return np.zeros(n, np.int64)
    a = affinity.copy()
    np.fill_diagonal(a, 0.0)
    deg = a.sum(1)
    d_inv_sqrt = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    lap = np.eye(n) - d_inv_sqrt[:, None] * a * d_inv_sqrt[None, :]
    vals, vecs = scipy.linalg.eigh(lap)
    emb = vecs[:, :n_clusters]
    norms = np.linalg.norm(emb, axis=1, keepdims=True)
    emb = emb / np.maximum(norms, 1e-12)
    return _kmeans(emb, n_clusters, seed=seed)


def affinity_matrix(div: np.ndarray, trust: np.ndarray,
                    gamma: float) -> np.ndarray:
    """Stage 2 affinity: A_{nn'} = w_n w_n' exp(-gamma R(n,n'))."""
    return np.outer(trust, trust) * np.exp(-gamma * div)


def cluster_clients(div: np.ndarray, trust: np.ndarray, latency: np.ndarray,
                    *, tau_max: float = 200.0, gamma: float = 1.0,
                    w_min: float = 0.3, clusters_per_edge: int = 2,
                    seed: int = 0) -> ClusterResult:
    """Full Stage 1–4 pipeline.

    div: (N, N) symmetric KLD matrix; trust: (N,); latency: (N, K) in ms.
    """
    n_clients, n_edges = latency.shape
    feas = feasible_edges(latency, tau_max)
    # normalize gamma to the divergence scale so exp(-gamma R) is informative
    pos = div[div > 0]
    gamma_eff = gamma / max(float(np.median(pos)) if len(pos) else 1.0, 1e-9)
    # trust scores are scale-normalized (repro.core.trust); interpret w_min
    # RELATIVE to the population mean so the threshold is calibration-free
    w_thresh = w_min * max(float(trust.mean()), 1e-9)

    # Stage 1–2: per-edge candidate sets and spectral clustering
    per_edge_groups: Dict[int, List[List[int]]] = {}
    for k in range(n_edges):
        ck = [nn for nn in range(n_clients) if k in feas[nn]]
        if not ck:
            per_edge_groups[k] = []
            continue
        sub = div[np.ix_(ck, ck)]
        aff = affinity_matrix(sub, trust[ck], gamma_eff)
        labels = spectral_cluster(aff, clusters_per_edge, seed=seed)
        per_edge_groups[k] = [
            [ck[i] for i in np.nonzero(labels == c)[0]]
            for c in range(labels.max() + 1)]

    # per edge: keep every sub-cluster whose mean trust clears w_min
    # (low-trust sub-clusters are dropped here; group-level rescue/merge
    # happens in Stages 3-4); if none clears, keep the best-scoring one.
    chosen: Dict[int, List[int]] = {}
    for k, groups in per_edge_groups.items():
        kept: List[int] = []
        best, best_score = [], -np.inf
        for g in groups:
            if not g:
                continue
            mean_trust = trust[g].mean()
            score = mean_trust * np.sqrt(len(g))
            if score > best_score:
                best, best_score = g, score
            if mean_trust >= w_thresh:
                kept.extend(g)
        chosen[k] = kept if kept else best

    # resolve clients claimed by several edges: lowest latency wins
    assignment: Dict[int, Optional[int]] = {nn: None for nn in range(n_clients)}
    for nn in range(n_clients):
        claimants = [k for k, g in chosen.items() if nn in g]
        if claimants:
            assignment[nn] = int(min(claimants, key=lambda k: latency[nn, k]))
    groups = {k: [nn for nn in range(n_clients) if assignment[nn] == k]
              for k in range(n_edges)}

    # Stage 3–4: low-trust clusters merge into nearest high-trust cluster
    # (centroid KLD) or escalate to the cloud.
    group_trust = {k: (float(trust[g].mean()) if g else 0.0)
                   for k, g in groups.items()}
    escalated: List[int] = []
    for k in list(groups):
        g = groups[k]
        if not g or group_trust[k] >= w_thresh:
            continue
        # centroid distance to other groups = mean cross-KLD
        targets = [k2 for k2 in groups
                   if k2 != k and groups[k2] and group_trust[k2] >= w_thresh]
        if targets:
            def cross(k2):
                return float(div[np.ix_(g, groups[k2])].mean())
            k_best = min(targets, key=cross)
            groups[k_best] = groups[k_best] + g
        else:
            escalated.extend(g)
        groups[k] = []
        group_trust[k] = 0.0
    for k in groups:
        if groups[k]:
            group_trust[k] = float(trust[groups[k]].mean())
        for nn in groups[k]:
            assignment[nn] = k
    for nn in escalated:
        assignment[nn] = None

    excluded = [nn for nn in range(n_clients)
                if assignment[nn] is None and nn not in escalated]
    return ClusterResult(groups=groups, escalated=escalated,
                         excluded=excluded, assignment=assignment,
                         group_trust=group_trust)
