"""Edge- and cloud-level aggregation (ELSA §III.B.2, Eqs. 14–16).

Two adapter-aggregation modes (:func:`aggregate_adapters`):

- ``"factor"`` — the per-leaf weighted mean of the LoRA factors.
- ``"product"`` — aggregate in the weight-delta space: each client's
  ``ΔW = A·B``, the weighted mean of the ΔW trees, and a re-fit of the
  factors to that mean anchored at the factor mean: ``A ← mean(A_i)`` and
  ``B ← mean(B_i) + A⁺ (ΔW_mean − A·mean(B_i))``.

The counterpart of the JAX package's ``repro/core/aggregation.py``.  One
layout difference: the JAX package stacks a model's layers on a leading
axis of every leaf under ``"blocks"``, the port keeps ``"blocks"`` as a
list of per-layer dicts.  So a factor pair here is one layer's ``<t>_a``
(..., r) and ``<t>_b`` (r, ...), and :func:`pair_delta` and
:func:`refactor_delta` act on one layer (the JAX functions map over the
layer axis).  Weights are normalised in float64 and applied as Python
floats, as in the JAX package.  Non-pair leaves (pooler/head/bias) always
take the plain weighted mean.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.optim.optimizers import tree_leaves, tree_map


def fedavg(trees: Sequence, weights: Sequence[float]):
    """Weighted average of parameter trees."""
    if not trees:
        raise ValueError("fedavg: no trees to aggregate")
    w = np.asarray(weights, np.float64)
    w = [float(x) for x in w / max(w.sum(), 1e-12)]

    def avg(*leaves):
        out = leaves[0] * w[0]
        for wi, leaf in zip(w[1:], leaves[1:]):
            out = out + wi * leaf
        return out
    return tree_map(avg, *trees)


# ---------------------------------------------------------------------------
# product-space (weight-delta) adapter aggregation
# ---------------------------------------------------------------------------

def _pair_targets(node) -> List[str]:
    """LoRA factor-pair targets in a dict node: ``t`` for ``t_a``/``t_b``."""
    if not isinstance(node, dict):
        return []
    return sorted(t[:-2] for t in node
                  if t.endswith("_a") and f"{t[:-2]}_b" in node)


def pair_delta(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One layer's weight delta ``ΔW = A·B``: ``a`` (..., r) with the rank
    axis last, ``b`` (r, ...) with it first -> (m, k), ``m =
    prod(a.shape[:-1])``, ``k = prod(b.shape[1:])``.  The LoRA ``alpha/r``
    scale commutes with averaging, so deltas stay unscaled."""
    return a.reshape(-1, a.shape[-1]) @ b.reshape(b.shape[0], -1)


def refactor_delta(dw: torch.Tensor, a_mean: torch.Tensor,
                   b_mean: torch.Tensor, eps: float = 1e-8):
    """Re-fit one layer's factor pair to the mean delta, anchored at the
    factor mean: ``A ← Ā`` and ``B ← B̄ + Ā⁺ (ΔW − Ā B̄)`` with
    ``Ā⁺ = (ĀᵀĀ + εI)⁻¹ Āᵀ`` (an r×r ridge solve)."""
    r = a_mean.shape[-1]
    am = a_mean.reshape(-1, r)
    bm = b_mean.reshape(r, -1)
    res = dw - am @ bm
    gram = am.T @ am + eps * torch.eye(r, dtype=am.dtype, device=am.device)
    bn = bm + torch.linalg.solve(gram, am.T @ res)
    return a_mean, bn.reshape(b_mean.shape).to(b_mean.dtype)


def tree_to_deltas(tree):
    """Replace every factor pair with its ``<t>_dw`` product; other leaves
    pass through."""
    if isinstance(tree, dict):
        targets = _pair_targets(tree)
        if targets:
            out = {k: v for k, v in tree.items() if k[:-2] not in targets}
            for t in targets:
                out[f"{t}_dw"] = pair_delta(tree[f"{t}_a"], tree[f"{t}_b"])
            return out
        return {k: tree_to_deltas(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_deltas(v) for v in tree)
    return tree


def deltas_to_tree(deltas, fmean):
    """Re-fit the factor-mean tree ``fmean`` to a delta-tree: every factor
    pair gets the anchored pinv correction; non-pair leaves are taken from
    ``deltas`` (they were plain-averaged there)."""
    if isinstance(fmean, dict):
        targets = _pair_targets(fmean)
        if targets:
            out = {k: deltas[k] for k in fmean if k[:-2] not in targets}
            for t in targets:
                out[f"{t}_a"], out[f"{t}_b"] = refactor_delta(
                    deltas[f"{t}_dw"], fmean[f"{t}_a"], fmean[f"{t}_b"])
            return out
        return {k: deltas_to_tree(deltas[k], v) for k, v in fmean.items()}
    if isinstance(fmean, (list, tuple)):
        return type(fmean)(deltas_to_tree(d, v)
                           for d, v in zip(deltas, fmean))
    return deltas


def product_fedavg(trees: Sequence, weights: Sequence[float]):
    """Weighted mean in the weight-delta space, re-fit to rank-r factors
    anchored at the factor mean."""
    if len(trees) == 1:
        return trees[0]        # exact: nothing to correct
    fmean = fedavg(trees, weights)
    deltas = fedavg([tree_to_deltas(t) for t in trees], weights)
    return deltas_to_tree(deltas, fmean)


def aggregate_adapters(trees: Sequence, weights: Sequence[float],
                       mode: str = "factor"):
    """``"factor"`` (leafwise mean, :func:`fedavg`) or ``"product"``
    (weight-delta mean re-fit to factors)."""
    if mode == "factor":
        return fedavg(trees, weights)
    if mode == "product":
        return product_fedavg(trees, weights)
    raise ValueError(f"unknown aggregation mode {mode!r}")


def trimmed_mean(trees: Sequence, trim_frac: float = 0.25):
    """Coordinate-wise trimmed mean across client trees.

    Per coordinate, the ``int(trim_frac * n)`` smallest and largest
    values are discarded and the rest averaged (Yin et al. 2018), the
    screening stage's small-cohort fallback.  Callers pass finite trees
    (NaNs sort to the top and would survive a one-sided trim)."""
    n = len(trees)
    if n == 0:
        raise ValueError("trimmed_mean: no trees to aggregate")
    if not 0.0 <= trim_frac < 0.5:
        raise ValueError(f"trim_frac must be in [0, 0.5), got {trim_frac}")
    k = min(int(trim_frac * n), (n - 1) // 2)

    def f(*leaves):
        x = torch.sort(torch.stack(leaves), dim=0).values
        # a sum in row order times the reciprocal count: XLA's mean, bit
        # for bit (torch's sum over the rows splits them into partial sums)
        total = x[k]
        for row in x[k + 1:n - k]:
            total = total + row
        return (total * (1.0 / (n - 2 * k))).to(leaves[0].dtype)

    return tree_map(f, *trees)


def mix_adapters(theta, update, w: float, mode: str = "factor"):
    """Asynchronous edge fold ``θ ← (1-w)·θ + w·update`` in the chosen
    space (the async scheduler's staleness-weighted mixing)."""
    if mode == "product":
        return product_fedavg([theta, update], [1.0 - w, w])
    return tree_map(lambda a, b: (1.0 - w) * a + w * b, theta, update)


def edge_weight(mean_pairwise_kld: float, mean_trust: float) -> float:
    """Eq. 14: alpha_k = (1 / (1 + R̄_k)) * w̄_k^trust."""
    return (1.0 / (1.0 + mean_pairwise_kld)) * mean_trust


def mean_pairwise_kld(div: np.ndarray, members: List[int]) -> float:
    """R̄_k over a client group (Eq. 14's coherence term)."""
    if len(members) < 2:
        return 0.0
    sub = div[np.ix_(members, members)]
    n = len(members)
    return float(sub.sum() / (n * (n - 1)))


def cloud_aggregate(edge_params: Dict[int, object],
                    alphas: Dict[int, float], mode: str = "factor"):
    """Eq. 15: theta_g = sum_k alpha~_k theta_{g,k}, over the edges in
    sorted order; negative weights are clipped to 0."""
    ks = sorted(edge_params)
    weights = [max(alphas[k], 0.0) for k in ks]
    return aggregate_adapters([edge_params[k] for k in ks], weights,
                              mode=mode)


def global_delta(theta_new, theta_old) -> float:
    """Eq. 16's ||theta_g - theta_{g-1}||_2, the squares summed per leaf in
    at least f32 and the leaves' sums added on the host in leaf order (one
    device sync)."""
    sq = torch.stack([
        torch.sum(torch.square((a - b).to(torch.promote_types(
            a.dtype, torch.float32)))).to(torch.float64)
        for a, b in zip(tree_leaves(theta_new), tree_leaves(theta_old))])
    return float(np.sqrt(sum(sq.tolist())))
