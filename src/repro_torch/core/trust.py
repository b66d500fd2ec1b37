"""Trustworthiness scores (ELSA §III.B.1 Step 4).

``w_n^trust = exp(-(1/Q) Σ_j 1/||T_n^(j)||_2  -  mean_n' R(n, n'))``.

The raw paper formula underflows when KLD values are large (hundreds), so
``normalize=True`` (default) rescales the mean-divergence term by the
population mean before exponentiation — a monotone transform that
preserves the ordering the score is used for (down-weighting outliers)
while keeping scores in a numerically useful range.

The JAX package's ``repro/core/trust.py``, copied (numpy only).
"""
from __future__ import annotations

import numpy as np


def inverse_confidence(probe_norms: np.ndarray) -> np.ndarray:
    """(N, Q) array of ||T_n^(j)||_2 -> (N,) mean inverse confidence."""
    return (1.0 / np.maximum(probe_norms, 1e-9)).mean(axis=1)


def trust_scores(div_matrix: np.ndarray, probe_norms: np.ndarray,
                 normalize: bool = True) -> np.ndarray:
    """Compute w_n^trust for all clients.

    div_matrix: (N, N) symmetric KLD; probe_norms: (N, Q) embedding norms.
    """
    n = div_matrix.shape[0]
    inv_conf = inverse_confidence(probe_norms)
    off = div_matrix.sum(axis=1) / max(n - 1, 1)         # mean divergence
    if normalize:
        scale = max(float(off.mean()), 1e-9)
        off = off / scale
        inv_conf = inv_conf / max(float(inv_conf.mean()), 1e-9)
    return np.exp(-inv_conf - off)
