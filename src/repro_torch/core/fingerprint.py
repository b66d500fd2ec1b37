"""Behavioral fingerprints (ELSA §III.B.1, Eqs. 4–6).

Each client's behavior on the public probe set is summarized as a
multivariate Gaussian over its pooled hidden representations (the split
model's ``probe_repr``: ``[CLS]`` for the encoder).  Pairwise behavioral discrepancy is the symmetrized KL
divergence between those Gaussians.

The counterpart of the JAX package's ``repro/core/fingerprint.py``: the
same closed forms on the embeddings' device, via Cholesky factors and
triangular solves.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch


class Fingerprint(NamedTuple):
    mu: torch.Tensor      # (D,)
    sigma: torch.Tensor   # (D, D)


def fingerprint(embeddings: torch.Tensor, ridge: float = 1e-3) -> Fingerprint:
    """Eq. 4: R_n = N(mu_n, Sigma_n) from probe embeddings (Q, D).

    A ridge term keeps Sigma positive-definite when Q < D."""
    acc = torch.promote_types(embeddings.dtype, torch.float32)
    embeddings = embeddings.to(acc)
    q, d = embeddings.shape
    mu = embeddings.mean(0)
    centered = embeddings - mu
    sigma = (centered.T @ centered) / q + ridge * torch.eye(
        d, dtype=acc, device=embeddings.device)
    return Fingerprint(mu, sigma)


def kl_gaussian(a: Fingerprint, b: Fingerprint) -> torch.Tensor:
    """Eq. 6: closed-form KL(N_a || N_b), via Cholesky for stability."""
    d = a.mu.shape[0]
    lb = torch.linalg.cholesky(b.sigma)
    la = torch.linalg.cholesky(a.sigma)
    # tr(Sigma_b^-1 Sigma_a) = ||Lb^-1 La||_F^2
    m = torch.linalg.solve_triangular(lb, la, upper=False)
    tr = torch.sum(m * m)
    diff = b.mu - a.mu
    y = torch.linalg.solve_triangular(lb, diff[:, None], upper=False)[:, 0]
    maha = torch.sum(y * y)
    logdet = 2.0 * (torch.sum(torch.log(torch.diagonal(lb)))
                    - torch.sum(torch.log(torch.diagonal(la))))
    return 0.5 * (tr - d + logdet + maha)


def sym_kl(a: Fingerprint, b: Fingerprint) -> torch.Tensor:
    """Eq. 5: R(n, n') = KL(a||b) + KL(b||a)."""
    return kl_gaussian(a, b) + kl_gaussian(b, a)


def divergence_matrix(fps: Sequence[Fingerprint]) -> np.ndarray:
    """Dense (N, N) symmetric KLD matrix (host-side; N is small)."""
    n = len(fps)
    out = np.zeros((n, n), np.float64)
    for i in range(n):
        for j in range(i + 1, n):
            v = float(sym_kl(fps[i], fps[j]))
            out[i, j] = out[j, i] = v
    return out

