"""Semantic Subspace Orthogonal Perturbation (ELSA §III.B.3, Eqs. 17–19).

``Q_n = U_n V_n U_nᵀ + (I - U_n U_nᵀ)`` rotates only inside the top-r
semantic subspace U_n of recent hidden activations, with a client-secret
orthogonal V_n (QR of a seeded Gaussian).  Q_n is orthogonal, so the
backward pass restores exact gradients via Q_nᵀ.

The counterpart of the JAX package's ``repro/core/ssop.py``.  Q_n (D×D) is
never materialized: both directions apply the fused low-rank form
``H + (H U) W Uᵀ`` through :mod:`repro_torch.kernels.ssop.ops` (the
hand-written kernel on a CUDA tensor, its plain version on the CPU).
"""
from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.ssop import ops as kops


class SSOP(NamedTuple):
    u: torch.Tensor   # (D, r) orthonormal semantic basis
    v: torch.Tensor   # (r, r) secret orthogonal rotation


def semantic_subspace(j_matrix: torch.Tensor, r: int) -> torch.Tensor:
    """Eq. 17: top-r right singular vectors of J (Q, D) -> U (D, r).

    The columns' signs are LAPACK's choice, as in the JAX package; the
    subspace, and so ``U Uᵀ``, is what is determined."""
    _, _, vt = torch.linalg.svd(j_matrix.to(torch.float32),
                                full_matrices=False)
    return vt[:r].T


def client_seed(salt: str, client_id: int) -> int:
    """seed_n = Hash(s || n) (Eq. 18)."""
    h = hashlib.sha256(f"{salt}||{client_id}".encode()).digest()
    return int.from_bytes(h[:8], "little")


def random_orthogonal(r: int, seed: int, device="cuda") -> torch.Tensor:
    """Eq. 18: V_n = QR(Phi(n)), Phi ~ N(0,1) seeded.  Drawn and factored
    in numpy exactly as the JAX package does, so V_n is bit-identical."""
    rng = np.random.default_rng(seed)
    phi = rng.standard_normal((r, r))
    q, rr = np.linalg.qr(phi)
    # sign-fix so the decomposition is unique (det-stable)
    q = q * np.sign(np.diagonal(rr))[None, :]
    return torch.from_numpy(q.astype(np.float32)).to(device)


def make_ssop_from_basis(u: torch.Tensor, salt: str,
                         client_id: int) -> SSOP:
    """SSOP from a precomputed semantic basis ``U``: only the seeded
    rotation ``V_n`` depends on the identity (Eq. 18 keys it on the client
    id), so it regenerates bit-exactly from ``(salt, client_id)``."""
    r = u.shape[1]
    return SSOP(u=u, v=random_orthogonal(r, client_seed(salt, client_id),
                                         device=u.device))


def make_ssop(j_matrix: torch.Tensor, r: int, salt: str,
              client_id: int) -> SSOP:
    return make_ssop_from_basis(semantic_subspace(j_matrix, r), salt,
                                client_id)


def apply_ssop(h: torch.Tensor, ssop: SSOP) -> torch.Tensor:
    """H -> H Q_nᵀ (rows are feature vectors)."""
    return kops.ssop_apply(h, ssop.u, ssop.v)


def apply_ssop_inverse(h: torch.Tensor, ssop: SSOP) -> torch.Tensor:
    """H -> H Q_n (the exact inverse; Q orthogonal)."""
    return kops.ssop_apply_inverse(h, ssop.u, ssop.v)


def q_matrix(ssop: SSOP) -> torch.Tensor:
    """Explicit Q_n (tests only — O(D²))."""
    d = ssop.u.shape[0]
    uu = ssop.u @ ssop.u.T
    return (ssop.u @ ssop.v @ ssop.u.T
            + torch.eye(d, dtype=ssop.u.dtype, device=ssop.u.device) - uu)
