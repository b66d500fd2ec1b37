"""Resource-aware dynamic model splitting (ELSA §III.B.2, Eqs. 7–9).

Partitions an M-block model into (p_n, q_n, o_fix): Part 1 (client),
Part 2 (edge), Part 3 (client, fixed depth for label privacy).

The JAX package's ``repro/core/splitting.py``, copied (plain Python).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class SplitPolicy:
    num_blocks: int          # M
    o_fix: int = 2           # output segment depth (label privacy)
    p_min: int = 1           # minimum client-side encoder depth (privacy)
    p_max: int = 6           # empirically determined (paper Fig. 6b)
    lambda1: float = 0.5     # compute weight in the preference score
    lambda2: float = 0.5     # bandwidth weight

    def __post_init__(self):
        assert self.p_max + self.o_fix < self.num_blocks, \
            "p_max + o_fix must leave at least one block for the edge"
        assert abs(self.lambda1 + self.lambda2 - 1.0) < 1e-9
        if self.p_max < self.p_min or self.p_min < 1:
            # a p_max below p_min silently yields splits like
            # Split(p=-1, ...), whose negative block indices wrap around
            # and run the LAST layer as Part 1/2 — training then runs a
            # scrambled deeper network than evaluation (the discrepancy
            # behind chance-level accuracy on too-shallow configs)
            raise ValueError(
                f"model too shallow to split: need num_blocks >= "
                f"p_min + 1 + o_fix = {self.p_min + 1 + self.o_fix} "
                f"(got M={self.num_blocks}, p range "
                f"[{self.p_min}, {self.p_max}], o={self.o_fix})")


def offload_score(h_n: float, h_max: float, b_n: float, b_max: float,
                  policy: SplitPolicy) -> float:
    """Eq. 7: G_n = λ1 (1 - H_n/H_max) + λ2 B_n/B_max  ∈ [0, 1]."""
    return (policy.lambda1 * (1.0 - h_n / max(h_max, 1e-9))
            + policy.lambda2 * (b_n / max(b_max, 1e-9)))


def split_for_client(h_n: float, b_n: float, h_max: float, b_max: float,
                     policy: SplitPolicy) -> Tuple[int, int, int]:
    """Eqs. 8–9: (p_n, q_n, o_fix).  High G_n (weak compute or strong
    uplink) -> small p_n (offload more)."""
    g = offload_score(h_n, h_max, b_n, b_max, policy)
    p = policy.p_max - math.floor(g * (policy.p_max - policy.p_min))
    p = max(policy.p_min, min(policy.p_max, p))
    q = policy.num_blocks - policy.o_fix - p
    return p, q, policy.o_fix


def splits_for_population(capacities: Sequence[float],
                          bandwidths: Sequence[float],
                          policy: SplitPolicy):
    h_max = max(capacities)
    b_max = max(bandwidths)
    return [split_for_client(h, b, h_max, b_max, policy)
            for h, b in zip(capacities, bandwidths)]
