"""Server-side update screening: its thresholds and the per-client trust
EMA.

The part of the JAX package's ``repro/core/screening.py`` that the round
loop always touches: :class:`ScreeningConfig` and :class:`TrustLedger`
(the ledger is seeded with the clustering-time trust scores on every run).
The screening pass itself (``screen_updates``, ``screen_and_aggregate``)
and the ledger's checkpoint state wait for ROADMAP.md, queue 5;
``FedConfig(screen=True)`` raises until then.
"""
from __future__ import annotations

import dataclasses
import numpy as np


@dataclasses.dataclass(frozen=True)
class ScreeningConfig:
    """Thresholds of the per-round screening stage."""
    norm_k: float = 4.0        # reject ||delta|| > norm_k * median finite
    cos_min: float = -0.5      # reject cos(delta, cohort mean) < cos_min
    trust_floor: float = 0.15  # exclude clients whose trust EMA sank below
    min_cohort: int = 2        # fewer survivors -> trimmed-mean fallback
    trim_frac: float = 0.25    # per-side trim of the fallback mean


class TrustLedger:
    """Per-client trust EMA over screening outcomes.

    ``scores`` start at 1 (or the clustering-time prediction-consistency
    scores via :meth:`seed`) and move by
    ``score <- beta * score + (1 - beta) * outcome`` with outcome 1 on a
    passed screen and 0 on a failed one.
    """

    def __init__(self, n_clients: int, beta: float = 0.7):
        if not 0.0 <= beta <= 1.0:
            raise ValueError(f"trust beta must be in [0, 1], got {beta}")
        self.beta = float(beta)
        self.scores = np.ones(n_clients, np.float64)
        self.passes = np.zeros(n_clients, np.int64)
        self.fails = np.zeros(n_clients, np.int64)

    def seed(self, trust: np.ndarray) -> None:
        """Adopt clustering-time trust scores as the EMA starting point."""
        self.scores = np.clip(np.asarray(trust, np.float64), 1e-6, 1.0).copy()

    def record(self, client: int, passed: bool) -> None:
        b = self.beta
        self.scores[client] = b * self.scores[client] \
            + (1.0 - b) * (1.0 if passed else 0.0)
        if passed:
            self.passes[client] += 1
        else:
            self.fails[client] += 1

    def weight(self, client: int) -> float:
        return float(self.scores[client])

