"""Server-side update screening and the per-client trust EMA.

The counterpart of the JAX package's ``repro/core/screening.py``: trust
is a live server-side quantity.

- :class:`TrustLedger` keeps one trust score per client, seeded from the
  clustering-time prediction-consistency scores and updated as an EMA of
  screening outcomes (pass -> pull toward 1, fail -> pull toward 0), so
  a client that repeatedly ships garbage loses aggregation weight even
  when an individual bad update slips past the per-round checks.
- :func:`screen_updates` applies three per-round checks to a cohort of
  incoming adapter updates, judged on their *deltas* against the edge
  model they were trained from: a finite check (NaN/Inf anywhere fails),
  a norm screen (delta norm > ``norm_k`` x the cohort's median finite
  delta norm), and a direction screen (cosine against the cohort's
  weighted-mean delta below ``cos_min``, the only cheap check that
  catches sign-flipped Byzantine updates, whose norms are
  indistinguishable from honest ones).
- :func:`screen_and_aggregate` drops failing updates, down-weights the
  survivors by their trust scores, excludes clients whose trust EMA sank
  below ``trust_floor``, and, when screening leaves too small a cohort
  to trust a plain mean, falls back to a coordinate-wise trimmed mean
  over the finite updates.

The verdicts are host-side numpy over three small vectors, which
``stats_fn`` (:func:`repro_torch.federation.engine.screen_stats`) fetches
from the device in one transfer.  Everything but the ledger is reached
only when ``FedConfig.screen`` is on.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from repro_torch import telemetry as tm
from repro_torch.core import aggregation as agg

# screening verdicts, per update
OK = "ok"
NONFINITE = "nonfinite"
NORM = "norm"
FLIP = "flip"
LOW_TRUST = "low-trust"


@dataclasses.dataclass(frozen=True)
class ScreeningConfig:
    """Thresholds of the per-round screening stage (see module doc)."""
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

    # -- checkpoint plumbing ------------------------------------------------
    def state(self) -> Dict:
        return {"beta": self.beta, "scores": self.scores,
                "passes": self.passes, "fails": self.fails}

    def load_state(self, state: Dict) -> None:
        self.beta = float(state["beta"])
        self.scores = np.asarray(state["scores"], np.float64).copy()
        self.passes = np.asarray(state["passes"], np.int64).copy()
        self.fails = np.asarray(state["fails"], np.int64).copy()


@dataclasses.dataclass
class ScreenReport:
    """One screening pass: per-update verdicts + what was aggregated."""
    clients: List[int]
    verdicts: List[str]            # parallel to ``clients``
    kept: List[int]                # indices into the cohort that aggregated
    fallback: str = ""             # "" | "trimmed" | "keep-base"

    @property
    def n_excluded(self) -> int:
        return len(self.clients) - len(self.kept)


def screen_updates(base, trees: Sequence, weights: Sequence[float],
                   clients: Sequence[int], ledger: TrustLedger,
                   cfg: ScreeningConfig,
                   stats_fn: Callable) -> ScreenReport:
    """Run the finite/norm/direction checks and update the trust EMA.

    ``stats_fn(base, trees, weights) -> (finite, norms, cos)`` supplies
    the per-update delta statistics.  Verdicts are recorded into
    ``ledger`` in cohort order; the low-trust exclusion then uses the
    *post-update* scores, so a client failing right now is judged with
    that failure already priced in.
    """
    finite, norms, cos = stats_fn(base, trees, weights)
    finite = np.asarray(finite, bool)
    norms = np.asarray(norms, np.float64)
    med = float(np.median(norms[finite])) if finite.any() else 0.0
    verdicts: List[str] = []
    for i, n in enumerate(clients):
        if not finite[i]:
            v = NONFINITE
        elif med > 0.0 and norms[i] > cfg.norm_k * med:
            v = NORM
        elif float(cos[i]) < cfg.cos_min:
            v = FLIP
        else:
            v = OK
        ledger.record(n, v == OK)
        verdicts.append(v)
    kept = [i for i, (v, n) in enumerate(zip(verdicts, clients))
            if v == OK and ledger.scores[n] >= cfg.trust_floor]
    for i in range(len(verdicts)):
        if verdicts[i] == OK and i not in kept:
            verdicts[i] = LOW_TRUST
    if tm.enabled():
        for v in verdicts:
            tm.inc("screening.verdicts", 1, verdict=v)
        tm.set_gauge("screening.trust_mean", float(ledger.scores.mean()))
        tm.set_gauge("screening.trust_min", float(ledger.scores.min()))
        tm.set_gauge("screening.below_floor",
                     int((ledger.scores < cfg.trust_floor).sum()))
    return ScreenReport(list(clients), verdicts, kept)


def screen_and_aggregate(base, trees: Sequence, weights: Sequence[float],
                         clients: Sequence[int], ledger: TrustLedger,
                         cfg: ScreeningConfig, mode: str,
                         stats_fn: Callable) -> Tuple[object, ScreenReport]:
    """Screen a cohort, then aggregate the survivors (see module doc).

    Survivor weights are the FedAvg weights scaled by the trust EMA.
    When the screened cohort is smaller than ``min_cohort`` (but the
    whole cohort is larger), the plain mean over so few updates is
    fragile, so the fallback is a coordinate-wise trimmed mean over
    every *finite* update; with zero survivors and no finite updates at
    all the edge simply keeps ``base``.
    """
    report = screen_updates(base, trees, weights, clients, ledger, cfg,
                            stats_fn)
    kept = report.kept
    if len(kept) >= min(cfg.min_cohort, len(trees)):
        wts = [float(weights[i]) * ledger.weight(clients[i]) for i in kept]
        if sum(wts) > 0.0:
            return (agg.aggregate_adapters([trees[i] for i in kept], wts,
                                           mode=mode), report)
    finite_idx = [i for i, v in enumerate(report.verdicts) if v != NONFINITE]
    if not finite_idx:
        report.fallback = "keep-base"
        tm.inc("screening.fallbacks", 1, kind="keep-base")
        return base, report
    report.fallback = "trimmed"
    tm.inc("screening.fallbacks", 1, kind="trimmed")
    return (agg.trimmed_mean([trees[i] for i in finite_idx],
                             trim_frac=cfg.trim_frac), report)
