"""Cohort sampling + population-scale availability cursors (the
counterpart of the JAX package's ``repro/population/sampler.py``, copied:
every draw is numpy, so cohorts are bit-identical across packages).

:class:`CohortSampler` picks each round's active client ids from the
registry.  Sampling is stateless per round — the round-``g`` cohort is a
pure function of ``(PopulationConfig.seed, g)`` via
``np.random.SeedSequence(seed, spawn_key=(g,))``, the same trick the
fault traces use — so schedulers that replay or resume a run re-derive
identical cohorts without threading RNG state.

Two invariants matter for bit-identity with the legacy dict path:

- the **identity fast path**: when every registered client is eligible
  and the cohort is the whole population, the sampler returns
  ``arange(k)`` without touching RNG at all, so a
  ``registered == n_clients`` population run consumes exactly the same
  random streams as a run with no population attached;
- the **uniform fast path** draws via Floyd's O(k) algorithm — cost per
  round scales with the cohort, not the registered population (only the
  eligibility-filtered paths pay one vectorized O(N) mask).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.federation.topology import ChurnTrace

STRATEGIES = ("uniform", "round-robin")


@dataclasses.dataclass
class PopulationConfig:
    """Knobs of the registry-backed population."""
    registered: int                    # registered population size (>= the
                                       # federation's n_clients slot count)
    cohort: Optional[int] = None       # active cohort per round; None ->
                                       # the federation's n_clients (the
                                       # only supported value: slots are
                                       # the cohort)
    strategy: str = "uniform"          # "uniform" | "round-robin"
    min_trust: float = 0.0             # eligibility floor on the trust EMA
    seed: int = 0                      # cohort-sampling stream seed
    churn: Optional[ChurnTrace] = None # population-sized availability
                                       # trace; offline clients are not
                                       # sampled (cursor-advanced, O(1)
                                       # amortized per query)
    store_adapters: bool = True        # keep per-client LoRA deltas in the
                                       # registry (off: scalar columns only)
    shard_rows: int = 256              # adapter-column rows per lazy shard
    adapter_dtype: str = "float32"
    staleness_beta: float = 0.8        # staleness-EMA retention
    data_cache: int = 0                # synthesized-client LRU capacity;
                                       # 0 -> max(4 x cohort, 64)
    channel_cache: int = 0             # identity SS-OP channel LRU
                                       # capacity; 0 -> the data-cache
                                       # default (evicted rotations
                                       # regenerate bit-exactly from the
                                       # identity's seed)

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown sampling strategy "
                             f"{self.strategy!r}; expected {STRATEGIES}")
        if self.registered < 1:
            raise ValueError("registered must be >= 1")
        if not 0.0 <= self.staleness_beta <= 1.0:
            raise ValueError("staleness_beta must be in [0, 1]")
        if self.churn is not None \
                and len(self.churn.offline) < self.registered:
            raise ValueError(
                f"population churn trace covers {len(self.churn.offline)} "
                f"clients, need >= registered={self.registered}")


class AvailabilityCursors:
    """Vectorized, cursor-advanced online mask over a
    :class:`~repro_torch.federation.topology.ChurnTrace`.

    The trace's ragged per-client interval lists pad into ``(N, M, 2)``
    matrices once; ``online_mask(t)`` then advances one int64 cursor per
    client past expired intervals and compares the current interval only
    — amortized O(1) per client per query for the monotone timestamps
    schedulers produce (a backwards query resets the cursors and
    re-advances, still correct, just not O(1)).
    """

    def __init__(self, trace: ChurnTrace, n: Optional[int] = None,
                 cursors: Optional[np.ndarray] = None):
        n = len(trace.offline) if n is None else n
        m = max((len(iv) for iv in trace.offline[:n]), default=0)
        self.starts = np.full((n, max(m, 1)), np.inf)
        self.ends = np.full((n, max(m, 1)), np.inf)
        for i, iv in enumerate(trace.offline[:n]):
            if len(iv):
                self.starts[i, :len(iv)] = iv[:, 0]
                self.ends[i, :len(iv)] = iv[:, 1]
        self.cursor = (np.zeros(n, np.int64) if cursors is None
                       else np.asarray(cursors, np.int64).copy())
        self._rows = np.arange(n)
        self._last_t = -np.inf

    def online_mask(self, t: float) -> np.ndarray:
        if t < self._last_t:
            self.cursor[:] = 0
        self._last_t = t
        top = len(self.starts[0]) - 1
        while True:
            e = self.ends[self._rows, self.cursor]
            behind = (e <= t) & (self.cursor < top)
            if not behind.any():
                break
            self.cursor[behind] += 1
        s = self.starts[self._rows, self.cursor]
        e = self.ends[self._rows, self.cursor]
        return ~((s <= t) & (t < e))


def _floyd_sample(rng: np.random.Generator, n: int, k: int) -> np.ndarray:
    """k distinct uniform draws from range(n) in O(k) (Floyd's
    algorithm) — never materializes the population."""
    chosen = set()
    for j in range(n - k, n):
        t = int(rng.integers(0, j + 1))
        chosen.add(j if t in chosen else t)
    return np.fromiter(chosen, np.int64, len(chosen))


class CohortSampler:
    """Materializes each round's active cohort from the registry."""

    def __init__(self, registry, cfg: PopulationConfig):
        self.registry = registry
        self.cfg = cfg
        self.avail = (AvailabilityCursors(cfg.churn, n=registry.registered)
                      if cfg.churn is not None else None)
        self.last_eligible = registry.registered

    def _rng(self, round_idx: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence(
            self.cfg.seed, spawn_key=(int(round_idx),)))

    def sample(self, round_idx: int, k: int,
               t: Optional[float] = None) -> np.ndarray:
        """Sorted ids of round ``round_idx``'s cohort (size ``k``)."""
        reg, cfg = self.registry, self.cfg
        n = reg.registered
        if k > n:
            raise ValueError(f"cohort {k} exceeds registered {n}")
        filtered = cfg.min_trust > 0.0 or self.avail is not None
        if not filtered:
            self.last_eligible = n
            if k == n:
                # identity fast path: no RNG consumed -> a population of
                # exactly the slot count is bit-inert vs the legacy path
                return np.arange(n, dtype=np.int64)
            if cfg.strategy == "uniform":
                return np.sort(_floyd_sample(self._rng(round_idx), n, k))
            return self._round_robin(np.arange(n, dtype=np.int64),
                                     round_idx, k)
        # one vectorized O(N) mask per round; everything after is O(k)
        mask = reg.trust >= cfg.min_trust
        if self.avail is not None:
            mask &= self.avail.online_mask(0.0 if t is None else t)
        elig = np.flatnonzero(mask).astype(np.int64)
        self.last_eligible = len(elig)
        if len(elig) < k:
            # not enough eligible clients: top up with the highest-trust
            # ineligible ones so a round never under-fills its slots
            rest = np.flatnonzero(~mask).astype(np.int64)
            order = np.argsort(-reg.trust[rest], kind="stable")
            elig = np.concatenate([elig, rest[order[:k - len(elig)]]])
        if len(elig) == k:
            return np.sort(elig)
        if cfg.strategy == "uniform":
            pick = _floyd_sample(self._rng(round_idx), len(elig), k)
            return np.sort(elig[pick])
        return self._round_robin(np.sort(elig), round_idx, k)

    def _round_robin(self, elig: np.ndarray, round_idx: int,
                     k: int) -> np.ndarray:
        """Deterministic wrap-around coverage: round g takes the slice
        starting at ``(g * k) % len`` — every client trains once per
        ``ceil(len/k)`` rounds."""
        start = (int(round_idx) * k) % len(elig)
        idx = (start + np.arange(k)) % len(elig)
        return np.sort(elig[idx])
