"""Edge-network geometry and resource profiles (ELSA §IV.A: 20 clients,
4 edge servers in an 8km x 8km area; B_n in [50, 100] Mbps), plus the
client availability (churn) traces consumed by the event-driven runtime
(:mod:`repro_torch.runtime`): per-client alternating on/off renewal
processes with exponential dwell times, and the :class:`FaultTrace`
companion that injects crashes, dropped/duplicated uplinks, and corrupted
adapter updates on a deterministic seeded schedule.

The counterpart of the JAX package's ``repro/federation/topology.py``:
numpy only, the same draws, so every array and every sampled fault comes
out bit-equal; :func:`corrupt_update` acts on the port's trees of
tensors.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.optimizers import tree_map


@dataclasses.dataclass
class Topology:
    client_xy: np.ndarray      # (N, 2) km
    edge_xy: np.ndarray        # (K, 2) km
    latency: np.ndarray        # (N, K) ms round-trip
    bandwidth: np.ndarray      # (N,) bytes/s uplink
    capacity: np.ndarray       # (N,) FLOP/s


def make_topology(n_clients: int, n_edges: int, *, area_km: float = 8.0,
                  base_ms: float = 20.0, ms_per_km: float = 25.0,
                  jitter_ms: float = 30.0,
                  bw_mbps: Tuple[float, float] = (50.0, 100.0),
                  flops_range: Tuple[float, float] = (5e9, 1e11),
                  constrained_frac: float = 0.0,
                  seed: int = 0) -> Topology:
    rng = np.random.default_rng(seed)
    cxy = rng.uniform(0, area_km, (n_clients, 2))
    # edges on a grid
    g = int(np.ceil(np.sqrt(n_edges)))
    pts = [(area_km * (i + 0.5) / g, area_km * (j + 0.5) / g)
           for i in range(g) for j in range(g)]
    exy = np.asarray(pts[:n_edges])
    dist = np.linalg.norm(cxy[:, None, :] - exy[None, :, :], axis=-1)
    lat = base_ms + ms_per_km * dist + rng.exponential(jitter_ms,
                                                       size=dist.shape)
    bw = rng.uniform(bw_mbps[0], bw_mbps[1], n_clients) * 1e6 / 8.0
    cap = rng.uniform(*flops_range, n_clients)
    if constrained_frac > 0:
        k = int(constrained_frac * n_clients)
        idx = rng.choice(n_clients, k, replace=False)
        cap[idx] = rng.uniform(flops_range[0], flops_range[0] * 4, k)
        bw[idx] = bw[idx] * 0.3
    return Topology(cxy, exy, lat, bw, cap)


# ---------------------------------------------------------------------------
# client availability / churn
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ChurnTrace:
    """Per-client offline intervals over a finite horizon.

    ``offline[n]`` is an (M_n, 2) array of non-overlapping, sorted
    ``[start, end)`` intervals during which client n is unreachable.
    Work that overlaps an offline interval pauses and resumes on rejoin
    (device churn, not data loss).  Beyond ``horizon_s`` every client is
    treated as always-on, so simulations that outrun the trace stay
    well-defined.
    """
    offline: List[np.ndarray]
    horizon_s: float

    def is_online(self, n: int, t: float) -> bool:
        for s, e in self.offline[n]:
            if s <= t < e:
                return False
            if s > t:
                break
        return True

    def next_online(self, n: int, t: float) -> float:
        """Earliest time >= t at which client n is online."""
        for s, e in self.offline[n]:
            if s <= t < e:
                return float(e)
            if s > t:
                break
        return t

    def finish_time(self, n: int, start: float, work_s: float) -> float:
        """When ``work_s`` seconds of on-device work started at ``start``
        completes, pausing across every offline interval it straddles."""
        t = self.next_online(n, start)
        remaining = work_s
        for s, e in self.offline[n]:
            if e <= t:
                continue
            gap = s - t               # online time before this outage
            if gap >= remaining:
                return t + remaining
            remaining -= max(gap, 0.0)
            t = float(e)              # pause: resume at rejoin
        return t + remaining


def always_on(n_clients: int) -> ChurnTrace:
    """Degenerate trace: every client permanently available."""
    return ChurnTrace([np.zeros((0, 2))] * n_clients, 0.0)


def make_churn_trace(n_clients: int, horizon_s: float, *,
                     mean_on_s: float = 60.0, mean_off_s: float = 20.0,
                     churn_frac: float = 1.0, seed: int = 0,
                     version: int = 2) -> ChurnTrace:
    """Alternating-renewal availability traces (exponential dwell times).

    A ``churn_frac`` fraction of clients cycles online/offline with mean
    dwell times ``mean_on_s`` / ``mean_off_s``; the rest are always on.
    Every client starts online (the first outage begins after one on-dwell),
    matching the common FL assumption that the round-0 cohort is reachable.

    ``version=2`` (default) generates all clients' renewal processes with
    batched draws — 10^5 population-scale clients in milliseconds where
    the per-client loop took minutes.  ``version=1`` keeps the original
    sequential generator; the two sample the *same distribution* but not
    the same bits (the legacy generator interleaves every client's draws
    on one shared stream, which no batched layout can reproduce), so v1
    stays available for traces pinned by old seeds (the JAX package pins
    its bits in ``tests/test_population.py``).
    """
    if version not in (1, 2):
        raise ValueError(f"unknown churn-trace version {version}")
    rng = np.random.default_rng(seed)
    churny = rng.choice(n_clients, int(round(churn_frac * n_clients)),
                        replace=False)
    if version == 1:
        churny_set = set(churny.tolist())
        offline: List[np.ndarray] = []
        for n in range(n_clients):
            if n not in churny_set:
                offline.append(np.zeros((0, 2)))
                continue
            ivals, t = [], float(rng.exponential(mean_on_s))
            while t < horizon_s:
                off = float(rng.exponential(mean_off_s))
                ivals.append((t, t + off))
                t += off + float(rng.exponential(mean_on_s))
            offline.append(np.asarray(ivals, float).reshape(-1, 2))
        return ChurnTrace(offline, float(horizon_s))

    offline = [np.zeros((0, 2))] * n_clients
    m = len(churny)
    if m:
        # batched renewal construction: draw on/off dwell blocks for all
        # churny clients at once and cumsum the interleaved sequence;
        # extend by more columns for the (exponentially rare) clients
        # whose renewal process hasn't crossed the horizon yet
        guess = max(4, int(horizon_s / (mean_on_s + mean_off_s) * 2) + 8)
        ons = rng.exponential(mean_on_s, (m, guess))
        offs = rng.exponential(mean_off_s, (m, guess))
        while (ons.sum(1) + offs.sum(1) < horizon_s).any():
            ons = np.concatenate(
                [ons, rng.exponential(mean_on_s, (m, guess))], axis=1)
            offs = np.concatenate(
                [offs, rng.exponential(mean_off_s, (m, guess))], axis=1)
        # outage i starts after i+1 on-dwells and i off-dwells
        starts = np.cumsum(ons, axis=1)
        starts[:, 1:] += np.cumsum(offs[:, :-1], axis=1)
        ends = starts + offs
        live = starts < horizon_s
        counts = live.sum(1)
        flat = np.stack([starts[live], ends[live]], axis=-1)
        for cid, ivals in zip(churny,
                              np.split(flat, np.cumsum(counts)[:-1])):
            offline[int(cid)] = ivals
    return ChurnTrace(offline, float(horizon_s))


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

FAULT_KINDS = ("crash", "drop", "dup", "corrupt")
CORRUPT_MODES = ("nan", "inf", "signflip", "scale")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected fault on a single client dispatch.

    ``kind``: ``"crash"`` (the client dies mid-round — its work is lost,
    not paused; churn models the *paused* case), ``"drop"`` (the client
    finishes but its uplink never reaches the edge), ``"dup"`` (the
    uplink arrives twice), or ``"corrupt"`` (the update arrives
    mangled, flavored by ``mode``: all-NaN, all-Inf, sign-flipped about
    the dispatch model, or norm-scaled Byzantine
    ``base + scale * (update - base)``).
    ``at_frac``: for crashes, the fraction of the round's duration
    survived before dying.
    """
    kind: str
    mode: str = ""
    scale: float = 10.0
    at_frac: float = 0.5


@dataclasses.dataclass
class FaultTrace:
    """Seeded per-dispatch fault schedule, the :class:`ChurnTrace`
    companion for *misbehavior* rather than availability.

    The fault hitting client ``n``'s ``i``-th dispatch is a pure
    function of ``(seed, n, i)`` — sampled from a
    ``np.random.SeedSequence(seed, spawn_key=(n, i))`` stream, not from
    shared RNG state — so the schedule is identical across schedulers
    and across screened/unscreened runs.
    Only clients in ``faulty`` misbehave (``None`` = everyone is
    eligible); per dispatch, at most one fault fires, with kind
    probabilities ``crash/drop/dup/corrupt_rate``.
    """
    n_clients: int
    crash_rate: float = 0.0
    drop_rate: float = 0.0
    dup_rate: float = 0.0
    corrupt_rate: float = 0.0
    corrupt_modes: Tuple[str, ...] = ("nan", "signflip", "scale")
    corrupt_scale: float = 10.0
    faulty: Optional[Tuple[int, ...]] = None
    seed: int = 0

    def __post_init__(self):
        rates = (self.crash_rate, self.drop_rate, self.dup_rate,
                 self.corrupt_rate)
        if any(r < 0 for r in rates) or sum(rates) > 1.0 + 1e-9:
            raise ValueError(f"fault rates must be >= 0 and sum <= 1, "
                             f"got {rates}")
        bad = [m for m in self.corrupt_modes if m not in CORRUPT_MODES]
        if bad:
            raise ValueError(f"unknown corrupt modes {bad}; "
                             f"expected among {CORRUPT_MODES}")
        self._faulty_set = (None if self.faulty is None
                            else frozenset(self.faulty))

    def sample(self, client: int, dispatch_idx: int) -> Optional[Fault]:
        """The fault (or None) hitting this client's i-th dispatch."""
        if self._faulty_set is not None and client not in self._faulty_set:
            return None
        rng = np.random.default_rng(np.random.SeedSequence(
            self.seed, spawn_key=(client, dispatch_idx)))
        u = float(rng.random())
        for kind, rate in (("crash", self.crash_rate),
                           ("drop", self.drop_rate),
                           ("dup", self.dup_rate),
                           ("corrupt", self.corrupt_rate)):
            if u < rate:
                mode, scale = "", self.corrupt_scale
                if kind == "corrupt":
                    mode = self.corrupt_modes[
                        int(rng.integers(len(self.corrupt_modes)))]
                return Fault(kind, mode=mode, scale=scale,
                             at_frac=float(rng.random()))
            u -= rate
        return None


def make_fault_trace(n_clients: int, *, faulty_frac: float = 1.0,
                     crash_rate: float = 0.0, drop_rate: float = 0.0,
                     dup_rate: float = 0.0, corrupt_rate: float = 0.0,
                     corrupt_modes: Tuple[str, ...] = ("nan", "signflip",
                                                       "scale"),
                     corrupt_scale: float = 10.0,
                     seed: int = 0) -> FaultTrace:
    """Pick a seeded ``faulty_frac`` subset of clients and give them the
    requested per-dispatch fault rates (everyone else stays honest)."""
    rng = np.random.default_rng(seed)
    k = int(round(faulty_frac * n_clients))
    faulty = tuple(sorted(int(x) for x in
                          rng.choice(n_clients, k, replace=False)))
    return FaultTrace(n_clients, crash_rate=crash_rate, drop_rate=drop_rate,
                      dup_rate=dup_rate, corrupt_rate=corrupt_rate,
                      corrupt_modes=tuple(corrupt_modes),
                      corrupt_scale=corrupt_scale, faulty=faulty, seed=seed)


def corrupt_update(base, update, fault: Fault):
    """Apply a ``corrupt`` fault to an arriving adapter update.

    ``base`` is the model the client was dispatched from: sign-flip and
    Byzantine scaling act on the *delta* the client trained, which is
    what a malicious participant controls.
    """
    if fault.mode == "nan":
        return tree_map(lambda u: torch.full_like(u, float("nan")), update)
    if fault.mode == "inf":
        return tree_map(lambda u: torch.full_like(u, float("inf")), update)
    if fault.mode == "signflip":
        return tree_map(lambda b, u: (2.0 * b - u).to(u.dtype), base, update)
    if fault.mode == "scale":
        return tree_map(lambda b, u: (b + fault.scale * (u - b)).to(u.dtype),
                        base, update)
    raise ValueError(f"not a corrupt fault: {fault!r}")
