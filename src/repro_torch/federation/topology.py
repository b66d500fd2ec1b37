"""Edge-network geometry and resource profiles (ELSA §IV.A: 20 clients,
4 edge servers in an 8km x 8km area; B_n in [50, 100] Mbps).

The part of the JAX package's ``repro/federation/topology.py`` that the
round loop uses, copied (numpy only, the same draws, so every array comes
out bit-equal).  The churn and fault traces of the event runtime wait for
ROADMAP.md, queues 4 and 5.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


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
