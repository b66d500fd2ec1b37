"""Wall-clock cost model for one client-edge local round (the counterpart
of the JAX package's ``repro/runtime/cost.py``, with the same float
arithmetic).

Compute time follows the 6·N·D training convention: a local step costs ``6 × N_client ×
tokens`` FLOPs, where ``N_client`` counts only the parameters the client
actually executes under its tripartite
:class:`~repro_torch.core.split_training.Split` — Part 1 (``p`` blocks) + Part 3 (``o`` blocks + the task head);
the edge runs the ``q`` middle blocks on server-class capacity.  The
per-block and head parameter counts come from the model's
:class:`~repro_torch.models.split_api.SplitModel` adapter
(``block_param_count`` / ``head_param_count``), so any registered
architecture is priced from its real Spec shapes.  Divided by
``Topology.capacity[n]`` (FLOP/s) this yields compute seconds.

Communication time prices, per local round:

- the sketched boundary activations with the Eq. 22–24 model
  (:mod:`repro_torch.core.comm_model`) fed by a ``CommConfig`` derived from the
  *actual* model config and ``SketchPlan`` (``comm_config_from``);
- the per-edge-round LoRA upload (uplink);
- the cloud→client model broadcast (downlink) at round start — the
  fused LoRA the client must fetch before training; downlink bandwidth
  is ``downlink_ratio ×`` the client's uplink (access links are
  asymmetric; ratio 1.0 recovers a symmetric link);
- the propagation latency of the client-edge link.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core.comm_model import CommConfig, client_comm_time
from repro_torch.core.split_training import Split
from repro_torch.models.split_api import split_model_for

EDGE_FLOPS_DEFAULT = 5e12    # server-class edge accelerator (FLOP/s)
DOWNLINK_RATIO_DEFAULT = 4.0  # downlink/uplink bandwidth asymmetry


@dataclasses.dataclass(frozen=True)
class RoundCost:
    """Cost breakdown of one local round (seconds + wire bytes)."""
    compute_s: float
    comm_s: float          # uplink: boundary activations + LoRA upload
    latency_s: float
    downlink_s: float = 0.0  # cloud->client model broadcast
    # wire volume behind the comm terms (telemetry's bytes breakdown;
    # informational — the seconds above stay the costs of record)
    uplink_bytes: float = 0.0
    downlink_bytes: float = 0.0

    @property
    def total_s(self) -> float:
        return self.compute_s + self.comm_s + self.latency_s \
            + self.downlink_s


class ClientCostModel:
    """Maps (client, Split, steps) -> simulated seconds.

    Deterministic: costs depend only on the topology, the model shapes,
    and optional per-(client, round) lognormal jitter drawn from a seeded
    generator — identical across runs with the same config.
    """

    def __init__(self, cfg, topo, comm: CommConfig, *, batch_size: int,
                 num_classes: int = 2,
                 edge_flops: float = EDGE_FLOPS_DEFAULT,
                 downlink_ratio: float = DOWNLINK_RATIO_DEFAULT,
                 jitter_sigma: float = 0.0, seed: int = 0):
        self.cfg = cfg
        self.topo = topo
        self.comm = comm
        self.batch_size = int(batch_size)
        self.edge_flops = float(edge_flops)
        self.downlink_ratio = float(downlink_ratio)
        self.jitter_sigma = float(jitter_sigma)
        self._seed = seed

        model = split_model_for(cfg)
        self.block_params = model.block_param_count(num_classes)
        self.head_params = model.head_param_count(num_classes)

    # -- FLOPs (6ND convention) -------------------------------------------
    def client_flops_per_step(self, split: Split) -> float:
        n = (split.p + split.o) * self.block_params + self.head_params
        tokens = self.batch_size * self.comm.seq_len
        return 6.0 * n * tokens

    def edge_flops_per_step(self, split: Split) -> float:
        return 6.0 * split.q * self.block_params \
            * self.batch_size * self.comm.seq_len

    # -- per-round cost ----------------------------------------------------
    def round_cost(self, client: int, split: Split, steps: int,
                   edge: Optional[int] = None,
                   round_idx: int = 0) -> RoundCost:
        """One local round of ``steps`` gradient steps for ``client``.

        ``edge=None`` (or an out-of-range escalation key like ``-1``)
        prices the nearest edge's link latency.
        """
        cap = float(self.topo.capacity[client])
        compute = steps * (self.client_flops_per_step(split) / cap
                           + self.edge_flops_per_step(split)
                           / self.edge_flops)
        if self.jitter_sigma > 0.0:
            rng = np.random.default_rng(
                (self._seed, client, round_idx))
            compute *= float(rng.lognormal(0.0, self.jitter_sigma))

        # boundary activations for the whole round (Eq. 23 with t=1 and
        # the real examples-per-round count) + the LoRA upload to the edge
        per_round = dataclasses.replace(self.comm, t_rounds=1)
        bw = float(self.topo.bandwidth[client])
        activ_s = client_comm_time(per_round, self.batch_size * steps, bw)
        comm = activ_s + self.comm.lora_bytes / max(bw, 1e-9)
        up_bytes = activ_s * bw + self.comm.lora_bytes
        # cloud->client model broadcast before training starts
        downlink = self.comm.lora_bytes / max(bw * self.downlink_ratio,
                                              1e-9)

        k = edge if edge is not None and 0 <= edge < \
            self.topo.latency.shape[1] else int(
                np.argmin(self.topo.latency[client]))
        lat = 2.0 * float(self.topo.latency[client, k]) / 1e3
        return RoundCost(compute, comm, lat, downlink,
                         uplink_bytes=up_bytes,
                         downlink_bytes=float(self.comm.lora_bytes))

    def estimate_population(self, splits: Dict[int, Split], steps: int,
                            edge_of: Optional[Dict[int, int]] = None
                            ) -> Dict[int, float]:
        """Total seconds per client for one local round (no churn) —
        used by schedulers to auto-derive deadlines / cloud periods."""
        return {n: self.round_cost(
                    n, s, steps,
                    edge_of.get(n) if edge_of else None).total_s
                for n, s in splits.items()}
