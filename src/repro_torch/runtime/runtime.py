"""EdgeRuntime: the entry point tying a Federation to a scheduler policy
(the counterpart of the JAX package's ``repro/runtime/runtime.py``).

Builds the wall-clock cost model from the federation's *real* artifacts
(its ``ArchConfig``, ``Topology``, ``SketchPlan`` and LoRA tree — via
:func:`repro_torch.core.comm_model.comm_config_from`), owns the
availability trace and the event-trace recorder, and hands control to the
policy's scheduler.  Usage::

    from repro_torch.runtime import RuntimeConfig
    fed = Federation(FedConfig(constrained_frac=0.3))
    hist = fed.run("elsa", runtime=RuntimeConfig(policy="deadline"))
    hist["time"]       # simulated seconds per recorded round
    hist["trace"]      # EventTrace of dispatch/arrival/agg events

Each policy's ready-set dispatches route through ``Federation.group_steps``
into the federation's backend: on a CUDA device the batched engine runs
every client step through the hand-written kernels.  ``checkpoint=`` and
``resume_from=`` work on the sync policy and raise ``ValueError`` under
the deadline and async policies, whose event queues carry in-flight state
across rounds.  ``population=`` binds a registry-backed population
(:mod:`repro_torch.population`) under every policy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.comm_model import comm_config_from
from repro_torch.federation.topology import ChurnTrace, FaultTrace, always_on
from repro_torch.runtime.cost import (DOWNLINK_RATIO_DEFAULT,
                                      EDGE_FLOPS_DEFAULT, ClientCostModel)
from repro_torch.runtime.trace import EventTrace

POLICIES = ("sync", "deadline", "async")


@dataclasses.dataclass
class RuntimeConfig:
    """Scheduler policy + knobs of the wall-clock simulation."""
    policy: str = "sync"
    # deadline policy: edge aggregates whoever reported within this many
    # seconds of the edge round start; None derives it from the given
    # quantile of the population's estimated round times.
    deadline_s: Optional[float] = None
    deadline_quantile: float = 0.6
    # weight multiplier per edge round of lateness for carried-over
    # straggler updates (1.0 = no discount)
    straggler_discount: float = 0.5
    # async policy: edge mixes an arrival in with weight
    # alpha / (1 + staleness)^decay, staleness in edge-model versions
    async_alpha: float = 0.6
    staleness_decay: float = 0.5
    # async cloud fusion period; None -> t_rounds x median estimated
    # client round time (the sync cadence without stragglers)
    cloud_period_s: Optional[float] = None
    # availability model; None -> every client always on
    churn: Optional[ChurnTrace] = None
    # fault-injection schedule (crash/drop/dup/corrupt per dispatch);
    # None -> no faults (see repro_torch.federation.topology.FaultTrace)
    faults: Optional[FaultTrace] = None
    # cost-model knobs
    edge_flops: float = EDGE_FLOPS_DEFAULT
    backhaul_bytes_per_s: float = 1.25e9    # edge<->cloud (10 Gbps)
    downlink_ratio: float = DOWNLINK_RATIO_DEFAULT  # downlink/uplink bw
    jitter_sigma: float = 0.0               # lognormal compute jitter
    max_sim_s: float = float("inf")         # hard stop for the event loop

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown runtime policy {self.policy!r}; "
                             f"expected one of {POLICIES}")


class EdgeRuntime:
    """Event-driven executor for one :class:`Federation`."""

    def __init__(self, federation, config: Optional[RuntimeConfig] = None):
        self.federation = federation
        self.config = config or RuntimeConfig()
        fc = federation.fed
        self.comm = comm_config_from(federation.cfg, fc,
                                     plan=(federation.plan
                                           if fc.use_channel else None),
                                     lora=federation.lora0)
        self.cost = ClientCostModel(
            federation.cfg, federation.topo, self.comm,
            batch_size=fc.batch_size, num_classes=fc.num_classes,
            edge_flops=self.config.edge_flops,
            downlink_ratio=self.config.downlink_ratio,
            jitter_sigma=self.config.jitter_sigma, seed=fc.seed)
        self.churn = self.config.churn or always_on(fc.n_clients)
        self.backhaul_s = self.comm.lora_bytes \
            / max(self.config.backhaul_bytes_per_s, 1e-9)
        self.trace = EventTrace()

    def run(self, method: str = "elsa", *, global_rounds: int = 10,
            steps_per_round: int = 4, eval_every: int = 1,
            log: bool = False, checkpoint=None,
            resume_from: Optional[str] = None, population=None) -> Dict:
        from repro_torch.runtime.schedulers import SCHEDULERS
        if (checkpoint is not None or resume_from is not None) \
                and self.config.policy != "sync":
            # deadline/async carry in-flight event-queue state across
            # rounds; only the barrier-synchronous policy snapshots at a
            # round boundary where the full state is in the checkpoint
            raise ValueError("checkpoint/resume is supported on the "
                             "'sync' runtime policy only, not "
                             f"{self.config.policy!r}")
        # registry-backed population: every policy samples a per-round
        # (sync/deadline) or per-fusion-window (async) cohort of
        # registered ids into the client slots
        self.federation._bind_population(population)
        scheduler = SCHEDULERS[self.config.policy](self)
        history = scheduler.run(method, global_rounds, steps_per_round,
                                eval_every, log, checkpoint=checkpoint,
                                resume_from=resume_from)
        history["policy"] = self.config.policy
        history["trace"] = self.trace
        return history
