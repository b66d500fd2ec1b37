"""Event-driven edge runtime: wall-clock simulation of hierarchical FL
(the counterpart of the JAX package's ``repro/runtime``).

The round-synchronous
:meth:`repro_torch.federation.simulation.Federation.run` loop has no
notion of time — every client finishes every round instantly.
This subsystem assigns each client a simulated wall-clock cost per local
round (compute from ``Topology.capacity`` + the client's ``Split`` FLOPs,
uplink/downlink from the Eq. 22–24 comm model fed by the *actual*
``SketchPlan``/LoRA shapes), models availability churn, and schedules edge
rounds under pluggable policies:

- ``sync``      — barrier per edge round; reproduces ``run()``'s
                  semantics (bit-identical history);
- ``deadline``  — the edge aggregates whoever reported by a per-round
                  deadline; stragglers carry their update into the next
                  aggregation;
- ``async``     — the edge folds arrivals in continuously with
                  staleness-discounted weights; the cloud fuses on a period.

Entry points: ``Federation.run(..., runtime=RuntimeConfig(...))`` or
:class:`EdgeRuntime` directly.  Histories gain a ``time`` axis (simulated
seconds) so accuracy-vs-wall-clock curves exist.  Every local round a
policy dispatches is one ``Federation._edge_round`` call, so on a CUDA
device it runs the hand-written kernels through the batched engine (or
the sequential loop, with ``backend="reference"``).
"""
from repro_torch.runtime.cost import ClientCostModel, RoundCost
from repro_torch.runtime.events import Event, EventQueue
from repro_torch.runtime.runtime import EdgeRuntime, RuntimeConfig
from repro_torch.runtime.trace import EventTrace

__all__ = ["ClientCostModel", "RoundCost", "EdgeRuntime", "Event",
           "EventQueue", "EventTrace", "RuntimeConfig"]
