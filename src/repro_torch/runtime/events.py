"""Discrete-event core: a deterministic time-ordered event queue.

The counterpart of the JAX package's ``repro/runtime/events.py``.

Events are ordered by ``(time, seq)`` — ``seq`` is a monotonically
increasing insertion counter, so simultaneous events pop in insertion
order and the simulation is fully deterministic for a given schedule of
pushes (no hash/id tie-breaks).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Iterator, Optional

# event kinds used by the schedulers
DISPATCH = "dispatch"          # client handed a model, starts local round
ARRIVAL = "arrival"            # client's update reaches its edge
EDGE_AGG = "edge_agg"          # edge aggregates its received updates
CLOUD_AGG = "cloud_agg"        # cloud fuses edge models
OFFLINE = "offline"            # client unavailable at dispatch time
REJOIN = "rejoin"              # client back online, eligible again
EVAL = "eval"                  # server-side evaluation snapshot
# fault-injection kinds (see repro_torch.federation.topology.FaultTrace)
CRASH = "crash"                # client died mid-round, work lost
DROP = "drop"                  # finished update never reached the edge
DUP = "dup"                    # uplink delivered twice
CORRUPT = "corrupt"            # update arrived mangled (NaN/flip/scale)


@dataclasses.dataclass(frozen=True)
class Event:
    time: float
    kind: str
    client: int = -1           # -1: not client-scoped
    edge: int = -1             # -1: cloud / not edge-scoped
    payload: Any = None        # scheduler-private (model refs, versions…)


class EventQueue:
    """Min-heap of :class:`Event` with deterministic FIFO tie-breaking."""

    def __init__(self) -> None:
        self._heap: list = []
        self._seq = 0

    def push(self, ev: Event) -> None:
        heapq.heappush(self._heap, (ev.time, self._seq, ev))
        self._seq += 1

    def pop(self) -> Event:
        return heapq.heappop(self._heap)[2]

    def peek(self) -> Optional[Event]:
        return self._heap[0][2] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def drain_until(self, t: float) -> Iterator[Event]:
        """Pop every event with ``time <= t`` in order."""
        while self._heap and self._heap[0][0] <= t:
            yield self.pop()
