"""Per-client runtime state machine (the counterpart of the JAX package's
``repro/runtime/client.py``).

States::

    IDLE ──dispatch──▶ TRAINING ──complete──▶ REPORTED ──collect──▶ IDLE
                          │                                    (result folded
                          └── churn pauses stretch busy_until ──┘  into an agg)

The deadline and async schedulers consult this to know who is eligible
for dispatch (``IDLE`` and online), who is a straggler (``TRAINING`` past
a deadline), and which edge-model version an arriving update was trained
from (its staleness).  Transitions assert legality so scheduler bugs
surface as errors, not silent double-dispatches.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

IDLE = "idle"
TRAINING = "training"
REPORTED = "reported"


@dataclasses.dataclass
class ClientRuntimeState:
    client: int
    state: str = IDLE
    dispatch_time: float = 0.0
    busy_until: float = 0.0       # churn-adjusted completion time
    base_version: int = 0         # edge-model version trained from
    base_round: int = 0           # edge round index at dispatch
    result: Optional[Any] = None  # (lora, loss) parked on completion
    rounds_run: int = 0
    dispatches: int = 0           # fault-schedule index: counts every
                                  # dispatch, crashed ones included (a
                                  # crash never completes, so indexing
                                  # faults by rounds_run would replay
                                  # the same crash forever)

    def dispatch(self, t: float, finish: float, version: int,
                 round_idx: int) -> None:
        assert self.state == IDLE, \
            f"client {self.client}: dispatch while {self.state}"
        assert finish >= t
        self.state = TRAINING
        self.dispatch_time = t
        self.busy_until = finish
        self.base_version = version
        self.base_round = round_idx
        self.result = None
        self.dispatches += 1

    def crash(self) -> None:
        """Fault injection: the in-flight round is lost (not paused —
        that's churn); the client idles and can be re-dispatched."""
        assert self.state == TRAINING, \
            f"client {self.client}: crash while {self.state}"
        self.state = IDLE
        self.result = None

    def complete(self, result: Any) -> None:
        assert self.state == TRAINING, \
            f"client {self.client}: complete while {self.state}"
        self.state = REPORTED
        self.result = result
        self.rounds_run += 1

    def collect(self) -> Any:
        """Fold the parked update into an aggregation; client idles."""
        assert self.state == REPORTED, \
            f"client {self.client}: collect while {self.state}"
        out, self.result = self.result, None
        self.state = IDLE
        return out

    @property
    def idle(self) -> bool:
        return self.state == IDLE

    def staleness(self, version: int) -> int:
        """Edge-model versions elapsed since this client was dispatched."""
        return max(0, version - self.base_version)
