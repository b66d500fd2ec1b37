"""Event-trace recorder: an append-only log of simulator events (the
counterpart of the JAX package's ``repro/runtime/trace.py``).

The trace is the runtime's audit surface: determinism tests assert two
runs with the same seed+config produce *identical* traces, and the port's
traces are held record for record against the JAX package's.  Records are
plain tuples so equality is exact.

``of_kind``/``count`` are backed by a per-kind index maintained on
``log`` (and rebuilt when ``records`` is assigned wholesale), so mining a
long trace is O(matches) instead of a full scan per query.  The index holds the *same* tuple objects as
``records`` — equality and ordering semantics are unchanged.

When telemetry is enabled (:mod:`repro_torch.telemetry`), every record
also increments a ``runtime.events{kind=...}`` counter — the metrics
surface is bridged from the trace itself, so the two can never disagree.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

from repro_torch import telemetry as _tm

Record = Tuple[float, str, int, int, Tuple]


class EventTrace:
    def __init__(self) -> None:
        self._records: List[Record] = []
        self._by_kind: Dict[str, List[Record]] = {}

    @property
    def records(self) -> List[Record]:
        return self._records

    @records.setter
    def records(self, recs: List[Record]) -> None:
        # wholesale replacement: rebuild the index
        self._records = recs
        by_kind: Dict[str, List[Record]] = {}
        for r in recs:
            by_kind.setdefault(r[1], []).append(r)
        self._by_kind = by_kind

    def log(self, time: float, kind: str, client: int = -1, edge: int = -1,
            **info: Any) -> None:
        # info flattened to a sorted tuple of (key, value) pairs so records
        # are hashable/comparable and insertion-order independent
        packed = tuple(sorted((k, _freeze(v)) for k, v in info.items()))
        rec = (float(time), kind, int(client), int(edge), packed)
        self._records.append(rec)
        self._by_kind.setdefault(kind, []).append(rec)
        if _tm.enabled():
            _tm.inc("runtime.events", 1, kind=kind)

    # -- queries -----------------------------------------------------------
    def of_kind(self, kind: str) -> List[Record]:
        return list(self._by_kind.get(kind, ()))

    def count(self, kind: str) -> int:
        return len(self._by_kind.get(kind, ()))

    def end_time(self) -> float:
        return self._records[-1][0] if self._records else 0.0

    def summary(self) -> Dict[str, int]:
        return {kind: len(rs) for kind, rs in self._by_kind.items() if rs}

    def __len__(self) -> int:
        return len(self._records)

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, EventTrace)
                and self._records == other._records)


def _freeze(v: Any):
    """Make a value hashable/comparable for trace records."""
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, float):
        return round(v, 9)       # exact same arithmetic -> exact same round
    return v
