"""Process-wide metrics registry: counters, gauges, fixed-bucket
histograms and each round's simulated end.

The part of the JAX package's ``repro/telemetry/collector.py`` that the
port's paths use, copied so that the port imports nothing of ``repro``.
Metric identity is ``name{label=value,...}`` with labels sorted.
Recording is host-side bookkeeping only and never touches device tensors.
"""
from __future__ import annotations

import bisect
from typing import Any, Dict, Optional, Sequence

#: Default histogram bucket upper bounds (seconds, log-spaced).  Values
#: above the last bound land in the +inf overflow bucket.
DEFAULT_TIME_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2,
                        0.1, 0.3, 1.0, 3.0, 10.0, 30.0)


def flat_key(name: str, labels: Dict[str, Any]) -> str:
    """``name{k=v,...}`` with sorted labels; bare ``name`` unlabeled."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Histogram:
    """Fixed-bucket histogram: counts per bucket + sum/count/min/max."""

    __slots__ = ("buckets", "counts", "sum", "count", "min", "max")

    def __init__(self, buckets: Sequence[float] = DEFAULT_TIME_BUCKETS):
        bs = tuple(float(b) for b in buckets)
        if list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError(f"histogram buckets must be strictly "
                             f"increasing, got {bs}")
        self.buckets = bs
        self.counts = [0] * (len(bs) + 1)   # +1: overflow bucket
        self.sum = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1
        self.min = v if v < self.min else self.min
        self.max = v if v > self.max else self.max

    def state(self) -> Dict[str, Any]:
        return {"buckets": list(self.buckets), "counts": list(self.counts),
                "sum": self.sum, "count": self.count,
                "min": (None if self.count == 0 else self.min),
                "max": (None if self.count == 0 else self.max)}


class Telemetry:
    """One run's worth of counters, gauges and histograms."""

    def __init__(self, meta: Optional[Dict[str, Any]] = None):
        self.meta = dict(meta or {})
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}      # last value set
        self.histograms: Dict[str, Histogram] = {}
        self.sim_time_s: Dict[int, float] = {}   # round -> simulated end

    def inc(self, name: str, value: float = 1.0, **labels: Any) -> None:
        k = flat_key(name, labels)
        self.counters[k] = self.counters.get(k, 0.0) + float(value)

    def set_gauge(self, name: str, value: float, **labels: Any) -> None:
        self.gauges[flat_key(name, labels)] = float(value)

    def observe(self, name: str, value: float,
                buckets: Optional[Sequence[float]] = None,
                **labels: Any) -> None:
        k = flat_key(name, labels)
        h = self.histograms.get(k)
        if h is None:
            h = self.histograms[k] = Histogram(buckets
                                               or DEFAULT_TIME_BUCKETS)
        h.observe(value)

    def end_round(self, round_idx: int,
                  sim_time_s: Optional[float] = None) -> None:
        """Count one closed round; keep its simulated end, when the event
        runtime gives one."""
        self.inc("rounds")
        if sim_time_s is not None:
            self.sim_time_s[int(round_idx)] = float(sim_time_s)

    def counter(self, name: str, **labels: Any) -> float:
        return self.counters.get(flat_key(name, labels), 0.0)

    def gauge(self, name: str, **labels: Any) -> Optional[float]:
        return self.gauges.get(flat_key(name, labels))

    def summary(self) -> Dict[str, Any]:
        """Cumulative counters, the gauges' last values, histogram states
        and simulated round ends."""
        return {"meta": dict(self.meta),
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {k: h.state()
                               for k, h in self.histograms.items()},
                "sim_time_s": dict(self.sim_time_s)}
