"""Process-wide metrics registry + round-lifecycle span tracer (the
counterpart of the JAX package's ``repro/telemetry/collector.py``, in its
record format).

One :class:`Telemetry` instance collects everything a run emits:

- **counters** — monotone totals (``inc``), e.g. runtime events bridged
  one-for-one from :class:`~repro_torch.runtime.trace.EventTrace`,
  screening verdicts, simulated comm bytes;
- **gauges** — last-value samples (``set_gauge``), e.g. trust-ledger
  snapshots, the population's registry bytes and channel-cache counts;
- **histograms** — fixed-bucket distributions (``observe``), e.g. the
  engine's per-dispatch wall time, serving request latency, checkpoint
  save/restore latency;
- **spans** — wall-clock timed sections of the round lifecycle
  (``dispatch -> local_steps -> uplink -> edge_agg -> cloud_agg ->
  eval``), recorded via the ``with telemetry.span(name, ...)`` context
  manager or, for phases that only exist on the simulated clock,
  ``record_span(name, dur_s=0, sim_s=...)``.

``end_round(g)`` closes one round: pending spans plus the counter
*deltas* since the previous round boundary become one per-round record,
exportable as JSONL (:mod:`repro_torch.telemetry.export`).  Metric
identity is ``name{label=value,...}`` with labels sorted, so keys are
stable across runs and mergeable across processes.

The module imports nothing of the port (instrumented layers import *it*,
never the reverse) and never touches device tensors: a span times the
host's wall clock between enter and exit, without synchronising the card
(as the JAX package's spans time XLA's asynchronous dispatch), so an
enabled run computes bit-identical histories to a disabled one and makes
no extra host sync.
"""
from __future__ import annotations

import bisect
import time
from typing import Any, Dict, List, Optional, Sequence

#: JSONL schema version written by the exporter.
SCHEMA_VERSION = 1

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


class _SpanCtx:
    """Context manager recording one wall-timed span on exit."""

    __slots__ = ("_tel", "name", "attrs", "_t0")

    def __init__(self, tel: "Telemetry", name: str, attrs: Dict[str, Any]):
        self._tel = tel
        self.name = name
        self.attrs = attrs

    def set(self, **attrs: Any) -> None:
        """Attach attributes discovered while the span is open."""
        self.attrs.update(attrs)

    def __enter__(self) -> "_SpanCtx":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._tel.record_span(self.name,
                              dur_s=time.perf_counter() - self._t0,
                              **self.attrs)
        return False


class NullSpan:
    """Shared no-op span handed out while telemetry is disabled."""

    __slots__ = ()

    def __enter__(self) -> "NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs: Any) -> None:
        pass


NULL_SPAN = NullSpan()


class Telemetry:
    """One run's worth of counters/gauges/histograms/spans.

    ``sink`` (any :class:`repro_torch.telemetry.sinks.Sink`) receives the
    meta record now and every round record as it closes — streaming
    observability for long runs.  ``retain_rounds`` bounds the in-memory
    ``rounds`` window (oldest records are dropped); both default off.
    """

    def __init__(self, meta: Optional[Dict[str, Any]] = None,
                 sink=None, retain_rounds: Optional[int] = None):
        if retain_rounds is not None and retain_rounds < 0:
            raise ValueError(f"retain_rounds must be >= 0, got "
                             f"{retain_rounds}")
        self.meta = dict(meta or {})
        self.sink = sink
        self.retain_rounds = retain_rounds
        self.started = time.perf_counter()
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.rounds: List[Dict[str, Any]] = []
        self._spans: List[Dict[str, Any]] = []   # pending (open round)
        self._round_base: Dict[str, float] = {}  # counters at last boundary
        if sink is not None:
            sink.emit_meta({"type": "meta", "schema": SCHEMA_VERSION,
                            "meta": dict(self.meta)})

    # -- recording ---------------------------------------------------------
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

    def span(self, name: str, **attrs: Any) -> _SpanCtx:
        return _SpanCtx(self, name, attrs)

    def record_span(self, name: str, dur_s: float = 0.0,
                    **attrs: Any) -> None:
        """Record a pre-measured span (simulated-clock phases pass their
        duration via ``sim_s=`` attrs and keep ``dur_s`` at ~0)."""
        rec: Dict[str, Any] = {"name": name, "dur_s": float(dur_s)}
        if attrs:
            rec["attrs"] = attrs
        self._spans.append(rec)

    # -- reads -------------------------------------------------------------
    def counter(self, name: str, **labels: Any) -> float:
        return self.counters.get(flat_key(name, labels), 0.0)

    def gauge(self, name: str, **labels: Any) -> Optional[float]:
        return self.gauges.get(flat_key(name, labels))

    def counters_by_name(self, name: str) -> Dict[str, float]:
        """All ``name{...}`` series: flat key -> cumulative value."""
        prefix = name + "{"
        return {k: v for k, v in self.counters.items()
                if k == name or k.startswith(prefix)}

    # -- round lifecycle ---------------------------------------------------
    def end_round(self, round_idx: Optional[int],
                  sim_time_s: Optional[float] = None) -> Dict[str, Any]:
        """Close one round: counter deltas since the previous boundary +
        the spans recorded inside it become one JSONL-able record.
        ``round_idx=None`` marks an unnumbered trailing record (the
        ``flush_pending`` fold)."""
        delta = {k: v - self._round_base.get(k, 0.0)
                 for k, v in self.counters.items()
                 if v != self._round_base.get(k, 0.0)}
        self._round_base = dict(self.counters)
        rec: Dict[str, Any] = {"type": "round",
                               "round": (None if round_idx is None
                                         else int(round_idx)),
                               "counters": delta,
                               "gauges": dict(self.gauges),
                               "spans": self._spans}
        if sim_time_s is not None:
            rec["sim_time_s"] = float(sim_time_s)
        if self.sink is not None:
            self.sink.emit_round(rec)
        self.rounds.append(rec)
        if self.retain_rounds is not None \
                and len(self.rounds) > self.retain_rounds:
            del self.rounds[:len(self.rounds) - self.retain_rounds]
        self._spans = []
        return rec

    def flush_pending(self) -> None:
        """Fold any spans/counter deltas recorded since the last round
        boundary into a final unnumbered round record (callers that
        never call ``end_round`` — e.g. the serving engine — still
        export everything)."""
        if self._spans or any(
                v != self._round_base.get(k, 0.0)
                for k, v in self.counters.items()):
            self.end_round(None)
