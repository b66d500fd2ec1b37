"""Federation telemetry: structured metrics + round-phase tracing (the
counterpart of the JAX package's ``repro/telemetry``, in its record and
file formats).

Every module-level helper checks one ``None`` and returns while disabled,
and the instrumented layers never synchronise the card, draw random
numbers or branch on telemetry state in a way that changes the math: an
enabled run computes bit-identical histories and event traces to a
disabled one, with the same host syncs.  Usage::

    from repro_torch import telemetry as tm

    tm.enable(meta={"bench": "fed_round"})
    fed.run("elsa", global_rounds=4)             # layers self-instrument
    tm.export("runs/telemetry.jsonl")            # per-round JSONL+summary
    tm.disable()

or scoped::

    with tm.session(jsonl="runs/telemetry.jsonl"):
        fed.run(...)

Instrumented layers (all no-ops while disabled):

- :mod:`repro_torch.runtime` — every :meth:`EventTrace.log` record
  bridges to a ``runtime.events{kind=...}`` counter, schedulers record
  round-lifecycle spans (``dispatch``/``local_steps``/``uplink``/
  ``edge_agg``/``cloud_agg``/``eval``), per-phase simulated seconds and
  comm bytes, ``runtime.stragglers``, and each round's simulated end;
- :mod:`repro_torch.federation` — the round loop's spans and round ends;
  the engine's ``engine.dispatch_s`` and ``engine.clients``;
- :mod:`repro_torch.core.screening` — verdict and fallback counters, and
  the trust ledger's gauges;
- :mod:`repro_torch.population` — the ``population.*`` gauges (registry
  size and bytes, eligible and sampled ids, adapter shards, the identity
  channel cache);
- :mod:`repro_torch.checkpoint` — save/restore latency and bytes;
- :mod:`repro_torch.serving` — request latency, tokens, adapter swaps.

The engine's compile gauges of the JAX package (``engine.jit_compiles``
and the compile cache) wait for the graph capture that takes the
compiles' place (ROADMAP.md, queue 2 item 11).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Sequence

from repro_torch.telemetry.collector import (DEFAULT_TIME_BUCKETS, NULL_SPAN,
                                             SCHEMA_VERSION, Histogram,
                                             NullSpan, Telemetry, flat_key)
from repro_torch.telemetry.export import export_jsonl, read_jsonl, summarize
from repro_torch.telemetry.sinks import JsonlSink, Sink, finalize_sink

__all__ = [
    "DEFAULT_TIME_BUCKETS", "SCHEMA_VERSION", "Histogram", "NullSpan",
    "Telemetry", "flat_key", "export_jsonl", "read_jsonl", "summarize",
    "Sink", "JsonlSink", "finalize_sink",
    "enabled", "enable", "disable", "get", "inc", "set_gauge", "observe",
    "span", "record_span", "end_round", "export", "summary", "session",
]

_active: Optional[Telemetry] = None


def enabled() -> bool:
    return _active is not None


def get() -> Optional[Telemetry]:
    """The live collector, or None while disabled."""
    return _active


def enable(meta: Optional[Dict[str, Any]] = None, sink: Optional[Sink] = None,
           retain_rounds: Optional[int] = None) -> Telemetry:
    """Start a fresh collector (replacing any previous one).  ``sink``
    streams every round record as it closes; ``retain_rounds`` bounds the
    in-memory round window."""
    global _active
    _active = Telemetry(meta, sink=sink, retain_rounds=retain_rounds)
    return _active


def disable() -> None:
    """Stop collecting; a streaming sink is flushed (trailing partial
    round + run summary) and closed on the way out."""
    global _active
    if _active is not None:
        finalize_sink(_active)
    _active = None


# -- forwarding helpers (each is one None-check when disabled) -------------

def inc(name: str, value: float = 1.0, **labels: Any) -> None:
    t = _active
    if t is not None:
        t.inc(name, value, **labels)


def set_gauge(name: str, value: float, **labels: Any) -> None:
    t = _active
    if t is not None:
        t.set_gauge(name, value, **labels)


def observe(name: str, value: float,
            buckets: Optional[Sequence[float]] = None,
            **labels: Any) -> None:
    t = _active
    if t is not None:
        t.observe(name, value, buckets=buckets, **labels)


def span(name: str, **attrs: Any):
    t = _active
    return t.span(name, **attrs) if t is not None else NULL_SPAN


def record_span(name: str, dur_s: float = 0.0, **attrs: Any) -> None:
    t = _active
    if t is not None:
        t.record_span(name, dur_s=dur_s, **attrs)


def end_round(round_idx: int, sim_time_s: Optional[float] = None) -> None:
    t = _active
    if t is not None:
        t.end_round(round_idx, sim_time_s=sim_time_s)


def export(path: str) -> Optional[str]:
    """Write the live collector's JSONL; None while disabled."""
    t = _active
    return export_jsonl(t, path) if t is not None else None


def summary() -> Optional[Dict[str, Any]]:
    t = _active
    return summarize(t) if t is not None else None


@contextlib.contextmanager
def session(meta: Optional[Dict[str, Any]] = None,
            jsonl: Optional[str] = None, sink: Optional[Sink] = None,
            retain_rounds: Optional[int] = None):
    """Enable for a block; export to ``jsonl`` (if given) on the way
    out, then restore the previous collector (sessions nest).  A
    ``sink`` streams rounds live instead and is flushed + closed on
    exit (``retain_rounds`` bounds the in-memory window meanwhile)."""
    global _active
    prev = _active
    tel = Telemetry(meta, sink=sink, retain_rounds=retain_rounds)
    _active = tel
    try:
        yield tel
    finally:
        if jsonl is not None:
            export_jsonl(tel, jsonl)
        finalize_sink(tel)
        _active = prev
