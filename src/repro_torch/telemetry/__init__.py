"""Telemetry: counters, histograms, spans and round markers, one ``None``
check each while disabled.

The subset of the JAX package's ``repro/telemetry`` that the port's paths
use: :mod:`repro_torch.serving` (``serving.requests``, ``serving.tokens``,
``serving.adapter_swaps``, ``serving.request_s``) and the federation's
round loop (:func:`span` around its phases, :func:`end_round`).  While
enabled, a span's wall time goes to the histogram ``span_s{span=...}`` and
each round end counts in ``rounds``; the JAX package's span records,
gauges and exports wait for ROADMAP.md, queue 6::

    from repro_torch import telemetry as tm

    tm.enable()
    engine.run_until_drained()
    print(tm.summary())
    tm.disable()
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Optional, Sequence

from repro_torch.telemetry.collector import (DEFAULT_TIME_BUCKETS, Histogram,
                                             Telemetry, flat_key)

__all__ = ["DEFAULT_TIME_BUCKETS", "Histogram", "Telemetry", "flat_key",
           "enabled", "enable", "disable", "get", "inc", "observe",
           "span", "end_round", "summary"]

_active: Optional[Telemetry] = None


def enabled() -> bool:
    return _active is not None


def get() -> Optional[Telemetry]:
    """The live collector, or None while disabled."""
    return _active


def enable(meta: Optional[Dict[str, Any]] = None) -> Telemetry:
    """Start a fresh collector (replacing any previous one)."""
    global _active
    _active = Telemetry(meta)
    return _active


def disable() -> None:
    global _active
    _active = None


def inc(name: str, value: float = 1.0, **labels: Any) -> None:
    t = _active
    if t is not None:
        t.inc(name, value, **labels)


def observe(name: str, value: float,
            buckets: Optional[Sequence[float]] = None,
            **labels: Any) -> None:
    t = _active
    if t is not None:
        t.observe(name, value, buckets=buckets, **labels)


@contextlib.contextmanager
def _timed_span(t: Telemetry, name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t.observe("span_s", time.perf_counter() - t0, span=name)


def span(name: str, **attrs: Any):
    """A context manager around one phase; a no-op while disabled.  The
    attributes (round, edge, ...) are accepted for the JAX package's
    signature and not recorded."""
    t = _active
    return _timed_span(t, name) if t is not None else contextlib.nullcontext()


def end_round(round_idx: int) -> None:
    t = _active
    if t is not None:
        t.inc("rounds")


def summary() -> Optional[Dict[str, Any]]:
    t = _active
    return t.summary() if t is not None else None
