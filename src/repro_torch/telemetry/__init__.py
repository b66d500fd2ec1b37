"""Serving telemetry: counters and histograms, one ``None`` check each
while disabled.

The subset of the JAX package's ``repro/telemetry`` that
:mod:`repro_torch.serving` uses (``serving.requests``, ``serving.tokens``,
``serving.adapter_swaps``, ``serving.request_s``)::

    from repro_torch import telemetry as tm

    tm.enable()
    engine.run_until_drained()
    print(tm.summary())
    tm.disable()
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from repro_torch.telemetry.collector import (DEFAULT_TIME_BUCKETS, Histogram,
                                             Telemetry, flat_key)

__all__ = ["DEFAULT_TIME_BUCKETS", "Histogram", "Telemetry", "flat_key",
           "enabled", "enable", "disable", "get", "inc", "observe",
           "summary"]

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


def summary() -> Optional[Dict[str, Any]]:
    t = _active
    return t.summary() if t is not None else None
