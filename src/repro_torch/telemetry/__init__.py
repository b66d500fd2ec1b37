"""Telemetry: counters, gauges, histograms, spans and round markers, one
``None`` check each while disabled.

The subset of the JAX package's ``repro/telemetry`` that the port's paths
use: :mod:`repro_torch.serving` (``serving.requests``, ``serving.tokens``,
``serving.adapter_swaps``, ``serving.request_s``), the federation's
round loop (:func:`span` around its phases, :func:`end_round`) and the
event runtime (``runtime.events{kind=...}``, the ``runtime.sim.*``
seconds and wire bytes, ``runtime.stragglers``, and each round's
simulated end, ``end_round(..., sim_time_s=)``), update screening
(``screening.verdicts{verdict=...}``, ``screening.fallbacks{kind=...}``
and the trust ledger's gauges ``screening.trust_mean``,
``screening.trust_min`` and ``screening.below_floor``) and the federation
checkpoints (``checkpoint.save_s``/``restore_s``, ``checkpoint.saves``/
``restores``, ``checkpoint.bytes_written``/``bytes_read``).  While
enabled, a span's wall time goes to the histogram ``span_s{span=...}``,
each round end counts in ``rounds`` and its simulated end is kept by round
in ``sim_time_s``; a gauge keeps the last value set.  The JAX package's
span records and exports wait for ROADMAP.md, queue 6::

    from repro_torch import telemetry as tm

    tm.enable()
    engine.run_until_drained()
    print(tm.summary())
    tm.disable()
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence

from repro_torch.telemetry.collector import (DEFAULT_TIME_BUCKETS, Histogram,
                                             Telemetry, flat_key)

__all__ = ["DEFAULT_TIME_BUCKETS", "Histogram", "Telemetry", "flat_key",
           "enabled", "enable", "disable", "get", "inc", "set_gauge",
           "observe", "span", "end_round", "summary"]

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


class _Span:
    """One span around a phase: while telemetry is enabled, its wall time
    goes to ``span_s{span=name}`` on exit.  Its attributes (round, edge,
    ...), given here or through :meth:`set` while it is open, are
    accepted for the JAX package's signature and not recorded."""

    __slots__ = ("_tel", "name", "_t0")

    def __init__(self, tel: Optional[Telemetry], name: str):
        self._tel = tel
        self.name = name

    def set(self, **attrs: Any) -> None:
        pass

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self._tel is not None:
            self._tel.observe("span_s", time.perf_counter() - self._t0,
                              span=self.name)
        return False


_NULL_SPAN = _Span(None, "")


def span(name: str, **attrs: Any) -> _Span:
    """A context manager around one phase; a no-op while disabled."""
    t = _active
    return _Span(t, name) if t is not None else _NULL_SPAN


def end_round(round_idx: int, sim_time_s: Optional[float] = None) -> None:
    """Close one round; the event runtime passes the simulated clock at
    the round's end."""
    t = _active
    if t is not None:
        t.end_round(round_idx, sim_time_s=sim_time_s)


def summary() -> Optional[Dict[str, Any]]:
    t = _active
    return t.summary() if t is not None else None
