"""JSONL export + merged run summary for :class:`~repro_torch.telemetry.
collector.Telemetry` (the counterpart of the JAX package's
``repro/telemetry/export.py``; either package reads the other's files).

A telemetry file is line-delimited JSON:

- line 1: ``{"type": "meta", "schema": 1, "meta": {...}}``;
- one ``{"type": "round", "round": g, "counters": {delta}, "gauges":
  {...}, "spans": [...], "sim_time_s": t}`` per closed round (counters
  are per-round *deltas*; gauges are the values at the boundary);
- last line: ``{"type": "summary", ...}`` — the cumulative counters,
  final gauges, full histogram states, and per-span-name wall/sim
  aggregates of the whole run (:func:`summarize`).

A killed run still leaves every completed round parseable, and
``repro_torch.analysis.telemetry_report`` streams arbitrarily long runs.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict

from repro_torch.telemetry.collector import SCHEMA_VERSION, Telemetry


def _add_spans(spans: Dict[str, Dict[str, float]], records) -> None:
    """Fold each record's span list into per-name count/wall/sim totals."""
    for rec in records:
        for s in rec.get("spans", ()):
            agg = spans.setdefault(s["name"],
                                   {"count": 0, "wall_s": 0.0, "sim_s": 0.0})
            agg["count"] += 1
            agg["wall_s"] += s.get("dur_s", 0.0)
            agg["sim_s"] += float(s.get("attrs", {}).get("sim_s", 0.0))


def summarize(tel: Telemetry) -> Dict[str, Any]:
    """Merged run summary: cumulative metrics + per-span aggregates."""
    spans: Dict[str, Dict[str, float]] = {}
    _add_spans(spans, tel.rounds + [{"spans": tel._spans}])
    return {
        "type": "summary", "schema": SCHEMA_VERSION,
        "meta": dict(tel.meta),
        "rounds": len(tel.rounds),
        "counters": dict(tel.counters),
        "gauges": dict(tel.gauges),
        "histograms": {k: h.state() for k, h in tel.histograms.items()},
        "spans": spans,
    }


def export_jsonl(tel: Telemetry, path: str) -> str:
    """Write meta + per-round records + summary; returns ``path``."""
    tel.flush_pending()
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        f.write(json.dumps({"type": "meta", "schema": SCHEMA_VERSION,
                            "meta": dict(tel.meta)}, sort_keys=True) + "\n")
        for rec in tel.rounds:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
        f.write(json.dumps(summarize(tel), sort_keys=True) + "\n")
    return path


def read_jsonl(path: str) -> Dict[str, Any]:
    """Parse a telemetry file into ``{"meta", "rounds", "summary"}``.

    Tolerates a missing summary line (killed run): the summary is then
    rebuilt from the round records' deltas.
    """
    meta: Dict[str, Any] = {}
    rounds = []
    summary = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            kind = rec.get("type")
            if kind == "meta":
                meta = rec
            elif kind == "round":
                rounds.append(rec)
            elif kind == "summary":
                summary = rec
    if summary is None:
        counters: Dict[str, float] = {}
        spans: Dict[str, Dict[str, float]] = {}
        gauges: Dict[str, Any] = {}
        for rec in rounds:
            for k, v in rec.get("counters", {}).items():
                counters[k] = counters.get(k, 0.0) + v
            gauges.update(rec.get("gauges", {}))
        _add_spans(spans, rounds)
        summary = {"type": "summary", "schema": meta.get("schema", 0),
                   "meta": meta.get("meta", {}), "rounds": len(rounds),
                   "counters": counters, "gauges": gauges,
                   "histograms": {}, "spans": spans}
    return {"meta": meta, "rounds": rounds, "summary": summary}
