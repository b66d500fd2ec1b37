"""Human-readable report over a telemetry JSONL file (the counterpart of
the JAX package's ``repro/analysis/telemetry_report.py``: the same text
for the same file, whichever package wrote it).

Renders the merged run summary written by :func:`repro_torch.telemetry.
export_jsonl` — per-phase wall/simulated time, the simulated comm
breakdown (seconds + wire bytes), runtime event counts, engine compile
accounting, screening verdicts, and histogram digests — as one plain
table, either from a finished file's summary line or rebuilt from the
round records of a killed run.

Usage: PYTHONPATH=src python -m repro_torch.analysis.telemetry_report \\
           runs/telemetry.jsonl [--rounds]
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List

from repro_torch.telemetry import read_jsonl

# round-lifecycle phases, in execution order (other span names render
# after these, alphabetically)
PHASES = ("profile", "dispatch", "local_steps", "uplink", "edge_agg",
          "cloud_agg", "eval")

# simulated per-dispatch cost counters -> display label
SIM_COUNTERS = (("runtime.sim.compute_s", "compute"),
                ("runtime.sim.uplink_s", "uplink"),
                ("runtime.sim.downlink_s", "downlink"),
                ("runtime.sim.latency_s", "latency"))


def _fmt_s(v: float) -> str:
    return f"{v:10.3f}s"


def _fmt_bytes(v: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(v) < 1024.0 or unit == "GiB":
            return f"{v:8.1f}{unit}"
        v /= 1024.0
    return f"{v:8.1f}GiB"


def _series(counters: Dict[str, float], name: str) -> Dict[str, float]:
    """All ``name`` / ``name{...}`` series in a flat counter dict."""
    prefix = name + "{"
    return {k: v for k, v in counters.items()
            if k == name or k.startswith(prefix)}


def render(data: Dict[str, Any], show_rounds: bool = False) -> str:
    """Format one parsed telemetry file (:func:`read_jsonl` output)."""
    s = data["summary"]
    counters: Dict[str, float] = s.get("counters", {})
    lines: List[str] = []
    meta = s.get("meta") or {}
    head = ", ".join(f"{k}={v}" for k, v in sorted(meta.items()))
    lines.append(f"telemetry summary ({s.get('rounds', 0)} rounds"
                 + (f"; {head}" if head else "") + ")")

    spans: Dict[str, Dict[str, float]] = s.get("spans", {})
    if spans:
        lines.append("")
        lines.append("phase            count       wall         sim")
        ordered = [p for p in PHASES if p in spans] \
            + sorted(k for k in spans if k not in PHASES)
        for name in ordered:
            agg = spans[name]
            lines.append(f"{name:<14} {int(agg['count']):7d} "
                         f"{_fmt_s(agg['wall_s'])} "
                         f"{_fmt_s(agg['sim_s'])}")

    sim_rows = [(lbl, counters.get(key, 0.0)) for key, lbl in SIM_COUNTERS
                if key in counters]
    if sim_rows:
        total = sum(v for _, v in sim_rows)
        lines.append("")
        lines.append("simulated cost      seconds    share")
        for lbl, v in sim_rows:
            lines.append(f"{lbl:<14} {_fmt_s(v)}   "
                         f"{v / max(total, 1e-12) * 100:5.1f}%")
        up = counters.get("runtime.uplink_bytes", 0.0)
        down = counters.get("runtime.downlink_bytes", 0.0)
        if up or down:
            lines.append(f"wire: uplink {_fmt_bytes(up).strip()}, "
                         f"downlink {_fmt_bytes(down).strip()}")

    events = _series(counters, "runtime.events")
    if events:
        lines.append("")
        lines.append("runtime events")
        for k in sorted(events):
            kind = k[k.find("kind=") + 5:-1] if "{" in k else k
            lines.append(f"  {kind:<12} {int(events[k]):7d}")

    compiles = _series(counters, "engine.jit_compiles")
    if compiles:
        lines.append("")
        lines.append(f"engine: {int(sum(compiles.values()))} jit compiles, "
                     f"{int(counters.get('engine.clients', 0))} client "
                     f"dispatches, "
                     f"{int(counters.get('engine.phantom_rows', 0))} "
                     f"phantom rows")
        for k in sorted(compiles):
            lines.append(f"  {k:<48} {int(compiles[k]):4d}")

    verdicts = _series(counters, "screening.verdicts")
    if verdicts:
        lines.append("")
        lines.append("screening verdicts")
        for k in sorted(verdicts):
            v = k[k.find("verdict=") + 8:-1] if "{" in k else k
            lines.append(f"  {v:<12} {int(verdicts[k]):7d}")

    hists = s.get("histograms", {})
    if hists:
        lines.append("")
        lines.append("histograms          count        mean         max")
        for k in sorted(hists):
            h = hists[k]
            n = h.get("count", 0)
            mean = h.get("sum", 0.0) / max(n, 1)
            mx = h.get("max")
            lines.append(f"{k:<44} {n:6d} {mean:11.4f} "
                         f"{mx if mx is not None else float('nan'):11.4f}")

    if show_rounds:
        lines.append("")
        lines.append("round     sim_time    spans  counter-deltas")
        for rec in data["rounds"]:
            g = rec.get("round")
            t = rec.get("sim_time_s")
            lines.append(f"{str(g):>5} "
                         f"{t if t is not None else float('nan'):11.2f} "
                         f"{len(rec.get('spans', ())):7d} "
                         f"{len(rec.get('counters', {})):7d}")
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser(
        description="Render a telemetry JSONL file as a phase/cost report")
    ap.add_argument("path", help="telemetry .jsonl written by "
                                 "repro_torch.telemetry.export")
    ap.add_argument("--rounds", action="store_true",
                    help="append the per-round record table")
    args = ap.parse_args()
    print(render(read_jsonl(args.path), show_rounds=args.rounds))


if __name__ == "__main__":
    main()
