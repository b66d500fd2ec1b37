"""Where a step's work and time go: the counterpart of the JAX package's
``repro/analysis/breakdown.py``.

- :func:`breakdown` and :func:`main`: the top contributors to a dry-run
  record's flops or bytes, from the per-op rows beside the record
  (``launch/dryrun.py``: each aten op and hand-written kernel by shape,
  with its calls in the step), printed as the JAX package prints its HLO
  instructions.
- :func:`device_breakdown`: one run on the card under ``torch.profiler``:
  the device time by kernel, the device's busy time, the window's wall
  and idle share, and the longest idle gaps of the device, each with the
  host ops that were open across it.

Usage: PYTHONPATH=src python -m repro_torch.analysis.breakdown <record> [--top 15] [--by bytes|flops]
"""
from __future__ import annotations

import argparse
import gzip
import json
import os

import torch

from repro_torch.analysis.roofline import RUNS_DIR


def breakdown(rows):
    """A record's op rows as ``(bytes, flops, wire bytes, name, shape,
    calls)``, the JAX package's row layout (its multiplicity is the loop
    trip count; here the calls in the step).  Wire bytes are 0 on one
    device."""
    return [(r["bytes"], r["flops"], 0.0, r["name"], r["shape"][:40],
             r["calls"]) for r in rows]


def load_rows(record: str):
    """The op rows of ``record``: a record's name under ``build/dryrun``,
    or the path of its ``.json`` or ``.ops.json.gz`` file."""
    path = record.removesuffix(".json").removesuffix(".ops.json.gz")
    if not os.path.exists(path + ".ops.json.gz"):
        path = os.path.join(RUNS_DIR, path)
    with gzip.open(path + ".ops.json.gz", "rt") as f:
        return json.load(f)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("record")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--by", choices=["bytes", "flops"], default="bytes")
    args = ap.parse_args(argv)
    rows = breakdown(load_rows(args.record))
    key = {"bytes": 0, "flops": 1}[args.by]
    rows.sort(key=lambda r: -r[key])
    total = sum(r[key] for r in rows)
    print(f"total {args.by}: {total:.3e}")
    shown = 0.0
    for r in rows[:args.top]:
        shown += r[key]
        print(f"{r[key]:.3e} ({r[key]/max(total,1e-9)*100:5.1f}%) x{r[5]:<6.0f}"
              f" {r[4]:40s} {r[3]}")
    print(f"(top {args.top} = {shown/max(total,1e-9)*100:.1f}%)")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_breakdown(fn, per: int = 1, *, trace=None, show: bool = True):
    """``fn()`` under ``torch.profiler`` (CPU and CUDA activities).

    Returns ``{"rows": [(device us, count, name)], "busy_ms", "wall_ms",
    "idle_share", "gaps", "kernels"}``: each device kernel's time and
    launches divided by ``per`` (the steps ``fn`` runs), largest first;
    the device time over them (per step); the profiled window's wall (per
    step) and the share of it in which the device ran nothing; and the 5
    longest idle gaps between device work, each ``{"ms", "at_ms" (from
    the window's start), "host_op", "outer_host_op"}``, the host ops the
    innermost and the outermost CPU event of the same trace open across
    the whole gap (``None`` where no host op was: the host was between
    ops).  With ``show``, prints the top 15 rows; with ``trace``, writes
    the Chrome trace there.  Raises if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    cuda = torch.autograd.DeviceType.CUDA
    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != cuda:
            continue                                  # CPU ops: no double count
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        rows.append((dev_us / per, ev.count / per, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    if busy_ms <= 0:
        raise RuntimeError("device_breakdown: the profiler saw no device "
                           "time")
    if show:
        for us, n, key in rows[:15]:
            print(f"  {us / 1e3:8.3f} ms {us / 1e3 / busy_ms:6.1%}  "
                  f"{n:5.0f}x  {key[:80]}")
    if trace:
        os.makedirs(os.path.dirname(os.path.abspath(trace)), exist_ok=True)
        prof.export_chrome_trace(trace)

    events = prof.events()
    device = _merged((e.time_range.start, e.time_range.end)
                     for e in events if e.device_type == cuda)
    host = [(e.time_range.start, e.time_range.end, e.name)
            for e in events if e.device_type != cuda]
    t0 = min(e.time_range.start for e in events)
    t1 = max(e.time_range.end for e in events)
    wall_us = max(t1 - t0, 1e-9)
    idle = sorted(((b[0] - a[1], a[1], b[0])
                   for a, b in zip(device, device[1:])), reverse=True)
    out_gaps = []
    for us, g0, g1 in idle[:5]:
        open_ = sorted((e - s, name) for s, e, name in host
                       if s <= g0 and e >= g1)
        out_gaps.append(dict(ms=us / 1e3, at_ms=(g0 - t0) / 1e3,
                             host_op=open_[0][1] if open_ else None,
                             outer_host_op=open_[-1][1] if open_ else None))
    return dict(rows=rows, busy_ms=busy_ms, wall_ms=wall_us / 1e3 / per,
                idle_share=1 - sum(e - s for s, e in device) / wall_us,
                gaps=out_gaps, kernels=sum(r[1] for r in rows))


if __name__ == "__main__":
    main()
