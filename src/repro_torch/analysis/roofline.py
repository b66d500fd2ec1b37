"""Roofline analysis over dry-run records, for one NVIDIA H100: the
counterpart of the JAX package's ``repro/analysis/roofline.py``.

Per (arch x shape x mesh):
  compute term    = flops / peak of the record's dtype        [s]
  memory term     = bytes / 3.35e12                           [s]  (HBM3)
  collective term = wire bytes / 450e9                        [s]  (NVLink,
                    each way; 0 on one device until ROADMAP.md queue 1
                    item 8)

flops and bytes come from :mod:`repro_torch.analysis.op_cost`'s count of
the step (``launch/dryrun.py``), the hand-written kernels at their
declared work.  ``bound_ms`` is the same rule for one kernel call:
``chip_smoke.py``'s bound columns.

The peaks (NVIDIA H100 SXM5 80GB HBM3 data sheet, dense, at the 700 W
limit): bf16 and fp16 989 TFLOP/s on the tensor cores; f32 67 TFLOP/s on
the CUDA cores, with no TF32, as the kernels take none and the port turns
it off; HBM3 3.35 TB/s; NVLink 900 GB/s all to all, 450 GB/s each way.

MODEL_FLOPS uses the 6·N·D convention (2·N·D forward-only for prefill;
2·N_active·B per decoded token), N excluding embedding/vocab tables and
counting only the active expert fraction for MoE, as the JAX package's.

  PYTHONPATH=src python -m repro_torch.analysis.roofline --dir build/dryrun
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
from typing import Dict, Optional

from repro_torch.configs import get_config
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.models import zoo
from repro_torch.models.params import is_spec

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12          # bytes/s
NVLINK_BW = 450e9         # bytes/s, each way
HBM_BYTES = 80e9          # the card's memory
RUNS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                        "build", "dryrun")


def bound_ms(flops: float, nbytes: float, dtype):
    """The least time one kernel call could take on the card, in ms, and
    what bounds it: ``(ms, "bytes" | "operations")``, the larger of
    ``nbytes`` at 3.35 TB/s and ``flops`` at the peak of ``dtype``."""
    t_bytes = nbytes / HBM_BW
    t_ops = flops / PEAK_FLOPS[str(dtype).removeprefix("torch.")]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def active_params(cfg) -> float:
    """Parameter count excluding vocab tables; MoE experts scaled by the
    routed fraction (top-k / E); shared experts fully counted."""
    specs = zoo.get_model(cfg).specs(cfg)
    frac = 1.0
    if cfg.moe:
        frac = cfg.moe.experts_per_token / cfg.moe.num_experts
    total = 0.0

    def visit(node):
        nonlocal total
        if is_spec(node):
            if "vocab" in (node.axes or ()):
                return
            n = float(math.prod(node.shape))
            if "experts" in (node.axes or ()):
                n *= frac
            total += n
        elif isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                visit(v)

    visit(specs)
    return total


def model_flops(cfg, shape) -> float:
    n = active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # decode: 1 token


def parsed(cost: Dict) -> Dict:
    """A record's ``cost`` under the JAX package's ``parsed`` keys (per
    device)."""
    return {"flops_per_chip": cost["flops"],
            "bytes_per_chip": cost["bytes"],
            "collectives": dict(cost["collective_bytes"]),
            "wire_bytes_per_chip": sum(cost["collective_bytes"].values())}


def load_record(json_path: str) -> Optional[Dict]:
    """A dry-run record, with its count under ``parsed``."""
    with open(json_path) as f:
        rec = json.load(f)
    if rec.get("status") == "ok" and "cost" in rec:
        rec["parsed"] = parsed(rec["cost"])
    return rec


def roofline_terms(rec: Dict) -> Optional[Dict]:
    if rec.get("status") != "ok" or "parsed" not in rec:
        return None
    p = rec["parsed"]
    cfg = get_config(rec["arch"])
    shape = INPUT_SHAPES[rec["shape"]]
    chips = rec["chips"]
    t_c = p["flops_per_chip"] / PEAK_FLOPS[rec["dtype"]]
    t_m = p["bytes_per_chip"] / HBM_BW
    t_n = p["wire_bytes_per_chip"] / NVLINK_BW
    dominant = max((("compute", t_c), ("memory", t_m), ("collective", t_n)),
                   key=lambda x: x[1])[0]
    mf = model_flops(cfg, shape)
    counted = p["flops_per_chip"] * chips
    return {
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_n,
        "dominant": dominant,
        "model_flops": mf,
        "useful_ratio": mf / counted if counted else 0.0,
        "step_s": max(t_c, t_m, t_n),
    }


_SUGGEST = {
    "compute": ("compute-bound: keep the products on the tensor cores in "
                "bf16 (wgmma tiles; f32 runs at 67 of 989 TFLOP/s) or cut "
                "the recompute of checkpointed blocks"),
    "memory": ("HBM-bound: fuse the elementwise chains and the channel's "
               "stages into the kernels, keep intermediates in bf16, or "
               "raise the work per pass (larger microbatches)"),
    "collective": ("NVLink-bound: overlap the collectives with compute, "
                   "sync LoRA per edge round instead of per step, or shard "
                   "the experts (all-to-all) instead of replicating them"),
}


def make_table(records, *, mesh_filter="h100x1", tag_filter="") -> str:
    rows = []
    for rec in records:
        if rec.get("mesh") != mesh_filter or rec.get("tag", "") != tag_filter:
            continue
        arch, shape = rec["arch"], rec["shape"]
        if rec["status"] == "skipped":
            rows.append(f"| {arch} | {shape} | skipped | — | — | — | — | — | "
                        f"— | — | {rec['reason'][:60]} |")
            continue
        t = roofline_terms(rec)
        if t is None:
            rows.append(f"| {arch} | {shape} | {rec['status']} | | | | | | "
                        f"| | |")
            continue
        rows.append(
            f"| {arch} | {shape} | ok | {rec['peak_bytes'] / 1e9:.1f} | "
            f"{'yes' if rec['fits'] else 'no'} | "
            f"{t['compute_s']*1e3:.2f} | {t['memory_s']*1e3:.2f} | "
            f"{t['collective_s']*1e3:.2f} | **{t['dominant']}** | "
            f"{t['useful_ratio']:.2f} | {_SUGGEST[t['dominant']][:80]}… |")
    header = ("| arch | shape | status | peak (GB) | fits 80 GB | compute (ms)"
              " | memory (ms) | collective (ms) | dominant | 6ND/counted | "
              "next lever |\n|---|---|---|---|---|---|---|---|---|---|---|")
    return header + "\n" + "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=RUNS_DIR)
    ap.add_argument("--mesh", default="h100x1")
    ap.add_argument("--tag", default="")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    records = []
    for path in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        rec = load_record(path)
        if rec:
            t = roofline_terms(rec)
            if t:
                rec["roofline"] = t
            records.append(rec)
    print(make_table(records, mesh_filter=args.mesh, tag_filter=args.tag))
    if args.json_out:
        slim = [{k: v for k, v in r.items() if k != "traceback"}
                for r in records]
        with open(args.json_out, "w") as f:
            json.dump(slim, f, indent=2, default=float)


if __name__ == "__main__":
    main()
