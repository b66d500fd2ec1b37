"""Dry run on the ``meta`` device: build every (architecture x input shape)
step at full width with empty stand-ins (no allocation, no computation),
run it once under :class:`repro_torch.analysis.op_cost.OpCounter`, and
record what it would move and hold on one H100.

The counterpart of the JAX package's ``repro/launch/dryrun.py``, for one
device (the meshes, per-pod LoRA, expert parallelism and FSDP wait for the
multi-GPU engine, ROADMAP.md queue 1 item 8).  For each combination it
records:
  - the bytes of each tree (frozen, LoRA, AdamW state, inputs, channel,
    cache) and the step's peak of live bytes (the counterpart of
    ``memory_analysis``), and whether it fits the card's 80 GB;
  - the count of the step (``Cost``: flops, bytes) and its roofline terms
    (:mod:`repro_torch.analysis.roofline`);
  - the per-op rows, beside the record as gzip JSON, for
    :mod:`repro_torch.analysis.breakdown`.

A training step of many microbatches is counted at 2 and at 3
microbatches of the same size and extrapolated along the line through
them, which is exact: from 2 on, each microbatch runs the same ops (the
1-microbatch step runs no accumulation, so it is not on that line).  The
peak is the 2-microbatch run's.

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --elsa
  python -m repro_torch.launch.dryrun --arch olmo-1b --elsa   # every shape
  python -m repro_torch.launch.dryrun --all --elsa
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import time
import traceback

import torch

from repro_torch.analysis import op_cost, roofline
from repro_torch.configs import ASSIGNED, REGISTRY, get_config
from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.core.sketch import make_plan
from repro_torch.launch.train import (SKETCH_ROWS, elsa_channel_specs,
                                      make_serve_step, make_train_step)
from repro_torch.models import zoo
from repro_torch.models.params import abstract_tree
from repro_torch.optim import AdamW

RUNS_DIR = roofline.RUNS_DIR
MESH = "h100x1"
_MULTI_DEVICE = ("multi_pod", "per_pod_lora", "expert_parallel", "fsdp")


def skip_reason(arch: str, shape_name: str):
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return ("full-attention architecture without a sliding-window "
                "variant; long_500k skipped per DESIGN.md §4")
    if cfg.family == "encoder" and shape.kind == "decode":
        return "encoder-only architecture has no decode step"
    return None


def _shape(shape) -> InputShape:
    return INPUT_SHAPES[shape] if isinstance(shape, str) else shape


def build(arch: str, shape, *, elsa: bool = False, chunk: int = 2048,
          microbatches: int = 1):
    """The step of (arch, shape) and its arguments, every tensor an empty
    stand-in on the meta device (``shape``: a name of ``INPUT_SHAPES`` or
    an ``InputShape``).  Returns ``(fn, args, trees)``, ``trees`` the
    argument trees by name.  Train: the LoRA step with AdamW over
    ``microbatches`` microbatches, with the ELSA channel (its sketch plan
    built on the CPU and moved) if ``elsa``; prefill: the forward without
    remat and the last position's argmax; decode: one token against a
    ``seq_len`` cache."""
    cfg = get_config(arch)
    shape = _shape(shape)
    device = "meta"
    model = zoo.get_model(cfg)
    specs = model.specs(cfg)
    dt = cfg.dtype()
    frozen = abstract_tree(specs["frozen"], dt, device)
    lora = abstract_tree(specs["lora"], dt, device)
    window = cfg.sliding_window if shape.name == "long_500k" else 0
    inputs = zoo.input_specs(cfg, shape, device)
    trees = {"frozen": frozen, "lora": lora, "inputs": dict(inputs)}

    if shape.kind == "train":
        opt = AdamW(lr=1e-4)
        elsa_z = 0
        if elsa:
            ch_specs, elsa_z = elsa_channel_specs(cfg)
            ch = {k: torch.empty(s, dtype=getattr(torch, d), device=device)
                  for k, (s, d) in ch_specs.items()}
            ch["plan"] = make_plan(cfg.d_model, SKETCH_ROWS, elsa_z,
                                   device=device)
            inputs["_channel"] = trees["channel"] = ch
        step = make_train_step(cfg, optimizer=opt, window=window,
                               chunk=chunk, num_microbatches=microbatches,
                               elsa_z=elsa_z)
        opt_state = trees["opt_state"] = opt.init(lora)
        return step, (frozen, lora, opt_state, inputs), trees
    if shape.kind == "prefill":
        @torch.no_grad()
        def prefill(fz, lp, batch):
            logits, _ = model.forward(cfg, fz, lp, batch, window=window,
                                      chunk=chunk, remat=False)
            return torch.argmax(logits[:, -1, :cfg.vocab_size], -1)
        return prefill, (frozen, lora, inputs), trees
    cache = trees["cache"] = abstract_tree(
        model.cache_specs(cfg, shape.global_batch, shape.seq_len), dt,
        device)
    step = make_serve_step(cfg, window=window, chunk=4096)
    return step, (frozen, lora, cache, inputs), trees


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in op_cost._tensors(tree))


def count(arch: str, shape, *, elsa: bool = False, chunk: int = 2048,
          microbatches: int = 0):
    """The step's :class:`~repro_torch.analysis.op_cost.Count` on ``meta``
    (its trees built by :func:`build`), a training step's over its
    microbatches (``microbatches``, or the JAX package's rule on one
    device: about 2 sequences a microbatch) counted at 2 and 3 of them and
    extrapolated where there are more than 3, and a summary: ``{"trees":
    bytes of each tree, "microbatches", "counted", "extrapolated"}``.  The
    peak is the first counted run's, with the whole batch's inputs in
    place of that run's (the microbatches are views of them)."""
    shape = _shape(shape)
    nm = 1
    if shape.kind == "train":
        nm = microbatches or max(1, shape.global_batch // 2)
    runs = [nm] if nm <= 3 else [2, 3]
    counts, inputs = [], []
    for n in runs:
        mb = InputShape(shape.name, shape.seq_len,
                        shape.global_batch // nm * n, shape.kind)
        fn, args, trees = build(arch, mb, elsa=elsa, chunk=chunk,
                                microbatches=n)
        counts.append(op_cost.count(fn, *args)[0])
        inputs.append(tree_bytes(trees["inputs"]))
        del fn, args, trees
    c = counts[0]
    if len(runs) > 1:
        c = c.extrapolate(counts[1], nm - runs[0])
    _, _, trees = build(arch, shape, elsa=elsa, chunk=chunk,
                        microbatches=nm)
    sizes = {k: tree_bytes(v) for k, v in trees.items()}
    c.peak_bytes += sizes["inputs"] - inputs[0]
    return c, {"trees": sizes, "microbatches": nm, "counted": runs,
               "extrapolated": len(runs) > 1}


def run_one(arch: str, shape_name: str, *, out_dir: str = RUNS_DIR,
            tag: str = "", save_ops: bool = True, **build_kw):
    name = f"{arch}__{shape_name}__{MESH}{tag}"
    reason = skip_reason(arch, shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": MESH, "tag": tag,
           "chips": 1, "dtype": str(get_config(arch).dtype()).removeprefix(
               "torch.")}
    os.makedirs(out_dir, exist_ok=True)
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        with open(os.path.join(out_dir, name + ".json"), "w") as f:
            json.dump(rec, f, indent=2)
        print(f"[dryrun] SKIP {name}: {reason}")
        return rec

    t0 = time.time()
    try:
        c, summary = count(arch, shape_name, **build_kw)
        rec["status"] = "ok"
        rec.update(summary)
        rec["peak_bytes"] = c.peak_bytes
        rec["fits"] = c.peak_bytes <= roofline.HBM_BYTES
        rec["cost"] = {"flops": c.cost.flops, "bytes": c.cost.bytes,
                       "collective_bytes": c.cost.collective_bytes,
                       "flops_counted": op_cost.FLOPS_COUNTED}
        rec["kernels"] = {k: dict(zip(("calls", "flops", "bytes"), v))
                          for k, v in c.kernels.items()}
        print(f"[dryrun] {name} peak {c.peak_bytes / 1e9:.2f} GB "
              f"(fits: {rec['fits']}), flops={c.cost.flops:.3e} "
              f"bytes={c.cost.bytes:.3e}")
        if save_ops:
            with gzip.open(os.path.join(out_dir, name + ".ops.json.gz"),
                           "wt") as f:
                json.dump(c.op_rows(), f)
            rec["op_rows"] = len(c.rows)
    except Exception as e:  # noqa: BLE001 — record failures, don't die
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] FAIL {name}: {rec['error']}")
    rec["host_s"] = round(time.time() - t0, 2)
    if rec["status"] == "ok":
        rec["roofline"] = roofline.roofline_terms(
            {**rec, "parsed": roofline.parsed(rec["cost"])})
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(rec, f, indent=2)
    print(f"[dryrun] {name}: {rec['status']} ({rec['host_s']}s)")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(REGISTRY), default=None)
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out-dir", default=RUNS_DIR)
    ap.add_argument("--no-ops", action="store_true",
                    help="do not write the per-op rows")
    ap.add_argument("--elsa", action="store_true",
                    help="enable the ELSA split channel in train_step")
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--microbatches", type=int, default=0)
    for flag in _MULTI_DEVICE:
        ap.add_argument("--" + flag.replace("_", "-"), action="store_true")
    args = ap.parse_args(argv)
    for flag in _MULTI_DEVICE:
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')}: needs the multi-GPU engine "
                f"(ROADMAP.md, queue 1 item 8)")

    if args.all:
        combos = [(a, s) for a in ASSIGNED for s in INPUT_SHAPES]
    elif args.arch:
        combos = [(args.arch, s)
                  for s in ([args.shape] if args.shape else INPUT_SHAPES)]
    else:
        ap.error("--arch [--shape], or --all")

    ok = fail = skip = 0
    t0 = time.time()
    for a, s in combos:
        rec = run_one(a, s, out_dir=args.out_dir, tag=args.tag,
                      save_ops=not args.no_ops, elsa=args.elsa,
                      chunk=args.chunk, microbatches=args.microbatches)
        ok += rec["status"] == "ok"
        fail += rec["status"] == "error"
        skip += rec["status"] == "skipped"
    print(f"[dryrun] done: {ok} ok, {skip} skipped, {fail} failed in "
          f"{time.time() - t0:.1f}s")
    if fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
