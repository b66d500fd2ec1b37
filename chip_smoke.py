#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA H100 (sm_90a): the
serving path (full llama3-8b), LoRA fine-tuning through ELSA's split
channel (full-width olmo-1b, ``launch/train.py --full --elsa``), the ELSA
federation of full-width bert-base (``Federation(...).run("elsa")`` on its
default, batched backend and on the reference backend), the same
federation on the event-driven edge runtime (``run(...,
runtime=RuntimeConfig(policy=...))``), and the federation of a dense
decoder (full-width olmo-1b), then the federation with update screening
(``FedConfig(screen=True)``), with full-state checkpoints and resumes, and
with registry-backed client populations (``run(population=
PopulationConfig(...))``) inside telemetry sessions, and the MoE family
(grok-1; deepseek-v2 with multi-head latent attention) serving and
training through ELSA's channel at full width, depth cut; then the
analysis and dry-run layer (``repro_torch.analysis``,
``repro_torch.launch.dryrun``) over those paths.

    python3 chip_smoke.py
    python3 chip_smoke.py --channel-times-of CHECKOUT

The second form only times the channel's kernels (phase 3b's timed rows)
of the package in another checkout, for comparing two versions in one call.

Phases, each of which raises (and so exits non-zero) on any failed check:

1. device: the card's name and power limit, compute capability (9, 0);
   TF32 off for matmuls and cuDNN;
2. build: the four kernel libraries from ``src/repro_torch/csrc``, one nvcc
   per source, all started together;
3. the LoRA kernel against its plain version at llama3-8b's decode shapes,
   one ragged shape and olmo-1b's training shape (T 512), in bf16 and f32,
   grok-1's decode and training shapes (K 6144, O 6144 and 1024) in bf16,
   and at the federation's (T 2048, K = O = 768, r 8 and r 0, f32), with
   times, bounds, a library yardstick and the route each shape takes (the
   library's rule held against its Python twin), and, for bf16 at T >= 64,
   how its outputs' rounding differs from the plain version's on both
   routes; then the cut sweep: the decode and the tile kernels, both
   checked and timed, at T 16 to 256;
3b. the channel's kernels (SS-OP, the count sketch's scatter and gather)
   against their plain versions, forward and backward, at olmo-1b's, the
   federation's and the causal-LM federation's shapes, grok-1's and
   deepseek-v2's (D 6144 and 5120) and ragged ones, in bf16 and f32, each path's shapes timed in its own type (olmo-1b bf16,
   the two federations f32) with bounds and a copy yardstick (and decompress
   beside a composite of library calls), the route of every call (the
   library's rule held against its Python twin), then the sweep of the
   tile routes' configurations (SS-OP's cluster size and rows a tile, the
   scatter's rows a block, the gather's rows and columns a block), each
   checked and timed;
3c. flash attention against its plain version, forward (o, m, l) and
   gradient (the Function against autograd through the plain version), at
   bert-base's and olmo-1b's shapes (olmo-1b's in bf16 and, as the
   causal-LM federation runs it, in f32), ragged lengths, GQA at llama3-8b's
   ratio (at Dh 128 and 64), grok-1's (G 6), deepseek-v2's multi-head
   latent attention (q/k 192, v 128; bf16 and f32), a window and S 4096
   (with the peak memory of its forward and
   backward), with times, bounds and ``scaled_dot_product_attention`` as
   the library yardstick, and the time of the plain recomputing backward
   beside SDPA's backward;
4. full-width parity: llama3-8b decode steps, kernel path against plain path
   on the same weights (f32 at 2 layers, bf16 at full depth);
5. serving: full llama3-8b (32 layers, bf16, random weights from a seed) in
   ``ServingEngine`` through the kernel, then ``swap_adapter`` and a second
   batch; the kernel's launch count must be 4 projections x 32 layers x ticks;
6. where the time goes: a ``torch.profiler`` window over decode ticks
   (``repro_torch.analysis.breakdown.device_breakdown``, as in 9 and 10);
7. training parity: one ``make_train_step`` step of full-width olmo-1b (f32,
   4 layers) through the channel, kernel path against plain path, checked
   over the tree and in each block with soft attention, reported at the
   init;
8. training: the launcher (``launch.train._main``) on full olmo-1b (16
   layers, bf16, ``--elsa``) for 20 steps of its batch stream; the loss must
   fall and each kernel's launches per step must be what the path implies;
   its ``--ckpt`` file, read back with ``restore_state``, must hold the
   trained LoRA tree bitwise;
8b. the step-0 witness: phase 8's first forward (every LoRA B zero) on
   the kernel path, with the decode kernels forced, with the plain LoRA
   projection and on the plain path, each loss and logits against the
   plain path in f32;
9. where a training step's time goes: ``torch.profiler`` over one step, and
   what building the channel each step costs;
10. the federation: full-width bert-base (12 layers, f32, random weights
   from a seed) registered as ``"bert-base-full"``, 8 clients on 2 edges
   (a quarter of them constrained devices),
   ``run("elsa")`` for 2 rounds of 4 local steps on the default (batched)
   backend; the losses must be finite and each ``run_clients`` call must
   launch each kernel real members x steps x what a client step's split
   implies (flash 12, one per block); its wall a client step and its host
   syncs (CUDA's sync debug mode) are reported, and one call is profiled;
10r. the same federation on ``backend="reference"``, each client step
   counted and one profiled;
10c. one local step at the training lr on both backends, from the same
   weights with the same batches: losses to 1e-6 relative, each updated
   LoRA leaf to 1e-5 of its scale;
13. the event runtime: phase 10's federation under ``RuntimeConfig(policy=
   "sync")``, whose history must be phase 10's bit for bit with a strictly
   increasing simulated clock, then ``"deadline"`` and ``"async"`` under
   a churn trace and a fault trace (crashes, drops, dups, sign-flipped and
   scaled updates): the event trace must be consistent (per client, each
   arrival or crash follows a dispatch of it; a cloud aggregation per
   round), the losses finite, and every ``run_clients`` call must launch
   phase 10's counts and make one host sync; each policy's calls, cohort
   size, wall a client step, simulated end, trace summary and peak memory
   are reported;
14. update screening: phase 10's federation with ``screen=True``, on the
   plain loop, the sync runtime under a NaN fault trace and the deadline
   and async runtimes under phase 13's traces; every screening pass's
   statistics are held against a float64 recomputation on the CPU (masks
   equal, norms and cosines to 1e-5, verdicts equal away from a
   threshold), every NaN update must be judged nonfinite and theta stay
   finite; verdicts, fallbacks, the trust EMA, the time and host syncs a
   pass and the wall a client step are reported;
15. checkpoints: phase 10's federation with a checkpoint a round (its
   history must be phase 10's bit for bit), then a new ``Federation``
   resumed from round 0 (history and final theta bit for bit), the same
   on the sync runtime with phase 14's screening and NaN trace (event
   trace and trust ledger too); deadline and async refuse ``checkpoint=``;
   the files' bytes and the save and restore times are reported;
16. populations and telemetry: phase 10's federation (a) with the identity
   population (``registered=8``) inside a telemetry session, history phase
   10's bit for bit; (b) with 10^5 registered ids (uniform cohorts, seed
   17, a population-sized churn trace, adapter shards of 8 float16 rows)
   for 3 rounds of 4 steps streaming to a ``JsonlSink``: new online
   cohorts, participations 3 x 8, one channel build an identity that
   trained, a rebuilt identity channel bit-equal, the registry's memory
   bounded by its touched shards, the file read back a record a round and
   rendered by ``repro_torch.analysis.telemetry_report``; (c) ``deadline``
   and ``async`` with 1,000 registered ids under phase 13's traces and a
   1,000-client churn trace, every update written under a pinned
   dispatch-time identity; (d) (b) for 2 rounds with a checkpoint a round,
   resumed from round 0 by a new ``Federation`` bit for bit (history,
   theta, registry columns and adapter shards).  Every ``run_clients`` call
   launches phase 10's counts with 1 host sync; the registry's MiB, host
   RSS, the wall a client step and the bookkeeping's host ms and syncs a
   round are reported;
10b. split-training parity: one ``split_loss`` gradient of bert-base at
   full width (f32, 4 layers) through the channel, kernel path against
   plain path, each block against its own f32-vs-f64 floor;
12. the causal-LM federation: full-width olmo-1b (16 layers, f32)
   registered as ``"olmo-1b-full"``, 4 clients on 2 edges, the launcher's
   8 x 64 stream, 2 rounds of 2 local steps on the default backend, with
   phase 10's launch check (16 blocks) and finite losses;
17. the MoE family, grok-1 and deepseek-v2 (MLA, a dense first layer),
   one at a time: (a) one block at full width in f32, kernel path against
   plain path (forward, aux, the input's and the LoRA tree's gradients,
   each to 4x the plain path's f32-vs-f64 error; routing equal as
   integers); (b) ``ServingEngine`` on the depth-cut model (grok-1 4
   layers, deepseek-v2 5, full width, bf16): 8 requests for 16 new
   tokens, ``swap_adapter``, 8 more, with tokens/s and ms a tick beside
   the floor of reading every weight once a tick, the launches exact (grok
   16 LoRA a tick, deepseek none); (c) ``make_train_step`` through the
   launcher's channel, 10 steps of 8 x 64 at lr 3e-3: losses finite and
   falling, each kernel's launches a step as the path implies;
11. every LoRA shape that phases 5, 8, 10, 10r, 13, 14, 15, 16, 12 and 17
   launched (recorded while they ran, with their pointers' alignment)
   against the plain version at phase 3's tolerances, so every kernel
   instantiation a path ran is held;
18. analysis and dry run: (a) ``python -m repro_torch.launch.dryrun --arch
   A --elsa`` on the meta device for each assigned architecture, each in a
   process of its own started after phase 1 (no card, one thread) and
   waited for at the end of phase 2, so that their host time overlaps the
   build: every record ``ok``, or ``skipped`` for ``skip_reason``'s
   reason; the roofline table; (b) phase 8's olmo-1b ``--elsa`` step
   counted on the card (``repro_torch.analysis.op_cost``) and on meta:
   flops, bytes and each kernel's calls and declared work equal, the calls
   the launches phase 8 counts; (c) the dry run's peak of that step and of
   a llama3-8b tick (batch 8, cache 128) within 10% of
   ``torch.cuda.max_memory_allocated()`` of the same work; (d) the device
   breakdowns (busy, profiled wall, idle share, top 10 ops, the 5 longest
   idle gaps and the host ops open across them) of an olmo-1b step (phase
   9), a bert-base ``run_clients`` call (10), a causal-LM ``run_clients``
   call (12) and grok-1's serving ticks (17); (e) the olmo-1b step's and
   the bert-base client step's model flops over busy x peak and wall x
   peak, and the counted roofline step over busy.

The kernels' bound columns are ``repro_torch.analysis.roofline.bound_ms``
of each kernel's declared ``work``.  The second-to-last line is the
kernels' JSON record; the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the repository beside it, the script
fails before printing either.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
# --channel-times-of CHECKOUT times that checkout's channel kernels instead
SRC = os.path.join(
    os.path.abspath(sys.argv[sys.argv.index("--channel-times-of") + 1])
    if "--channel-times-of" in sys.argv else ROOT, "src")
sys.path.insert(0, SRC)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.analysis import op_cost, roofline  # noqa: E402
from repro_torch.analysis.breakdown import device_breakdown  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.core import split_training  # noqa: E402
from repro_torch.core.sketch import (SketchPlan, make_plan,  # noqa: E402
                                     selection_matrices)
from repro_torch.core.split_training import Channel  # noqa: E402
from repro_torch.core.ssop import SSOP  # noqa: E402
from repro_torch.data.pipeline import infinite_batches  # noqa: E402
from repro_torch.federation import FedConfig, Federation  # noqa: E402
from repro_torch.kernels.count_sketch import ops as cs_ops  # noqa: E402
from repro_torch.kernels.count_sketch import ref as cs_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.lora import ops as lora_ops  # noqa: E402
from repro_torch.kernels.lora.ref import lora_matmul_ref  # noqa: E402
from repro_torch.kernels.ssop import ops as ssop_ops  # noqa: E402
from repro_torch.kernels.ssop.ref import ssop_apply_ref  # noqa: E402
from repro_torch.launch import dryrun, train  # noqa: E402
from repro_torch.launch.train import make_serve_step  # noqa: E402
from repro_torch.models import common, transformer, zoo  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models.split_api import (BertSplitModel,  # noqa: E402
                                          CausalLMSplitModel,
                                          get_split_model,
                                          register_split_model)
from repro_torch.models.params import init_tree  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves, tree_map  # noqa: E402
from repro_torch.federation.topology import (make_churn_trace,  # noqa: E402
                                             make_fault_trace)
from repro_torch.runtime import RuntimeConfig  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

L2_BYTES = 50 * 2 ** 20
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")


@contextlib.contextmanager
def phase(name):
    t0 = time.time()
    print(f"== {name}", flush=True)
    yield
    print(f"== {name}: ok in {time.time() - t0:.1f}s", flush=True)


@contextlib.contextmanager
def plain_lora():
    """Route the model's projections through the plain version (the
    comparison side of phase 4; the port never does this itself)."""
    saved = common.lora_matmul
    common.lora_matmul = lora_matmul_ref
    try:
        yield
    finally:
        common.lora_matmul = saved


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def device_phase():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA H100")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    cap = torch.cuda.get_device_capability(0)
    print(f"device 0: {torch.cuda.get_device_name(0)}, capability {cap}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    check(cap == (9, 0), f"needs compute capability (9, 0), got {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


# ---------------------------------------------------------------------------
# 3. kernel against plain version
# ---------------------------------------------------------------------------

def _time_ms(fn, arg_sets, iters=60, reps=7):
    """Device time of one call: ``iters`` calls, rotating over ``arg_sets``
    (copies of the weights whose sum exceeds L2, so every call reads W from
    device memory, as a decode step does after 32 layers of other weights),
    are captured in a CUDA graph; the median over ``reps`` replays, timed by
    CUDA events, is divided by ``iters``.  The graph keeps the host's launch
    cost out of the number."""
    for args in arg_sets:                 # warm up (and build) outside capture
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    out = []
    for _ in range(reps):
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1) / iters)
    del graph
    return statistics.median(out)


def _library_lora(x, w, a, b, s):
    return x @ w + s * ((x @ a) @ b)


def kernel_phase():
    """bf16: max abs error <= 2^-7 * max|y_plain|; f32: <= 1e-5 *
    max|y_plain| (rtol 1e-5 against the output's scale).  Both sides
    accumulate in fp32 and round once, so they differ only in the order of
    summation (and, in bf16, in at most one rounding of an output)."""
    shapes = [("q", 8, 4096, 4096, 16), ("k/v", 8, 4096, 1024, 16),
              ("o", 8, 4096, 4096, 16), ("ragged", 5, 4000, 1000, 16),
              ("train", 512, 2048, 2048, 16)]
    # bert-base's q/v and its adapter-free k/o in a client step
    fed = [("fed", 2048, 768, 768, 8), ("fed k/o", 2048, 768, 768, 0)]
    # grok-1's projections (phase 17), bf16: decode at batch 8 and training
    # at 8 x 64 tokens; q and o are 6144 x 6144, k and v 6144 x 1024
    grok = [("grok q/o", 8, 6144, 6144, 16), ("grok k/v", 8, 6144, 1024, 16),
            ("grok train q/o", 512, 6144, 6144, 16),
            ("grok train k/v", 512, 6144, 1024, 16)]
    rows = []
    g = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        for name, T, K, O, r in shapes + (fed if dtype == torch.float32
                                          else grok):
            def make():
                return ((torch.randn(K, O, generator=g, device="cuda")
                         / K ** 0.5).to(dtype),
                        (torch.randn(K, r, generator=g, device="cuda")
                         / K ** 0.5).to(dtype),
                        (torch.randn(r, O, generator=g, device="cuda")
                         * 0.1).to(dtype))
            x = torch.randn(T, K, generator=g, device="cuda").to(dtype)
            w, a, b = make()
            y = lora_ops.lora_matmul(x, w, a, b, 2.0)
            torch.cuda.synchronize()
            y_plain = lora_matmul_ref(x, w, a, b, 2.0)
            err = (y.float() - y_plain.float()).abs().max().item()
            scale = y_plain.float().abs().max().item()
            tol = (2 ** -7 if dtype == torch.bfloat16 else 1e-5) * scale
            check(y.shape == (T, O) and y.dtype == dtype,
                  f"{name}: output {tuple(y.shape)} {y.dtype}")
            check(err <= tol, f"lora kernel {name} {dtype}: max abs err "
                              f"{err:.3e} > {tol:.3e}")
            n_copies = max(2, -(-2 * L2_BYTES // (w.numel() * w.element_size())))
            sets = [(x, w, a, b, 2.0)] + [(x, *make(), 2.0)
                                          for _ in range(n_copies - 1)]
            ms = _time_ms(lora_ops.lora_matmul, sets)
            plain_ms = _time_ms(lora_matmul_ref, sets)
            lib_ms = _time_ms(_library_lora, sets)
            bound_ms, bound_by = roofline.bound_ms(
                *lora_ops.work(T, K, O, r, dtype), dtype)
            route = _lora_route(T, K, O, r, dtype)
            row = dict(shape=name, T=T, K=K, O=O, r=r,
                       dtype=str(dtype).removeprefix("torch."),
                       max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                       route=route)
            rows.append(row)
            print(f"lora {name:6s} {row['dtype']:8s} T={T} K={K} O={O} r={r}: "
                  f"err {err:.3e} (tol {tol:.3e})  kernel {ms * 1e3:.2f} us  "
                  f"plain {plain_ms * 1e3:.2f} us  library {lib_ms * 1e3:.2f} us"
                  f"  bound {bound_ms * 1e3:.2f} us ({bound_by})  "
                  f"{bound_ms / ms:.1%} of bound; {route}", flush=True)
            if dtype == torch.bfloat16 and T >= lora_ops._TILE_MIN_ROWS:
                row["rounding"] = _rounding(x, w, a, b)
            del sets, w, a, b
    return rows


def _lora_route(T, K, O, r, dtype, offsets=(0, 0, 0)):
    """The route the library takes for these shapes (x, w and a at these
    byte offsets from 16-byte alignment), checked against its Python twin
    (``ops._uses_tiles``), as text: the decode kernels, or a tile kernel's
    block, grid and waves (blocks over the card's SMs)."""
    n = 16 // torch.tensor([], dtype=dtype).element_size()
    aligned = K % n == 0 and O % n == 0 and not any(offsets)
    plan = lora_ops._plan(T, K, O, r, dtype, aligned)
    tiles = lora_ops._uses_tiles(T, K, O, r, dtype, aligned)
    check((plan is not None) == tiles,
          f"lora route of T={T} K={K} O={O} r={r}: library {plan}, twin "
          f"{tiles}")
    if plan is None:
        return "decode kernels"
    bt, bo, gx, gy, gz = plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (f"tiles {bt} x {bo}, grid {gx} x {gy} x {gz} (K split {gz}) = "
            f"{gx * gy * gz} blocks, {gx * gy * gz / sms:.2f} blocks an SM "
            f"on {sms} SMs")


def _rounding(x, w, a, b):
    """How a bf16 shape's outputs differ from the plain version's, on the
    route the shape takes and on the decode kernels forced, with B as given
    and with B = 0 (a training step's start: y is x W rounded once): the
    share of outputs that differ, and the mean signed error and the mean
    error towards zero, each over mean |y|.  Both kernels sum on tensor
    cores and the plain version in fp32 SGEMM, so a sum that drifts one way
    shows here and not in the max-error check: at most 1% of the outputs
    may differ, and each mean error must stay within 1e-4 of mean |y| (one
    bf16 ulp is 2^-8 of |y| or more, so a one-ulp drift in 3% of the
    outputs would fail)."""
    out = {}
    for b_name, bb in (("B", b), ("B=0", torch.zeros_like(b))):
        want = lora_matmul_ref(x, w, a, bb, 2.0).float()
        mean = want.abs().mean().item()
        for route in (None, "decode"):
            d = lora_ops._launch(x, w, a, bb, 2.0, route=route).float() - want
            key = f"{route or 'own route'}, {b_name}"
            out[key] = dict(differ=(d != 0).float().mean().item(),
                            signed=d.mean().item() / mean,
                            towards_zero=-(d * want.sign()).mean().item()
                            / mean)
            print(f"  bf16 rounding, {key}: {out[key]['differ']:.3%} of "
                  f"outputs differ from the plain version; mean error "
                  f"{out[key]['signed']:+.2e}, towards zero "
                  f"{out[key]['towards_zero']:+.2e} of mean |y|", flush=True)
            check(out[key]["differ"] <= 0.01
                  and abs(out[key]["signed"]) <= 1e-4
                  and abs(out[key]["towards_zero"]) <= 1e-4,
                  f"bf16 rounding, {key}: {out[key]}")
    return out


def lora_cut_sweep():
    """Both routes of the LoRA kernel, forced through the private
    ``route`` argument, at T 16 to 256 and K = O = 2048 and 4096 (r 16), in
    both dtypes: each checked against the plain version as in phase 3 and
    timed as there.  The rows put the cut (``kTileMinRows``) where the
    tiles start to win; the script prints where that is in this run."""
    rows = []
    g = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.bfloat16, torch.float32):
        for K in (2048, 4096):
            for T in (16, 32, 64, 128, 256):
                r = 16
                n_copies = max(2, -(-2 * L2_BYTES // (K * K * (
                    torch.tensor([], dtype=dtype).element_size()))))
                sets = []
                for _ in range(n_copies):
                    sets.append((
                        torch.randn(T, K, generator=g, device="cuda").to(dtype),
                        (torch.randn(K, K, generator=g, device="cuda")
                         / K ** 0.5).to(dtype),
                        (torch.randn(K, r, generator=g, device="cuda")
                         / K ** 0.5).to(dtype),
                        (torch.randn(r, K, generator=g, device="cuda")
                         * 0.1).to(dtype), 2.0))
                y_plain = lora_matmul_ref(*sets[0]).float()
                tol = (2 ** -7 if dtype == torch.bfloat16 else 1e-5) * \
                    y_plain.abs().max().item()
                row = dict(T=T, K=K, O=K, r=r,
                           dtype=str(dtype).removeprefix("torch."),
                           chosen=("tile" if lora_ops._uses_tiles(
                               T, K, K, r, dtype, True) else "decode"))
                for route in ("decode", "tile"):
                    def fn(*args, route=route):
                        return lora_ops._launch(*args, route=route)
                    err = (fn(*sets[0]).float() - y_plain).abs().max().item()
                    check(err <= tol, f"lora {route} T={T} K={K} {dtype}: "
                                      f"max abs err {err:.3e} > {tol:.3e}")
                    row[f"{route}_ms"] = _time_ms(fn, sets)
                    row[f"{route}_err"] = err
                rows.append(row)
                print(f"lora cut sweep {row['dtype']:8s} T={T:3d} K=O={K}: "
                      f"decode {row['decode_ms'] * 1e3:8.2f} us  tiles "
                      f"{row['tile_ms'] * 1e3:8.2f} us  (the port takes "
                      f"{row['chosen']})", flush=True)
                del sets
    for dtype in ("bfloat16", "float32"):
        wins = [r_["T"] for r_ in rows if r_["dtype"] == dtype
                and all(q["tile_ms"] < q["decode_ms"] for q in rows
                        if q["dtype"] == dtype and q["T"] >= r_["T"])]
        print(f"lora cut sweep {dtype}: the tiles win at every K from T = "
              f"{min(wins) if wins else 'none of the T swept'}; the cut is "
              f"{lora_ops._TILE_MIN_ROWS}")
    return rows


# ---------------------------------------------------------------------------
# 3b. the channel's kernels against their plain versions
# ---------------------------------------------------------------------------

def _channel_work(op, T, D, r, Y, Z, dtype):
    """(operations, bytes) of the channel op, as its kernel declares them
    (``ssop_ops.work``, ``cs_ops.work``)."""
    if op.startswith("ssop"):
        return ssop_ops.work(T, D, r, dtype)
    return cs_ops.work(op, T, D, Y, Z, dtype)


# (case, T, D, r, Y, Z): olmo-1b's channel (the launcher's 8 x 64 tokens;
# SS-OP r 16; Y 3, Z 325), the federation's (bert-base, 16 x 128 tokens; r 8;
# Y 3, Z = max(4, int(768 / (2.1 * 3))) = 121), the causal-LM federation's
# (olmo-1b, 8 x 64 tokens; FedConfig's r 8; Y 3, Z = int(2048 / 6.3) = 325)
# and ragged ones.  The paths' own shapes are timed in the type each path
# runs; the tile sweep covers the first two.
CHANNEL_CASES = [("train", 512, 2048, 16, 3, 325),
                 ("federation", 2048, 768, 8, 3, 121),
                 ("causal-LM", 512, 2048, 8, 3, 325),
                 ("grok-1", 512, 6144, 16, 3, 975),
                 ("deepseek-v2", 512, 5120, 16, 3, 812),
                 ("ragged Y4", 5, 2000, 16, 4, 37),
                 ("ragged Y5", 5, 2000, 16, 5, 37)]
CHANNEL_SWEPT = {("train", torch.bfloat16), ("federation", torch.float32)}
# the MoE family's launcher channels (phase 17: 8 x 64 tokens, r 16, Y 3,
# Z = int(D / 6.3)), timed in the bf16 they run
CHANNEL_TIMED = CHANNEL_SWEPT | {("causal-LM", torch.float32),
                                 ("grok-1", torch.bfloat16),
                                 ("deepseek-v2", torch.bfloat16)}


def _channel_ops(T, D, r, Y, Z, dtype, g):
    """The six channel ops at these shapes, on inputs drawn from ``g``:
    ``[(kernel, op, fn, plain, library or None, make_args)]``, where a
    quarter of the buckets of every sketch are zero, so the median meets
    ties.  Uses only the wrappers' public calls, so that
    ``--channel-times-of`` can time another checkout with it."""
    plan = make_plan(D, Y, Z, seed=1, device="cuda")
    b, s = plan.bucket, plan.sign
    basis = torch.linalg.qr(torch.randn(D, r, generator=g, device="cuda"))[0]
    v = torch.linalg.qr(torch.randn(r, r, generator=g, device="cuda"))[0]
    w = (v.T - torch.eye(r, device="cuda")).to(dtype).contiguous()
    wt = w.T.contiguous()
    uu = basis.to(dtype).contiguous()
    sel = selection_matrices(plan).to(dtype)

    def h_():
        return torch.randn(T, D, generator=g, device="cuda").to(dtype)

    def sk_():
        u = torch.randn(T, Y, Z, generator=g, device="cuda").to(dtype)
        u[:, :, :max(1, Z // 4)] = 0
        return u

    return plan, uu, w, [
        ("ssop_apply", "ssop forward",
         lambda h: ssop_ops.ssop_apply_td(h, uu, w),
         lambda h: ssop_apply_ref(h, uu, w), None, lambda: (h_(),)),
        ("ssop_apply", "ssop backward",
         lambda gy: ssop_ops.ssop_apply_td(gy, uu, wt),
         lambda gy: ssop_apply_ref(gy, uu, wt), None, lambda: (h_(),)),
        ("sketch_scatter", "compress",
         lambda h: cs_ops.sketch_scatter(h, plan),
         lambda h: cs_ref.compress_ref(h, b, s, Z),
         lambda h: torch.einsum("td,ydz->tyz", h, sel),
         lambda: (h_(),)),
        ("sketch_scatter", "median backward",
         lambda gy, u: cs_ops.sketch_scatter(gy, plan, u=u),
         lambda gy, u: cs_ref.median_backward_ref(gy, u, b, s), None,
         lambda: (h_(), sk_())),
        ("sketch_gather", "decompress",
         lambda u: cs_ops.sketch_gather(u, plan),
         lambda u: cs_ref.decompress_ref(u, b, s), None,
         lambda: (sk_(),)),
        ("sketch_gather", "compress backward",
         lambda u: cs_ops.sketch_gather(u, plan, median=False),
         lambda u: cs_ref.gather_sum_ref(u, b, s),
         lambda u: torch.einsum("tyz,ydz->td", u, sel),
         lambda: (sk_(),)),
    ]


def _arg_sets(args, make):
    """``args`` and enough fresh copies that together they exceed L2 twice."""
    nbytes = sum(t.numel() * t.element_size() for t in args)
    return [args] + [make() for _ in range(
        max(1, -(-2 * L2_BYTES // nbytes)) - 1)]


def channel_kernel_phase():
    """SS-OP (forward, and its backward: the same kernel with Wᵀ), the
    scatter kernel (compress; the median's backward) and the gather kernel
    (decompress; compress's backward), each against its plain version on the
    same inputs, at olmo-1b's and the federation's shapes and ragged ones,
    in bf16 and f32.  Decompress only gathers, negates and compares, so it
    is held to equality; the others sum in fp32 and round once on both
    sides, so f32 is held to 1e-5 and bf16 to 2^-7 of the output's largest
    value (summation order, and at most one bf16 rounding of an output).
    The route each call takes is printed and the library's rule held
    against its Python twin.  Each path's shapes are timed in its own type
    (olmo-1b bf16, the federation f32) as in phase 3, rotating over input
    copies that exceed L2, beside the copy yardstick (``out.copy_(x)``, x
    of the output's shape and type rotated the same way, and a copy that
    reads and writes as many bytes as the op must move, the bound's bytes:
    the timing method's floor for those bytes) and, for decompress at an odd Y,
    the library composite (index u by bucket, times sign,
    ``torch.median``: three calls, exact for an odd Y, held to
    equality)."""
    g = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for case, T, D, r, Y, Z in CHANNEL_CASES:
            plan, _, _, table = _channel_ops(T, D, r, Y, Z, dtype, g)
            for kernel, op, fn, plain, lib, make in table:
                args = make()
                n0 = getattr(_wrapper(kernel), "launches")
                got = fn(*args)
                torch.cuda.synchronize()
                check(_wrapper(kernel).launches == n0 + 1,
                      f"{kernel} {op}: the kernel did not launch")
                want = plain(*args)
                err = (got.float() - want.float()).abs().max().item()
                scale = want.float().abs().max().item()
                tol = (0.0 if op == "decompress" else
                       (2 ** -7 if dtype == torch.bfloat16 else 1e-5) * scale)
                check(got.shape == want.shape and got.dtype == want.dtype,
                      f"{kernel} {op}: {tuple(got.shape)} {got.dtype}")
                check(err <= tol, f"{kernel} {op} {case} {dtype}: max abs "
                                  f"err {err:.3e} > {tol:.3e}")
                row = dict(kernel=kernel, op=op, case=case, T=T, D=D, r=r,
                           Y=Y, Z=Z, dtype=str(dtype).removeprefix("torch."),
                           max_abs_err=err, tol=tol,
                           route=_channel_route(op, T, D, r, Y, Z, dtype))
                msg = ""
                if (case, dtype) in CHANNEL_TIMED:
                    sets = _arg_sets(args, make)
                    row["ms"] = _time_ms(fn, sets)
                    row["plain_ms"] = _time_ms(plain, sets)
                    row["library_ms"] = _time_ms(lib, sets) if lib else None
                    row["bound_ms"], row["bound_by"] = roofline.bound_ms(
                        *_channel_work(op, T, D, r, Y, Z, dtype), dtype)
                    row["copy_ms"] = _copy_ms(got)
                    nbytes = _channel_work(op, T, D, r, Y, Z, dtype)[1]
                    row["bytes_copy_ms"] = _copy_ms(torch.empty(
                        nbytes // (2 * got.element_size()), dtype=dtype,
                        device="cuda"))
                    lib_s = (f"{row['library_ms'] * 1e3:.2f} us" if lib
                             else "-")
                    if op == "decompress" and Y % 2:
                        comp = _median_composite(plan, dtype)
                        check(torch.equal(comp(*args), want),
                              f"decompress composite {case}: not the median")
                        row["composite_ms"] = _time_ms(comp, sets)
                        lib_s = (f"- (composite of 3 calls "
                                 f"{row['composite_ms'] * 1e3:.2f} us)")
                    msg = (f"  kernel {row['ms'] * 1e3:.2f} us  plain "
                           f"{row['plain_ms'] * 1e3:.2f} us  library {lib_s}"
                           f"  copy {row['copy_ms'] * 1e3:.2f} us (of the "
                           f"op's bytes {row['bytes_copy_ms'] * 1e3:.2f} us)"
                           f"  bound {row['bound_ms'] * 1e3:.2f} us "
                           f"({row['bound_by']})  "
                           f"{row['bound_ms'] / row['ms']:.1%} of bound")
                    del sets
                rows.append(row)
                print(f"{kernel:14s} {op:17s} {case:10s} {row['dtype']:8s} "
                      f"err {err:.3e} (tol {tol:.3e}){msg}; {row['route']}",
                      flush=True)
    return rows


def _copy_ms(like):
    """The copy yardstick: ``out.copy_(x)`` for x of ``like``'s shape and
    type, x rotated over copies that exceed L2 as the kernels' inputs are,
    into one ``out`` as the kernels' outputs are (each call reads x and
    writes out once: the timing method's floor for a kernel that writes
    ``like``)."""
    out = torch.empty_like(like)

    def make():
        return (torch.randn_like(like),)
    return _time_ms(lambda x: out.copy_(x), _arg_sets(make(), make))


def _median_composite(plan, dtype):
    """Decompress from library calls, for an odd Y: the estimates gathered
    by indexing u with bucket, times sign, then ``torch.median`` over y (it
    takes the lower middle value, which is ELSA's median only for an odd
    Y)."""
    ys = torch.arange(plan.y, device="cuda")[:, None]
    b, sg = plan.bucket, plan.sign.to(dtype)
    return lambda u: torch.median(u[:, ys, b] * sg, dim=1).values


def _channel_route(op, T, D, r, Y, Z, dtype):
    """The route the library takes for a channel call of these shapes
    (16-byte aligned operands), checked against its Python twin, as
    text."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if op.startswith("ssop"):
        plan = ssop_ops._plan(T, D, r, dtype, True)
        twin = ssop_ops._tile_plan(T, D, r, dtype, True)
        check((plan is None) == (twin is None)
              and (plan is None or (plan[:2], plan[3]) == (twin[:2], twin[2])),
              f"ssop route of T={T} D={D} r={r} {dtype}: library {plan}, "
              f"twin {twin}")
        if plan is None:
            return "rows route (4 rows a block)"
        C, R, tiles, Ds, smem = plan
        return (f"tile route: cluster {C} x slice {Ds}, {R} rows a tile, "
                f"{tiles} tiles ({C * tiles} blocks, "
                f"{C * tiles / sms:.2f} an SM), {smem / 1024:.1f} KB")
    if op in ("decompress", "compress backward"):
        got = cs_ops._plan_gather(T, D, Y, Z, dtype)
        want = cs_ops._gather_plan(T, D, Y, Z, dtype)
        el = torch.empty((), dtype=dtype).element_size()
        check(got is not None and want is not None and got[:2] == want
              and got[2] == -(-T // want[0]) * -(-D // want[1])
              and got[3] == cs_ops._gather_smem(want[0], Y, Z, el),
              f"gather tile of T={T} D={D} Y={Y} Z={Z} {dtype}: library "
              f"{got}, twin {want}")
        R, Dc, blocks, smem, threads = got
        return (f"tile: {R} rows x {Dc} columns a block, {blocks} blocks "
                f"({blocks / sms:.2f} an SM) of {threads} threads, "
                f"{smem / 1024:.1f} KB")
    median_bwd = op == "median backward"
    got = cs_ops._plan_scatter(T, D, Y, Z, median_bwd, dtype)
    rows = cs_ops._scatter_plan(T, D, Y, Z, median_bwd, dtype)
    el = torch.empty((), dtype=dtype).element_size()
    check(got is not None and got[0] == rows
          and (not rows or got[2] == cs_ops._scatter_smem(
              rows, D, Y, Z, median_bwd, el)),
          f"scatter route of T={T} D={D} Y={Y} Z={Z} {op} {dtype}: library "
          f"{got}, twin {rows}")
    if not rows:
        return f"rows route (4 rows a block), {got[1]} blocks"
    return (f"tile route: {rows} rows a block, {got[1]} blocks "
            f"({got[1] / sms:.2f} an SM), {got[2] / 1024:.1f} KB")


def channel_sweep():
    """The tile routes' configurations at each path's timed shape: SS-OP's
    cluster size (1, 2, 4, 8) x rows a tile (8, 16, 32), forward, the
    scatter's rows a block (1, 2, 4, 8, and the rows route), compress and
    the median backward, and the gather's rows a block (1 to 32) x columns
    a slice (D in 1, 2, 4 and 8 slices), decompress and compress backward;
    each checked against the plain version as in phase 3b and timed as
    there.  The rule's own choice is marked."""
    g = torch.Generator(device="cuda").manual_seed(3)
    out = []
    for case, T, D, r, Y, Z in CHANNEL_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            if (case, dtype) not in CHANNEL_SWEPT:
                continue
            plan, uu, w, table = _channel_ops(T, D, r, Y, Z, dtype, g)
            el = torch.empty((), dtype=dtype).element_size()
            tol = (2 ** -7 if dtype == torch.bfloat16 else 1e-5)
            chosen = ssop_ops._tile_plan(T, D, r, dtype, True)
            h = table[0][5]()
            sets = _arg_sets(h, table[0][5])
            want = ssop_apply_ref(h[0], uu, w).float()
            for C in (1, 2, 4, 8):
                for R in (8, 16, 32):
                    Ds = ssop_ops._round_up(-(-D // C), 16)
                    if ssop_ops._tile_smem(Ds, R, r, el, C) > \
                            ssop_ops._MAX_SMEM:
                        continue

                    def fn(x, C=C, R=R):
                        return ssop_ops._launch(x, uu, w, route="tile",
                                                cluster=C, rows=R)
                    err = (fn(h[0]).float() - want).abs().max().item()
                    check(err <= tol * want.abs().max().item(),
                          f"ssop sweep C={C} R={R} {case}: err {err:.3e}")
                    ms = _time_ms(fn, sets)
                    mark = "  <- the rule" if chosen[:2] == (C, R) else ""
                    out.append(dict(kernel="ssop_apply", case=case, C=C, R=R,
                                    ms=ms, max_abs_err=err,
                                    rule=bool(mark)))
                    print(f"ssop sweep {case:10s} cluster {C} rows {R:2d}: "
                          f"{ms * 1e3:7.2f} us ({-(-T // R)} tiles){mark}",
                          flush=True)
            for op, mi in (("compress", 2), ("median backward", 3)):
                median_bwd = op == "median backward"
                _, _, _, plain, _, make = table[mi]
                args = make()
                sets = _arg_sets(args, make)
                want = plain(*args).float()
                rule = cs_ops._scatter_plan(T, D, Y, Z, median_bwd, dtype)
                for R in ("rows", 1, 2, 4, 8):
                    if R != "rows" and cs_ops._scatter_smem(
                            R, D, Y, Z, median_bwd, el) > \
                            cs_ops.MAX_SHARED_BYTES:
                        continue

                    def fn(x, u=None, R=R):
                        o = torch.empty(x.shape[:-1] + (Y, Z), dtype=x.dtype,
                                        device=x.device)
                        cs_ops._launch("scatter", x, u, plan, o, x.shape[0],
                                       rows=R)
                        return o
                    err = (fn(*args).float() - want).abs().max().item()
                    check(err <= tol * want.abs().max().item(),
                          f"scatter sweep {op} rows {R} {case}: err "
                          f"{err:.3e}")
                    ms = _time_ms(fn, sets)
                    mark = ("  <- the rule" if rule == (0 if R == "rows"
                                                        else R) else "")
                    out.append(dict(kernel="sketch_scatter", op=op,
                                    case=case, rows=R, ms=ms,
                                    max_abs_err=err, rule=bool(mark)))
                    print(f"scatter sweep {case:10s} {op:15s} rows {R!s:4s}:"
                          f" {ms * 1e3:7.2f} us{mark}", flush=True)
                del sets
            out += _gather_sweep(case, T, D, Y, Z, dtype, plan, table)
    return out


def _gather_sweep(case, T, D, Y, Z, dtype, plan, table):
    """The gather's tiles at one timed shape (see :func:`channel_sweep`):
    decompress held to equality, compress backward to phase 3b's
    tolerance."""
    out = []
    el = torch.empty((), dtype=dtype).element_size()
    run = 16 // el
    rule = cs_ops._gather_plan(T, D, Y, Z, dtype)
    for op, mi in (("decompress", 4), ("compress backward", 5)):
        _, _, _, plain, _, make = table[mi]
        args = make()
        sets = _arg_sets(args, make)
        want = plain(*args)
        tol = 0.0 if op == "decompress" else (
            (2 ** -7 if dtype == torch.bfloat16 else 1e-5)
            * want.float().abs().max().item())
        for R in (1, 2, 4, 8, 16, 32):
            for slices in (1, 2, 4, 8):
                Dc = -(-(-(-D // slices)) // run) * run
                if (Dc // run > cs_ops._GATHER_THREADS
                        or cs_ops._gather_smem(R, Y, Z, el)
                        > cs_ops.MAX_SHARED_BYTES):
                    continue

                def fn(u, R=R, Dc=Dc):
                    o = torch.empty(u.shape[:-2] + (D,), dtype=u.dtype,
                                    device=u.device)
                    cs_ops._launch("gather", u, None, plan, o, u.shape[0],
                                   mode=0 if op == "decompress" else 1,
                                   rows=R, cols=Dc)
                    return o
                err = (fn(*args).float() - want.float()).abs().max().item()
                check(err <= tol, f"gather sweep {op} R={R} Dc={Dc} {case}: "
                                  f"err {err:.3e} > {tol:.3e}")
                ms = _time_ms(fn, sets)
                mark = "  <- the rule" if rule == (R, Dc) else ""
                _, _, blocks, _, threads = cs_ops._plan_gather(
                    T, D, Y, Z, dtype, R, Dc)
                out.append(dict(kernel="sketch_gather", op=op, case=case,
                                rows=R, cols=Dc, blocks=blocks,
                                threads=threads, ms=ms, max_abs_err=err,
                                rule=bool(mark)))
                print(f"gather sweep {case:10s} {op:17s} rows {R:2d} cols "
                      f"{Dc:4d} ({blocks:4d} blocks x {threads:3d}): "
                      f"{ms * 1e3:7.2f} us{mark}", flush=True)
        del sets
    return out


def channel_times():
    """``--channel-times-of``: each channel op's device time at each path's
    timed shape, as phase 3b times it, through the public calls only (so a
    checkout without this PR's routes can be timed the same way); one JSON
    line."""
    g = torch.Generator(device="cuda").manual_seed(2)
    out = []
    for case, T, D, r, Y, Z in CHANNEL_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            if (case, dtype) not in CHANNEL_TIMED:
                continue
            _, _, _, table = _channel_ops(T, D, r, Y, Z, dtype, g)
            for kernel, op, fn, plain, _, make in table:
                args = make()
                err = (fn(*args).float() - plain(*args).float()).abs().max()
                ms = _time_ms(fn, _arg_sets(args, make))
                out.append(dict(kernel=kernel, op=op, case=case,
                                dtype=str(dtype).removeprefix("torch."),
                                ms=ms, max_abs_err=err.item()))
                print(f"{kernel:14s} {op:17s} {case:10s} {ms * 1e3:8.2f} us",
                      flush=True)
    # the whole channel as a training step without a prebuilt plan builds
    # it (the launcher's olmo-1b channel)
    cfg = get_config("olmo-1b")
    _, z = train.elsa_channel_specs(cfg)
    ch = train.channel_params(cfg, z, "cuda")
    build_ms = _build_ms(lambda: Channel(
        SSOP(ch["u"], ch["v"]), SketchPlan(ch["bucket"], ch["sign"], z)))
    print(f"building the olmo-1b channel and its sketch plan: "
          f"{build_ms:.4f} ms (median of 20)")
    print(json.dumps({"channel_times": out, "channel_build_ms": build_ms,
                      "src": SRC}))


def _wrapper(kernel):
    return {"ssop_apply": ssop_ops.ssop_apply_td,
            "sketch_scatter": cs_ops.sketch_scatter,
            "sketch_gather": cs_ops.sketch_gather}[kernel]


# ---------------------------------------------------------------------------
# 3c. flash attention against its plain version
# ---------------------------------------------------------------------------

# (case, B, S, H, KV, Dh, dtype, causal, window); Dh is (Dqk, Dv) where v's
# head dim differs (deepseek-v2's multi-head latent attention, expanded)
FLASH_CASES = [
    ("bert-base", 16, 128, 12, 12, 64, torch.float32, False, 0),
    ("olmo-1b", 8, 64, 16, 16, 128, torch.bfloat16, True, 0),
    ("olmo-1b f32", 8, 64, 16, 16, 128, torch.float32, True, 0),
    ("ragged 24", 2, 24, 12, 12, 64, torch.float32, False, 0),
    ("ragged 100", 2, 100, 16, 16, 128, torch.bfloat16, True, 0),
    ("ragged 1000", 1, 1000, 12, 12, 64, torch.float32, True, 0),
    ("gqa llama3-8b", 1, 512, 32, 8, 128, torch.bfloat16, True, 0),
    ("window 128", 1, 1000, 8, 8, 128, torch.bfloat16, True, 128),
    ("gqa G4 d64", 1, 512, 32, 8, 64, torch.bfloat16, True, 0),
    ("grok-1 G6", 8, 64, 48, 8, 128, torch.bfloat16, True, 0),
    ("deepseek-v2 MLA", 8, 64, 128, 128, (192, 128), torch.bfloat16, True,
     0),
    ("deepseek-v2 MLA f32", 8, 64, 128, 128, (192, 128), torch.float32,
     True, 0),
    ("long 4096", 1, 4096, 8, 8, 128, torch.bfloat16, True, 0),
]


def _head_dims(Dh):
    return Dh if isinstance(Dh, tuple) else (Dh, Dh)


def _sdpa(q, k, v, causal, window):
    """``torch.nn.functional.scaled_dot_product_attention`` on the same
    inputs (the library yardstick; the port never calls it)."""
    mask = None
    if window:
        pos = torch.arange(q.shape[1], device=q.device)
        mask = pos[None] > pos[:, None] - window
        if causal:
            mask &= pos[None] <= pos[:, None]
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, is_causal=causal and not window,
        enable_gqa=q.shape[2] != k.shape[2]).transpose(1, 2)


def _sdpa_fwd_bwd(q, k, v, do, causal, window):
    """SDPA's forward and backward on the same inputs: less its forward's
    time, the library yardstick of the backward."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    return torch.autograd.grad(_sdpa(*leaves, causal, window), leaves, do)


def flash_kernel_phase():
    """The kernel's (o, m, l) against the plain version's on the same
    inputs: both take fp32 scores and sums and round o once, so f32 is
    held to 1e-5 and bf16 to 2^-7 of max|o| (summation order; one bf16
    rounding), m and l to 1e-5.  The Function's gradient (its recomputing
    backward) against autograd through the plain version: f32 to 1e-4 and
    bf16 to 2^-6 of the gradient's largest value (it takes Σ dO·O from
    the rounded o; each gradient is rounded once).  Timed as in phase 3
    (CUDA graphs, rotating over input copies that exceed L2); the long
    case also reports the peak memory of the Function's forward and
    backward against the 512 MiB that its eight fp32 S x S matrices would
    take.  ``bwd_ms`` times the Function's backward alone (the plain
    ``attention_bwd`` from the saved o, m and l); ``library_bwd_ms`` is
    SDPA's forward plus backward less its forward."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for case, B, S, H, KV, Dh, dtype, causal, window in FLASH_CASES:
        Dqk, Dv = _head_dims(Dh)

        def make():
            return [torch.randn(B, S, n, d, generator=gen,
                                device="cuda").to(dtype)
                    for n, d in ((H, Dqk), (KV, Dqk), (KV, Dv))]
        q, k, v = make()
        n0 = fa_ops.flash_attention_fwd.launches
        o, m, l = fa_ops.flash_attention_fwd(q, k, v, causal=causal,
                                             window=window, scale=Dqk ** -0.5)
        torch.cuda.synchronize()
        check(fa_ops.flash_attention_fwd.launches == n0 + 1,
              f"flash {case}: the kernel did not launch")
        ro, rm, rl = attention_ref(q, k, v, causal=causal, window=window)
        err = (o.float() - ro.float()).abs().max().item()
        scale = ro.float().abs().max().item()
        tol = (1e-5 if dtype == torch.float32 else 2 ** -7) * scale
        err_ml = max((m - rm).abs().max().item() / rm.abs().max().item(),
                     (l - rl).abs().max().item() / rl.abs().max().item())
        check(o.shape == ro.shape and o.dtype == dtype,
              f"flash {case}: {tuple(o.shape)} {o.dtype}")
        check(err <= tol, f"flash {case}: max abs err {err:.3e} > {tol:.3e}")
        check(err_ml <= 1e-5, f"flash {case}: m/l rel err {err_ml:.3e}")
        del ro, rm, rl

        do = torch.randn(o.shape, generator=gen, device="cuda").to(dtype)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = torch.autograd.grad(fa_ops.flash_attention(
            *leaves, causal=causal, window=window), leaves, do)
        torch.cuda.synchronize()
        peak_mib = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
        want = torch.autograd.grad(attention_ref(
            *plain, causal=causal, window=window)[0], plain, do)
        gtol = 1e-4 if dtype == torch.float32 else 2 ** -6
        grad_err = 0.0
        for name, a, b in zip("qkv", got, want):
            e = (a.float() - b.float()).abs().max().item()
            sc = b.float().abs().max().item()
            grad_err = max(grad_err, e / sc)
            check(e <= gtol * sc, f"flash {case} d{name}: {e:.3e} > "
                                  f"{gtol * sc:.3e}")
        del got, want, leaves, plain

        nbytes = sum(t.numel() * t.element_size() for t in (q, k, v))
        sets = [(q, k, v)] + [tuple(make()) for _ in range(
            max(1, -(-2 * L2_BYTES // nbytes)) - 1)]
        iters = 60 if S * S * H * B <= 2 ** 24 else 10
        row = dict(case=case, B=B, S=S, H=H, KV=KV, Dh=Dqk, Dv=Dv,
                   dtype=str(dtype).removeprefix("torch."), causal=causal,
                   window=window, max_abs_err=err, tol=tol,
                   ml_rel_err=err_ml, grad_rel_err=grad_err,
                   grad_peak_mib=peak_mib)
        row["ms"] = _time_ms(lambda a, b, c: fa_ops.flash_attention_fwd(
            a, b, c, causal=causal, window=window, scale=Dqk ** -0.5),
            sets, iters=iters)
        row["plain_ms"] = _time_ms(lambda a, b, c: attention_ref(
            a, b, c, causal=causal, window=window), sets, iters=iters)
        row["library_ms"] = _time_ms(
            lambda a, b, c: _sdpa(a, b, c, causal, window), sets, iters=iters)
        row["bound_ms"], row["bound_by"] = roofline.bound_ms(*fa_ops.work(
            B, S, S, H, KV, Dqk, Dv, dtype, causal, window), dtype)
        bwd_sets = []
        for a, b, c in sets:
            fo, fm, fl = fa_ops.flash_attention_fwd(
                a, b, c, causal=causal, window=window, scale=Dqk ** -0.5)
            bwd_sets.append((a, b, c, fo, fm, fl, torch.randn(
                fo.shape, generator=gen, device="cuda").to(dtype)))
        row["bwd_ms"] = _time_ms(
            lambda *t: fa_ops.attention_bwd(*t, causal=causal, window=window,
                                            scale=Dqk ** -0.5),
            bwd_sets, iters=iters)
        row["library_bwd_ms"] = _time_ms(
            lambda a, b, c, fo, fm, fl, g: _sdpa_fwd_bwd(
                a, b, c, g, causal, window),
            bwd_sets, iters=iters) - row["library_ms"]
        del bwd_sets
        rows.append(row)
        print(f"flash {case:13s} B={B} S={S} H={H} KV={KV} Dh={Dqk} Dv={Dv} "
              f"{row['dtype']:8s} {'causal' if causal else 'full':6s} "
              f"w={window}: err {err:.3e} (tol {tol:.3e}), m/l {err_ml:.1e}, "
              f"grad {grad_err:.1e} of scale; kernel {row['ms'] * 1e3:.2f} us"
              f"  plain {row['plain_ms'] * 1e3:.2f} us  sdpa "
              f"{row['library_ms'] * 1e3:.2f} us  bound "
              f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})  "
              f"{row['bound_ms'] / row['ms']:.1%} of bound; backward "
              f"{row['bwd_ms'] * 1e3:.2f} us (sdpa "
              f"{row['library_bwd_ms'] * 1e3:.2f} us); fwd+bwd peak "
              f"{peak_mib:.1f} MiB above the inputs", flush=True)
        del sets, q, k, v, o, m, l, do
        torch.cuda.empty_cache()
    long = rows[-1]
    full_mib = long["H"] * long["S"] ** 2 * 4 / 2 ** 20
    print(f"flash long {long['S']}: forward+backward peak "
          f"{long['grad_peak_mib']:.1f} MiB above the inputs, against "
          f"{full_mib:.0f} MiB for {long['H']} fp32 S x S matrices")
    check(long["grad_peak_mib"] < full_mib,
          "the flash backward kept an S x S matrix")
    return rows


# ---------------------------------------------------------------------------
# 4. full-width parity
# ---------------------------------------------------------------------------

def _random_b(lora, gen, std):
    """Nonzero LoRA B (the spec init leaves it zero, which would leave the
    adapter half of the kernel unexercised)."""
    for layer in lora["blocks"] + lora.get("prefix", []):
        for k, t in layer["attn"].items():
            if k.endswith("_b"):
                t.copy_(torch.randn(t.shape, generator=gen, device=t.device)
                        * std)
    return lora


def _decode(cfg, params, tokens, steps):
    model = zoo.get_model(cfg)
    cache = init_tree(model.cache_specs(cfg, tokens.shape[1], 128),
                      None, cfg.dtype(), "cuda")
    out = []
    with torch.inference_mode():
        for t in range(steps):
            logits, cache = model.decode_step(
                cfg, params["frozen"], params["lora"], cache,
                {"tokens": tokens[t]}, window=cfg.sliding_window)
            out.append(logits.float())
    return out


def parity_phase(full_params):
    cfg32 = get_config("llama3-8b").with_(
        num_layers=2, param_dtype="float32", activation_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(1)
    p32 = init_tree(zoo.get_model(cfg32).specs(cfg32), gen, torch.float32,
                    "cuda")
    _random_b(p32["lora"], gen, 0.02)
    toks = torch.randint(0, cfg32.vocab_size, (4, 8, 1), generator=gen,
                         device="cuda")
    lora_ops.lora_matmul.launches = 0
    got = _decode(cfg32, p32, toks, 4)
    check(lora_ops.lora_matmul.launches == 4 * 4 * 2,
          f"f32 kernel path launched {lora_ops.lora_matmul.launches}")
    with plain_lora():
        want = _decode(cfg32, p32, toks, 4)
    for t, (a, b) in enumerate(zip(got, want)):
        err, scale = (a - b).abs().max().item(), b.abs().max().item()
        print(f"f32 2-layer step {t}: max abs diff {err:.3e}, "
              f"max|logits| {scale:.3e}")
        check(torch.isfinite(a).all().item(), "f32 logits not finite")
        check(err <= 1e-4 * scale, f"f32 parity step {t}: {err:.3e}")
    del p32, got, want
    torch.cuda.empty_cache()

    # bf16 at full depth.  Tolerance 2^-4 * max|logits|: the two paths round
    # each of 128 projections to bf16 once, but sum in different orders, so
    # outputs may differ by one bf16 ulp (2^-8 relative) per projection, and
    # those differences travel through 32 residual blocks in bf16.
    cfg = get_config("llama3-8b")
    toks = torch.randint(0, cfg.vocab_size, (1, 8, 1), generator=gen,
                         device="cuda")
    (got,) = _decode(cfg, full_params, toks, 1)
    with plain_lora():
        (want,) = _decode(cfg, full_params, toks, 1)
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    agree = (got[:, -1, :cfg.vocab_size].argmax(-1)
             == want[:, -1, :cfg.vocab_size].argmax(-1)).sum().item()
    print(f"bf16 32-layer first step: max abs diff {err:.3e}, max|logits| "
          f"{scale:.3e}, greedy tokens agree on {agree}/8 rows")
    check(torch.isfinite(got).all().item(), "bf16 logits not finite")
    check(err <= 2 ** -4 * scale, f"bf16 full-depth parity: {err:.3e}")


# ---------------------------------------------------------------------------
# 5. serving
# ---------------------------------------------------------------------------

def _requests(engine, rng, vocab):
    lengths = rng.integers(4, 33, size=8)
    return [engine.submit(rng.integers(0, vocab, n).tolist(),
                          max_new_tokens=32) for n in lengths]


def serving_phase(cfg, params):
    engine = ServingEngine(cfg, params=params, batch_size=8, max_len=128)
    rng = np.random.default_rng(0)
    engine.submit([1, 2, 3], max_new_tokens=2)        # warm-up batch
    engine.run_until_drained()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ticks0, tokens0, dt0 = (engine.stats["ticks"], engine.stats["tokens"],
                            engine.stats["decode_s"])

    lora_ops.lora_matmul.launches = 0                 # the main path starts
    first = _requests(engine, rng, cfg.vocab_size)
    engine.run_until_drained()
    gen = torch.Generator(device="cuda").manual_seed(7)
    fresh = init_tree(zoo.get_model(cfg).specs(cfg)["lora"], gen,
                      cfg.dtype(), "cuda")
    engine.swap_adapter(_random_b(fresh, gen, 0.02))
    second = _requests(engine, rng, cfg.vocab_size)
    engine.run_until_drained()
    launches = lora_ops.lora_matmul.launches          # the main path ends

    ticks = engine.stats["ticks"] - ticks0
    tokens = engine.stats["tokens"] - tokens0
    dt = engine.stats["decode_s"] - dt0
    for r in first + second:
        check(r.done and len(r.output) == 32,
              f"request {r.request_id}: done={r.done}, {len(r.output)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.output),
              f"request {r.request_id}: token out of vocab")
    check(launches == 4 * cfg.num_layers * ticks,
          f"lora launches {launches} != 4 x {cfg.num_layers} x {ticks} ticks")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"serving: 16 requests in 2 batches, {ticks} ticks, {tokens} tokens "
          f"in {dt:.3f}s -> {tokens / dt:.1f} tokens/s, "
          f"{dt / ticks * 1e3:.2f} ms/tick, lora launches {launches}, "
          f"peak memory {peak:.2f} GiB")
    print(f"first request: prompt {first[0].prompt[:8]}... -> "
          f"{first[0].output[:8]}...")
    return dict(ticks=ticks, tokens=tokens, decode_s=dt,
                        tokens_per_s=tokens / dt, ms_per_tick=dt / ticks * 1e3,
                        peak_gib=peak), launches


# ---------------------------------------------------------------------------
# 6. where the time goes
# ---------------------------------------------------------------------------

def _our_kernels_ms(rows):
    return {k: sum(us for us, _, key in rows if k in key) / 1e3
            for k in ("lora_matmul", "ssop", "sketch_scatter",
                      "sketch_gather", "flash_fwd")}


def profile_phase(cfg, params, n_ticks=8):
    """Where a tick's time goes, at batch 8: ``n_ticks`` greedy decode steps
    timed on the host clock (each ends in a device-to-host copy of the next
    tokens), then the same under ``torch.profiler`` for the device time of
    each kernel.  Idle share = 1 - device busy / unprofiled wall time."""
    model = zoo.get_model(cfg)
    step = make_serve_step(cfg, window=cfg.sliding_window)

    def run(cache):
        nxt = torch.ones((8,), dtype=torch.int32, device="cuda")
        for _ in range(n_ticks):
            nxt, cache = step(params["frozen"], params["lora"], cache,
                              {"tokens": nxt[:, None].long()})
            nxt.cpu()

    def fresh():
        return init_tree(model.cache_specs(cfg, 8, 128), None, cfg.dtype(),
                         "cuda")

    run(fresh())                                      # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    run(fresh())
    wall_ms = (time.time() - t0) * 1e3 / n_ticks
    print(f"profile ({cfg.name}, batch 8, {n_ticks} ticks), per tick:")
    bd = device_breakdown(lambda: run(fresh()), per=n_ticks,
                          trace=os.path.join(OUT_DIR, "decode_trace.json"))
    rows, busy_ms = bd["rows"], bd["busy_ms"]
    print(f"  wall {wall_ms:.2f} ms/tick without the profiler, device busy "
          f"{busy_ms:.2f} ms/tick -> idle share {1 - busy_ms / wall_ms:.1%}, "
          f"{sum(r[1] for r in rows):.0f} kernels/tick")
    lora_us = sum(us for us, _, key in rows if "lora_matmul" in key)
    return dict(wall_ms_per_tick=wall_ms, device_busy_ms_per_tick=busy_ms,
                idle_share=1 - busy_ms / wall_ms,
                lora_ms_per_tick=lora_us / 1e3,
                top_kernels=[dict(ms_per_tick=us / 1e3, per_tick=n, name=key)
                             for us, n, key in rows[:12]])


# ---------------------------------------------------------------------------
# 7. training parity
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_path():
    """Route the projections, the attention and the channel's four stages
    through the plain versions, differentiated by autograd (the comparison
    side of phases 7 and 10b; the port never does this itself).  PyTorch's
    deterministic algorithms are on meanwhile: the plain compress sums with
    ``index_add``, whose CUDA kernel adds in no fixed order, and at the
    median's near-ties one ulp decides a feature's bucket, so without them
    the plain side's own gradient, and with it the floors of phase 10b,
    changed from run to run (10b then failed about one run in six)."""
    st = split_training
    det = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    saved = (common.lora_matmul, common.flash_attention, st.apply_ssop,
             st.apply_ssop_inverse, st.compress, st.decompress)
    common.lora_matmul = lora_matmul_ref
    common.flash_attention = lambda q, k, v, *, causal, window, scale: \
        attention_ref(q, k, v, causal=causal, window=window, scale=scale)[0]
    eye = lambda v: torch.eye(v.shape[0], dtype=v.dtype, device=v.device)
    st.apply_ssop = lambda h, op: ssop_apply_ref(
        h, op.u.to(h.dtype), (op.v.T - eye(op.v)).to(h.dtype))
    st.apply_ssop_inverse = lambda h, op: ssop_apply_ref(
        h, op.u.to(h.dtype), (op.v - eye(op.v)).to(h.dtype))
    st.compress = lambda h, plan: cs_ref.compress_ref(h, plan.bucket,
                                                      plan.sign, plan.z)
    st.decompress = lambda u, plan: cs_ref.decompress_ref(u, plan.bucket,
                                                          plan.sign)
    try:
        yield
    finally:
        (common.lora_matmul, common.flash_attention, st.apply_ssop,
         st.apply_ssop_inverse, st.compress, st.decompress) = saved
        torch.use_deterministic_algorithms(det[0], warn_only=det[1])


@contextlib.contextmanager
def _recording_lora_calls(calls):
    """Count every LoRA kernel launch in the block by its dtype, T, K, O,
    r and the byte offsets of x, w and a from 16-byte alignment (what the
    library routes by), into ``calls`` for phase 11."""
    launch = lora_ops._launch

    def recorded(x, w, a, b, scale, route=None):
        key = (str(x.dtype).removeprefix("torch."), x.numel() // w.shape[0],
               w.shape[0], w.shape[1], a.shape[1],
               tuple(t.data_ptr() % 16 for t in (x, w, a)))
        calls[key] = calls.get(key, 0) + 1
        return launch(x, w, a, b, scale, route)

    lora_ops._launch = recorded
    try:
        yield calls
    finally:
        lora_ops._launch = launch


def path_shapes_phase(calls):
    """Every LoRA shape the main paths launched (phases 5, 8, 10, 10r, 12)
    against the plain version at phase 3's tolerances, on new inputs at the
    byte offsets the path gave, so each kernel and each instantiation that
    a path ran is checked (the library's route held against its twin)."""
    g = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for (dt, T, K, O, r, offsets), n in sorted(calls.items()):
        dtype = getattr(torch, dt)
        el = torch.tensor([], dtype=dtype).element_size()

        def placed(rows_, cols, offset, std):
            t = (torch.randn(rows_ * cols + 16, generator=g, device="cuda")
                 * std).to(dtype)
            return t[offset // el:offset // el + rows_ * cols].view(rows_,
                                                                  cols)
        x = placed(T, K, offsets[0], 1.0)
        w = placed(K, O, offsets[1], K ** -0.5)
        a = placed(K, r, offsets[2], K ** -0.5)
        b = (torch.randn(r, O, generator=g, device="cuda") * 0.1).to(dtype)
        check(tuple(t.data_ptr() % 16 for t in (x, w, a)) == offsets,
              f"offsets {offsets}")
        y = lora_ops.lora_matmul(x, w, a, b, 2.0)
        want = lora_matmul_ref(x, w, a, b, 2.0).float()
        err = (y.float() - want).abs().max().item()
        tol = (2 ** -7 if dtype == torch.bfloat16 else 1e-5) * \
            want.abs().max().item()
        route = _lora_route(T, K, O, r, dtype, offsets)
        rows.append(dict(dtype=dt, T=T, K=K, O=O, r=r, offsets=offsets,
                         path_launches=n, max_abs_err=err, tol=tol,
                         route=route))
        print(f"lora path shape {dt:8s} T={T} K={K} O={O} r={r} offsets "
              f"{offsets}: {n} launches on the paths; err {err:.3e} (tol "
              f"{tol:.3e}); {route}", flush=True)
        check(err <= tol, f"lora path shape T={T} K={K} O={O} r={r} {dt}: "
                          f"max abs err {err:.3e} > {tol:.3e}")
    return rows


def _counts():
    return {"ssop_apply": ssop_ops.ssop_apply_td.launches,
            "sketch_scatter": cs_ops.sketch_scatter.launches,
            "sketch_gather": cs_ops.sketch_gather.launches,
            "lora_matmul": lora_ops.lora_matmul.launches,
            "flash_attention": fa_ops.flash_attention_fwd.launches}


def _zero_counts():
    ssop_ops.ssop_apply_td.launches = 0
    cs_ops.sketch_scatter.launches = cs_ops.sketch_gather.launches = 0
    lora_ops.lora_matmul.launches = 0
    fa_ops.flash_attention_fwd.launches = 0


def _per_step(n_layers, remat):
    """Launches one training step through the channel implies: per cut,
    SS-OP and its inverse forward and backward (4), compress's scatter and
    the median backward's scatter (2), decompress's gather and compress
    backward's gather (2); per layer 4 LoRA projections and one flash
    attention forward (their backwards are plain products), once more when
    checkpointed blocks are recomputed for the backward (``remat``)."""
    passes = 2 if remat else 1
    return {"ssop_apply": 8, "sketch_scatter": 4, "sketch_gather": 4,
            "lora_matmul": passes * 4 * n_layers,
            "flash_attention": passes * n_layers}


def _max_abs(tree_a, tree_b=None):
    leaves_a = tree_leaves(tree_a)
    if tree_b is None:
        return max(t.abs().max().item() for t in leaves_a)
    return max((a.float() - b.float()).abs().max().item()
               for a, b in zip(leaves_a, tree_leaves(tree_b)))


def _train_parity(qk_scale, checked):
    """One step on the kernel path, the plain path and the plain path in
    f64; returns the comparison (see :func:`train_parity_phase`).  With
    ``checked`` false it only reports."""
    cfg = get_config("olmo-1b").with_(num_layers=4, param_dtype="float32",
                                      activation_dtype="float32")
    check(train.elsa_boundaries(cfg) == (1, 1), "4 layers must give (1, 1)")
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = init_tree(zoo.get_model(cfg).specs(cfg), gen, torch.float32,
                       "cuda")
    _random_b(params["lora"], gen, 0.02)
    for layer in params["frozen"]["blocks"]:
        layer["attn"]["wq"].mul_(qk_scale)
        layer["attn"]["wk"].mul_(qk_scale)
    _, z = train.elsa_channel_specs(cfg)
    ch = train.channel_params(cfg, z, "cuda")
    batch = next(train.batch_stream(cfg, 8, 64, "cuda"))
    lr = 3e-3

    def run(c, p):
        opt = AdamW(lr=lr)
        step = train.make_train_step(c, optimizer=opt, elsa_z=z)
        new, state, loss = step(p["frozen"], p["lora"], opt.init(p["lora"]),
                                {**batch, "_channel": ch})
        torch.cuda.synchronize()
        return new, state["m"], float(loss)

    _zero_counts()
    k_new, k_m, k_loss = run(cfg, params)
    counts = _counts()
    check(counts == _per_step(cfg.num_layers, remat=True),
          f"kernel path launches {counts}")
    with plain_path():
        p_new, p_m, p_loss = run(cfg, params)
        cfg64 = cfg.with_(param_dtype="float64", activation_dtype="float64")
        p64 = {k: tree_map(lambda t: t.double(), v)
               for k, v in params.items()}
        _, m64, loss64 = run(cfg64, p64)
        del p64
    check(_counts() == counts, "the plain path launched a kernel")
    scale_m = _max_abs(p_m)
    floor_loss, floor_m = abs(p_loss - loss64), _max_abs(p_m, m64)
    err_loss, err_m = abs(k_loss - p_loss), _max_abs(k_m, p_m)
    tol_loss = max(4 * floor_loss, 1e-5 * abs(p_loss))
    tol_m = max(4 * floor_m, 1e-5 * scale_m)
    print(f"f32 4-layer step, wq/wk x {qk_scale} ("
          f"{'checked' if checked else 'report only'}): loss kernel "
          f"{k_loss:.6f} plain {p_loss:.6f} (f64 {loss64:.6f}): err "
          f"{err_loss:.3e} (tol {tol_loss:.3e}); m = 0.1 g: max|m| "
          f"{scale_m:.3e}, err {err_m:.3e} (tol {tol_m:.3e}; plain f32 vs "
          f"f64 {floor_m:.3e})")
    blocks = []
    for i, (km, pm, qm) in enumerate(zip(k_m["blocks"], p_m["blocks"],
                                         m64["blocks"])):
        blk = dict(block=i, max_m=_max_abs(pm), err_m=_max_abs(km, pm),
                   floor_m=_max_abs(pm, qm))
        blk["tol_m"] = max(4 * blk["floor_m"], 1e-5 * blk["max_m"])
        blocks.append(blk)
        print(f"  block {i}: max|m| {blk['max_m']:.3e}, err "
              f"{blk['err_m']:.3e} (tol {blk['tol_m']:.3e} = "
              f"{blk['tol_m'] / blk['max_m']:.2%} of max|m|; plain f32 vs "
              f"f64 {blk['floor_m']:.3e})")
    worst, n_ok, n_all = 0.0, 0, 0
    for kn, pn, po, pm in zip(*(tree_leaves(t) for t in
                                (k_new, p_new, params["lora"], p_m))):
        firm = pm.abs() > 4 * err_m          # |g| above 4 x its error
        d = ((kn - po) - (pn - po)).abs()[firm]
        worst = max(worst, d.max().item() if d.numel() else 0.0)
        n_ok += int(firm.sum())
        n_all += pm.numel()
    print(f"updated LoRA: max |delta_kernel - delta_plain| {worst:.3e} over "
          f"the {n_ok}/{n_all} ({n_ok / n_all:.1%}) entries whose gradient "
          f"is firm (tol {1e-3 * lr:.3e})")
    check(np.isfinite(k_loss), "loss not finite")
    if checked:
        check(err_loss <= tol_loss, f"loss: {err_loss:.3e} > {tol_loss:.3e}")
        check(err_m <= tol_m, f"gradients (m): {err_m:.3e} > {tol_m:.3e}")
        for blk in blocks:
            check(blk["err_m"] <= blk["tol_m"],
                  f"block {blk['block']} gradients (m): {blk['err_m']:.3e} "
                  f"> {blk['tol_m']:.3e}")
        b0 = blocks[0]
        check(b0["tol_m"] <= 0.1 * b0["max_m"],
              f"block 0: tol {b0['tol_m']:.3e} is over a tenth of max|m| "
              f"{b0['max_m']:.3e}; the check would not see a wrong channel "
              f"backward")
        check(worst <= 1e-3 * lr, f"updated LoRA: {worst:.3e}")
    del params, k_new, p_new
    torch.cuda.empty_cache()
    return dict(qk_scale=qk_scale, checked=checked, loss_kernel=k_loss,
                loss_plain=p_loss, loss_f64=loss64, err_loss=err_loss,
                tol_loss=tol_loss, err_m=err_m, tol_m=tol_m, max_m=scale_m,
                plain_f32_vs_f64_m=floor_m, blocks=blocks,
                lora_delta_err=worst, firm_share=n_ok / n_all,
                launches=counts)


def train_parity_phase():
    """One ``make_train_step`` step of full-width olmo-1b, f32, 4 layers
    (elsa_boundaries (1, 1): two real cuts), on the launcher's first batch
    and channel: the kernel path against the plain path (autograd through
    the plain versions).  The tolerance is set by the plain path's own f32
    error, measured against the plain path in f64 on the same weights: the
    kernel path must agree with the plain path to 4x that error, or 1e-5
    of the scale (f32 sums of 2,048 products in another order), in the
    loss and in AdamW's first moment m (0.1 x the LoRA gradient), over the
    whole tree and in each block against that block's own error and scale.
    Block 0's gradient is the only one that crosses both cuts, each cut's
    SS-OP, SS-OPᵀ, scatter and gather backwards, so its tolerance must stay
    within a tenth of its scale.  The updated LoRA moves by about lr x
    sign(g) at step 1, so it must agree to 1e-3 x lr wherever |g| is above
    4x the gradients' own disagreement; the share of such entries is
    reported.

    Checked with wq and wk scaled by 0.1 (soft attention).  At the init
    (wq's fan-in is its head count, so attention scores reach ~100) the
    plain path's own f32 error is several percent of the gradient's scale,
    so 4x it leaves little to check: that case is reported, not checked."""
    return {"soft_attention": _train_parity(0.1, checked=True),
            "init": _train_parity(1.0, checked=False)}


# ---------------------------------------------------------------------------
# 8. training through the launcher
# ---------------------------------------------------------------------------

def train_phase(steps=20):
    """``python -m repro_torch.launch.train --arch olmo-1b --full --elsa``
    for ``steps`` steps of its batch stream, each step logged (so each ends
    in a device sync and has its own host-clock time)."""
    from repro_torch.checkpoint import restore_state, tree_equal
    cfg = get_config("olmo-1b")
    ckpt = os.path.join(OUT_DIR, "train_lora.msgpack")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()                                   # the main path starts
    out = train._main(["--arch", "olmo-1b", "--full", "--elsa", "--steps",
                       str(steps), "--log-every", "1", "--device", "cuda",
                       "--ckpt", ckpt])
    counts = _counts()                               # the main path ends
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.time()
    state = restore_state(ckpt)
    restore_s = time.time() - t0
    check(state["step"] == steps and tree_equal(state["params"],
                                                {"lora": out["lora"]}),
          "--ckpt: the restored LoRA tree is not the trained one bitwise")
    ckpt_bytes = os.path.getsize(ckpt)
    os.unlink(ckpt)
    losses = [l for _, l in out["losses"]]
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"losses {losses}")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    check(last < first, f"loss did not fall: first 5 {first:.4f}, last 5 "
                        f"{last:.4f}")
    want = {k: steps * v for k, v in
            _per_step(cfg.num_layers, remat=True).items()}
    check(counts == want, f"launches {counts} != {want}")
    step_s = statistics.median(out["step_s"][1:])
    tokens = 8 * 64
    print(f"training: {steps} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}"
          f" (mean of first 5 {first:.4f}, last 5 {last:.4f}); step "
          f"{step_s * 1e3:.1f} ms (median of steps 2-{steps}, first "
          f"{out['step_s'][0] * 1e3:.1f} ms) -> {tokens / step_s:.0f} "
          f"tokens/s; peak memory {peak:.2f} GiB; launches per step "
          f"{ {k: v // steps for k, v in counts.items()} }")
    print(f"  --ckpt: {ckpt_bytes} bytes, restored in {restore_s:.3f}s, "
          f"every LoRA leaf bitwise the trained tree's")
    return dict(steps=steps, losses=losses, step_ms=step_s * 1e3,
                ckpt_bytes=ckpt_bytes, ckpt_restore_s=restore_s,
                first_step_ms=out["step_s"][0] * 1e3,
                tokens_per_s=tokens / step_s, peak_gib=peak,
                launches=counts,
                launches_per_step={k: v // steps for k, v in counts.items()}
                ), counts


def step0_phase(phase8_loss):
    """The launcher's step-0 forward (phase 8's configuration: full olmo-1b,
    bf16, ``--elsa``, the seed-0 init, its first batch) on four paths: the
    kernels as the shapes route them (the tile kernel at T 512), the decode
    kernels forced for every projection (the route of T 512 before the
    tile kernels), the plain LoRA projection beside the other kernels, and
    the plain path; each held against the plain path in f32.  Every LoRA B
    is zero at the init, so each projection is x W rounded once: the four
    bf16 paths differ only in how their sums round, which 16 layers of
    attention at the init (scores of ~100) then amplify.  Reports each
    loss, and each path's logits' mean and largest distance from the f32
    logits; the kernel path's mean distance must stay within 1.2 x the
    decode route's."""
    cfg = get_config("olmo-1b")
    model = zoo.get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tree = init_tree(model.specs(cfg), gen, cfg.dtype(), "cuda")
    _, z = train.elsa_channel_specs(cfg)
    chp = train.channel_params(cfg, z, "cuda")
    batch = next(train.batch_stream(cfg, 8, 64, "cuda"))

    def forward(c, t):
        ch = Channel(SSOP(chp["u"], chp["v"]),
                     SketchPlan(chp["bucket"], chp["sign"], z))
        with torch.no_grad():
            logits, aux = model.forward(
                c, t["frozen"], t["lora"], batch, window=0, chunk=2048,
                remat=True, boundaries=train.elsa_boundaries(c), channel=ch)
            loss = float(zoo.loss_fn(c, logits, batch["tokens"], aux))
        return logits[..., :cfg.vocab_size].float(), loss

    runs = {"kernels": forward(cfg, tree)}
    saved = common.lora_matmul
    for name, fn in (("decode kernels forced", lambda x, w, a, b, s:
                      lora_ops._launch(x, w, a, b, s, route="decode")),
                     ("plain LoRA", lora_matmul_ref)):
        common.lora_matmul = fn
        try:
            runs[name] = forward(cfg, tree)
        finally:
            common.lora_matmul = saved
    with plain_path():
        runs["plain path"] = forward(cfg, tree)
        cfg32 = cfg.with_(param_dtype="float32", activation_dtype="float32")
        ref, ref_loss = forward(cfg32, {k: tree_map(lambda t: t.float(), v)
                                        for k, v in tree.items()})
    print(f"olmo-1b step 0 (bf16, T 512, every B zero): plain path in f32 "
          f"loss {ref_loss:.4f}; phase 8 logged {phase8_loss:.4f}")
    out = {"f32 plain path": dict(loss=ref_loss)}
    for name, (logits, loss) in runs.items():
        d = (logits - ref).abs()
        out[name] = dict(loss=loss, mean_logit_err=d.mean().item(),
                         max_logit_err=d.max().item())
        print(f"  {name:22s} loss {loss:.4f}; logits against f32: mean "
              f"{out[name]['mean_logit_err']:.4e}, max "
              f"{out[name]['max_logit_err']:.4e}", flush=True)
        check(np.isfinite(loss), f"{name}: loss {loss}")
    check(out["kernels"]["mean_logit_err"]
          <= 1.2 * out["decode kernels forced"]["mean_logit_err"],
          f"step-0 logits: the kernel path lies further from f32 than 1.2 x "
          f"the decode route: {out}")
    del tree, runs, ref
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 9. where a training step's time goes
# ---------------------------------------------------------------------------

def train_profile_phase(n_wall=5):
    """One training step of the launcher's configuration under
    ``torch.profiler`` for the device time of each kernel; the wall time is
    the median of ``n_wall`` unprofiled steps, each ending in a sync.  Idle
    share = 1 - device busy / wall.  The channel is the launcher's, with the
    sketch's plan built once; what a step builds of it, and what building
    the plan costs, are timed apart."""
    cfg = get_config("olmo-1b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_tree(zoo.get_model(cfg).specs(cfg), gen, cfg.dtype(),
                       "cuda")
    _, z = train.elsa_channel_specs(cfg)
    ch = train.channel_params(cfg, z, "cuda")
    ch["plan"] = SketchPlan(ch["bucket"], ch["sign"], z)
    stream = train.batch_stream(cfg, 8, 64, "cuda")
    opt = AdamW(lr=3e-3)
    step = train.make_train_step(cfg, optimizer=opt, elsa_z=z)
    lora, state = params["lora"], opt.init(params["lora"])

    def one():
        nonlocal lora, state
        lora, state, loss = step(params["frozen"], lora, state,
                                 {**next(stream), "_channel": ch})
        loss.item()

    for _ in range(2):                                # warm-up
        one()
    # what make_train_step builds of the channel a step, and the plan
    build_ms = _build_ms(lambda: Channel(SSOP(ch["u"], ch["v"]), ch["plan"]))
    plan_ms = _build_ms(lambda: SketchPlan(ch["bucket"], ch["sign"], z))
    walls = []
    for _ in range(n_wall):
        t0 = time.time()
        one()
        walls.append((time.time() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    bd = device_breakdown(one, trace=os.path.join(OUT_DIR,
                                                  "train_trace.json"))
    rows, busy_ms = bd["rows"], bd["busy_ms"]
    print(f"profile (olmo-1b, batch 8 x 64, --elsa, one step): wall "
          f"{wall_ms:.2f} ms without the profiler (steps {walls}), device "
          f"busy {busy_ms:.2f} ms -> idle share {1 - busy_ms / wall_ms:.1%}, "
          f"{sum(r[1] for r in rows):.0f} kernels; building the channel "
          f"{build_ms:.4f} ms a step, its sketch plan {plan_ms:.3f} ms once "
          f"(medians of 20)")
    ours = _our_kernels_ms(rows)
    print(f"  the port's kernels, ms a step: {ours}")
    del params, lora, state
    torch.cuda.empty_cache()
    return dict(wall_ms=wall_ms, walls_ms=walls, device_busy_ms=busy_ms,
                breakdown=bd,
                channel_build_ms=build_ms, plan_build_ms=plan_ms,
                idle_share=1 - busy_ms / wall_ms,
                kernels=sum(r[1] for r in rows),
                our_kernels_ms=ours,
                top_kernels=[dict(ms=us / 1e3, count=n, name=key)
                             for us, n, key in rows[:15]])


def _build_ms(build, n=20):
    """Median host time of ``n`` calls of ``build``, each from and to a
    synced device."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.time()
        build()
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# 10. the federation
# ---------------------------------------------------------------------------

def _bert_full(num_layers=None, dtype=None, **overrides):
    """bert-base at full width (d 768, 12 heads, vocab 30522), through the
    registry's factory hook: ``Federation`` itself always reduces."""
    cfg = get_config("bert-base").with_(**overrides)
    if num_layers is not None:
        cfg = cfg.with_(num_layers=num_layers)
    if dtype is not None:
        cfg = cfg.with_(param_dtype=dtype, activation_dtype=dtype)
    return BertSplitModel(cfg)


def _bert_fed_config():
    # clip_norm: at full width the split model's gradient grows ~10x per
    # block towards the input (LoRA q_b's norm 8e10 at block 0 at the
    # init), so unclipped steps at lr 2e-2 reach NaN by the third warm-up
    # step; the JAX package's convergence stack clips for this reason.
    # constrained_frac: two of the 8 devices throttled (compute and uplink),
    # the paper's heterogeneous setup, which gives phase 13's deadline
    # policy its stragglers
    register_split_model("bert-base-full", _bert_full)
    return FedConfig(model="bert-base-full", layers=12, n_clients=8,
                     n_edges=2, poisoned=(3,), total_examples=1600,
                     batch_size=16, seq_len=128, probe_q=32,
                     local_warmup_steps=4, t_rounds=1, lr=2e-2,
                     clip_norm=1.0, constrained_frac=0.25)


def _syncs_of(fn):
    """``fn()`` with CUDA's sync debug mode on: its result, and where each
    host sync it made came from: the line that synced and, when that is
    not the port's, the port's innermost line on the stack.  The syncs
    this script makes to time a step are left out."""
    found = []

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()
                  if not f.filename.endswith("warnings.py")][:-1]
        ours = [f for f in frames if f.filename.startswith(ROOT)]
        if ours and ours[-1].filename == os.path.abspath(__file__):
            return                          # the script's own timing sync
        where = [frames[-1]] + ([ours[-1]] if ours and ours[-1]
                                is not frames[-1] else [])
        found.append(" <- ".join(
            f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} ({f.line})"
            for f in where))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, found


def _count_run_clients(engine, per_step, calls):
    """Wrap ``engine.run_clients`` so that each call records its wall (it
    ends in the losses' transfer, a sync), its kernels' launches, which
    must be exactly members x steps x ``per_step``, and its host syncs,
    into ``calls``.  Returns the unwrapped method."""
    run = engine.run_clients

    def counted(theta, clients, splits, channels, batches, **kw):
        steps = len(batches[clients[0]])
        c0, t0 = _counts(), time.time()
        out, syncs = _syncs_of(lambda: run(theta, clients, splits, channels,
                                           batches, **kw))
        ms = (time.time() - t0) * 1e3
        launches = {k: v - c0[k] for k, v in _counts().items()}
        want = {k: v * len(clients) * steps for k, v in per_step.items()}
        check(launches == want,
              f"run_clients of {len(clients)} clients x {steps} steps "
              f"launched {launches}, not {want}")
        calls.append(dict(clients=[int(n) for n in clients], steps=steps,
                          ms=ms, client_step_ms=ms / (len(clients) * steps),
                          buckets=len({splits[n] for n in clients}),
                          launches=launches, syncs=syncs))
        return out
    engine.run_clients = counted
    return run


def _memory_base():
    """The bytes allocated before a federation is built, with the peak
    reset there: the federation's own peak is the peak above them."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _peak_gib(base):
    """The peak allocated since :func:`_memory_base` above ``base``."""
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def _record_assign(fed, assigned):
    assign = fed._assign_groups

    def recorded(method, rng):
        out = assign(method, rng)
        assigned.append(out)
        return out
    fed._assign_groups = recorded


def _counted_run(fed, per_step, rounds=2, steps=4, **run_kw):
    """``fed.run("elsa", ...)`` with every ``run_clients`` call counted (its
    launches exactly members x steps x ``per_step``, its wall and host
    syncs), the kernels' counts zeroed just before and read just after.
    Returns (history, wall s, counts, calls)."""
    calls = []
    run = _count_run_clients(fed.engine, per_step, calls)
    _zero_counts()                                   # the main path starts
    t0 = time.time()
    try:
        hist = fed.run("elsa", global_rounds=rounds, steps_per_round=steps,
                       **run_kw)
    finally:
        fed.engine.run_clients = run
    wall = time.time() - t0
    counts = _counts()                               # the main path ends
    losses = [l for ls in hist["client_losses"].values() for l in ls]
    check(len(losses) > 0 and all(np.isfinite(losses))
          and all(np.isfinite(hist["loss"])), f"losses {hist['loss']}")
    syncs = [len(c["syncs"]) for c in calls]
    check(all(x == 1 for x in syncs),
          f"host syncs a run_clients call {syncs}: "
          f"{[c['syncs'] for c in calls]}")
    return hist, wall, counts, calls


def _run_federation(fed, rounds, steps):
    """The main path: ``fed.run("elsa")`` counted by :func:`_counted_run`,
    its edge assignment recorded.  Returns (history, wall s, counts,
    calls, assigned groups)."""
    assigned = []
    _record_assign(fed, assigned)
    hist, wall, counts, calls = _counted_run(
        fed, _per_step(fed.cfg.num_layers, remat=False), rounds, steps)
    check(len(hist["accuracy"]) == rounds, f"history {hist}")
    check(all(v > 0 for v in counts.values()), f"launches {counts}")
    warm = fed.fed.n_clients * fed.fed.local_warmup_steps
    check(calls[0]["steps"] * len(calls[0]["clients"]) == warm,
          f"warm-up call {calls[0]}")
    return hist, wall, counts, calls, assigned[0]


def _step_ms(calls):
    """The wall a client step over ``calls``: their total wall over their
    client steps."""
    return sum(c["ms"] for c in calls) / sum(
        len(c["clients"]) * c["steps"] for c in calls)


def _round_walls(calls):
    """The wall a client step over the rounds' ``run_clients`` calls (the
    first call is the warm-up), and each call's."""
    return _step_ms(calls[1:]), [c["client_step_ms"] for c in calls[1:]]


def federation_phase():
    """``Federation(FedConfig(model="bert-base-full", ...)).run("elsa",
    global_rounds=2, steps_per_round=4)`` on the card in f32 on the default
    (batched) backend, each client step clipped to a global norm of 1.
    Every ``run_clients`` call (the warm-up, then one an edge group and
    round) must launch each kernel real members x steps x what a client
    step implies (4 LoRA projections and one flash attention per block, the
    channel's 16 launches at its two cuts); its wall and host syncs are
    recorded.  Then where a batched client step's time goes: one
    ``run_clients`` call of every assigned client for one step."""
    fed_cfg = _bert_fed_config()
    base = _memory_base()
    fed = Federation(fed_cfg, device="cuda")
    cfg = fed.cfg
    check(fed.backend == "batched", f"default backend {fed.backend}")
    check((cfg.d_model, cfg.num_heads, cfg.num_layers, cfg.vocab_size)
          == (768, 12, 12, 30522), f"not full width: {cfg}")
    hist, wall, counts, calls, (groups, div, trust) = _run_federation(
        fed, rounds=2, steps=4)
    peak = _peak_gib(base)
    members = sorted(n for g in groups.values() for n in g)
    excluded = [n for n in range(fed_cfg.n_clients) if n not in members]
    step_ms, call_ms = _round_walls(calls)
    syncs = [len(c["syncs"]) for c in calls]
    print(f"federation, batched (bert-base full width, f32, 8 clients, 2 "
          f"edges): groups { {k: v for k, v in groups.items() if v} }, "
          f"excluded {excluded}, trust {np.round(trust, 3).tolist()}")
    print(f"  history: accuracy {hist['accuracy']}, loss "
          f"{[round(x, 4) for x in hist['loss']]}, delta "
          f"{[f'{x:.3e}' for x in hist['delta']]}")
    for c in calls:
        print(f"  run_clients: {len(c['clients'])} clients x {c['steps']} "
              f"steps, {c['buckets']} split buckets, {c['ms']:.1f} ms "
              f"({c['client_step_ms']:.2f} ms a client step), host syncs "
              f"{c['syncs']}")
    print(f"  run {wall:.1f}s; rounds: {step_ms:.2f} ms a client step "
          f"(16 x 128 tokens); launches in the run {counts}; peak memory "
          f"{peak:.2f} GiB (above the {base / 2 ** 30:.2f} GiB held before); "
          f"host syncs a run_clients call {syncs}")

    # where a batched client step's time goes: every assigned client, one
    # step from the final theta, each on its first 16 examples
    splits = {n: fed.split_for(n) for n in members}
    channels = {n: fed.channel_for(n, fed.lora0) for n in members}
    batches = {n: [(fed.data[n].tokens[:16], fed.data[n].labels[:16])]
               for n in members}

    def one():
        fed.engine.run_clients(fed.last_theta, members, splits, channels,
                               batches)

    one()
    walls = []
    for _ in range(5):
        t0 = time.time()
        one()
        walls.append((time.time() - t0) * 1e3 / len(members))
    _, prof_syncs = _syncs_of(one)
    prof_wall = statistics.median(walls)
    print(f"  profile of one run_clients call ({len(members)} clients x 1 "
          f"step), per client step:")
    bd = device_breakdown(one, per=len(members), trace=os.path.join(
        OUT_DIR, "federation_batched_trace.json"))
    rows, busy = bd["rows"], bd["busy_ms"]
    print(f"  wall {prof_wall:.2f} ms a client step without the profiler "
          f"(calls {[round(w, 1) for w in walls]}), device busy {busy:.2f} "
          f"ms -> idle share {1 - busy / prof_wall:.1%}, "
          f"{sum(r[1] for r in rows):.0f} kernels; host syncs of the call "
          f"{prof_syncs}")
    print(f"  the port's kernels, ms a client step: {_our_kernels_ms(rows)}")
    counted, _ = op_cost.count(one)       # the same call's work (phase 18e)
    out = dict(backend=fed.backend,
               groups={str(k): v for k, v in groups.items()},
               excluded=excluded, trust=list(map(float, trust)),
               round=hist["round"], accuracy=hist["accuracy"],
               loss=hist["loss"], delta=hist["delta"],
               client_losses=hist["client_losses"], run_s=wall,
               step_ms=step_ms,
               step_ms_calls=call_ms, calls=calls, syncs_per_call=syncs,
               launches_per_step={k: v // (len(calls[-1]["clients"])
                                           * calls[-1]["steps"])
                                  for k, v in calls[-1]["launches"].items()},
               launches=counts, peak_gib=peak, base_gib=base / 2 ** 30,
               profile=dict(
                   clients=len(members), wall_ms=prof_wall, walls_ms=walls,
                   device_busy_ms=busy, idle_share=1 - busy / prof_wall,
                   breakdown=bd, counted=dict(
                       flops=counted.cost.flops / len(members),
                       bytes=counted.cost.bytes / len(members),
                       kernels=counted.kernels),
                   syncs=prof_syncs, kernels=sum(r[1] for r in rows),
                   our_kernels_ms=_our_kernels_ms(rows),
                   top_kernels=[dict(ms=us / 1e3, count=c, name=key)
                                for us, c, key in rows[:15]]))
    return fed, out, counts


def federation_reference_phase():
    """Phase 10's federation on ``backend="reference"``: the sequential
    loop, one client at a time.  Every gradient step (warm-up and rounds)
    is wrapped to read the kernels' counts before and after it: each must
    launch what its split implies.  The probe and evaluation forwards
    launch too, outside the steps.  Then where one client step's time
    goes."""
    fed_cfg = _bert_fed_config()
    base = _memory_base()
    fed = Federation(fed_cfg, backend="reference", device="cuda")
    cfg = fed.cfg
    check((cfg.d_model, cfg.num_heads, cfg.num_layers, cfg.vocab_size)
          == (768, 12, 12, 30522), f"not full width: {cfg}")
    steps, assigned = [], []
    grad_fn = fed._grad_fn

    def counted_grad_fn(client, split):
        gfn = grad_fn(client, split)

        def step(*args):
            c0, t0 = _counts(), time.time()
            out = gfn(*args)
            torch.cuda.synchronize()
            steps.append(dict(client=client, split=(split.p, split.q,
                                                    split.o),
                              ms=(time.time() - t0) * 1e3,
                              launches={k: v - c0[k]
                                        for k, v in _counts().items()}))
            return out
        return step

    group_steps, rounds = fed.group_steps, []

    def counted_group_steps(clients, theta, n_steps, iters, **kw):
        out, syncs = _syncs_of(lambda: group_steps(clients, theta, n_steps,
                                                   iters, **kw))
        rounds.append(dict(clients=len(clients), steps=n_steps,
                           syncs=len(syncs)))
        return out

    fed._grad_fn, fed.group_steps = counted_grad_fn, counted_group_steps
    _record_assign(fed, assigned)
    _zero_counts()                                   # the main path starts
    t0 = time.time()
    hist = fed.run("elsa", global_rounds=2, steps_per_round=4)
    wall = time.time() - t0
    counts = _counts()                               # the main path ends
    peak = _peak_gib(base)
    groups, div, trust = assigned[0]
    members = sorted(n for g in groups.values() for n in g)
    per_step = _per_step(cfg.num_layers, remat=False)
    for st_ in steps:
        check(st_["launches"] == per_step,
              f"client {st_['client']} step launched {st_['launches']}, "
              f"not {per_step}")
    check(all(v > 0 for v in counts.values()), f"launches {counts}")
    losses = [l for ls in hist["client_losses"].values() for l in ls]
    check(len(losses) > 0 and all(np.isfinite(losses))
          and all(np.isfinite(hist["loss"])), f"losses {hist['loss']}")
    check(len(hist["accuracy"]) == 2, f"history {hist}")
    warm = fed_cfg.n_clients * fed_cfg.local_warmup_steps
    round_ms = [st_["ms"] for st_ in steps[warm:]]
    step_ms = statistics.median(round_ms)
    print(f"federation, reference backend: groups "
          f"{ {k: v for k, v in groups.items() if v} }, trust "
          f"{np.round(trust, 3).tolist()}")
    print(f"  history: accuracy {hist['accuracy']}, loss "
          f"{[round(x, 4) for x in hist['loss']]}, delta "
          f"{[f'{x:.3e}' for x in hist['delta']]}")
    print(f"  {len(steps)} client steps ({warm} warm-up), "
          f"{step_ms:.1f} ms a client step (forward + backward, median of "
          f"the {len(round_ms)} round steps; 16 x 128 tokens), run "
          f"{wall:.1f}s; launches per client step {steps[-1]['launches']}; "
          f"in the run "
          f"{counts}; peak memory {peak:.2f} GiB (above the "
          f"{base / 2 ** 30:.2f} GiB held before); host syncs a round's "
          f"group_steps call (clients x steps: syncs) "
          f"{[(r['clients'], r['steps'], r['syncs']) for r in rounds]}")

    # where a client step's time goes: one step of the first member (its
    # split and channel, its first batch, the final theta), the wall the
    # median of 5 unprofiled steps, each ending in a sync
    n = members[0] if members else 0
    gfn = grad_fn(n, fed.split_for(n))
    ch = fed.channel_for(n, fed.lora0)
    batch = {"tokens": fed._tokens(fed.data[n].tokens[:16]),
             "labels": torch.from_numpy(fed.data[n].labels[:16]).cuda()}

    def one():
        gfn(fed.last_theta, batch, ch)[0].item()

    one()
    walls = []
    for _ in range(5):
        t0 = time.time()
        one()
        walls.append((time.time() - t0) * 1e3)
    prof_wall = statistics.median(walls)
    print(f"  profile of one client step (client {n}, split "
          f"{fed.split_for(n)}):")
    bd = device_breakdown(one, trace=os.path.join(
        OUT_DIR, "federation_step_trace.json"))
    rows, busy = bd["rows"], bd["busy_ms"]
    print(f"  wall {prof_wall:.2f} ms without the profiler (steps "
          f"{[round(w, 1) for w in walls]}), device busy {busy:.2f} ms -> "
          f"idle share {1 - busy / prof_wall:.1%}, "
          f"{sum(r[1] for r in rows):.0f} kernels")
    print(f"  the port's kernels, ms a client step: {_our_kernels_ms(rows)}")
    out = dict(backend=fed.backend,
               groups={str(k): v for k, v in groups.items()},
               trust=list(map(float, trust)),
               accuracy=hist["accuracy"], loss=hist["loss"],
               delta=hist["delta"], client_steps=len(steps),
               warmup_steps=warm, step_ms=step_ms, step_ms_all=round_ms,
               run_s=wall, launches_per_step=steps[-1]["launches"],
               launches=counts, round_calls=rounds,
               peak_gib=peak, base_gib=base / 2 ** 30, profile=dict(
                   wall_ms=prof_wall, walls_ms=walls, device_busy_ms=busy,
                   idle_share=1 - busy / prof_wall,
                   kernels=sum(r[1] for r in rows),
                   our_kernels_ms=_our_kernels_ms(rows),
                   top_kernels=[dict(ms=us / 1e3, count=c, name=key)
                                for us, c, key in rows[:15]]))
    return fed, out, counts


def cross_backend_phase(fed, fed_r):
    """One local step at the training lr on both backends, from ``lora0``
    with the same batches (iterators of the same seeds), for the clients
    of the run's first bucket (the warm-up's: every client, on the default
    split): ``group_steps`` on the batched federation against
    ``client_steps`` on the reference one.  The two federations are built
    from the same seed, and each builds its own channels (the batched
    backend through its shared probe forward): they must be bit-equal.
    Losses must agree to 1e-6 relative and each updated LoRA leaf to 1e-5
    of that leaf's scale."""
    for a, b in ((fed.lora0, fed_r.lora0), (fed.frozen, fed_r.frozen)):
        check(all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                     tree_leaves(b))),
              "the two federations' weights differ")
    bucket = list(range(fed.fed.n_clients))
    split = fed.split_for(0, use_split=False)
    channels_equal = all(
        torch.equal(x, y) for n in bucket
        for x, y in zip(fed.channel_for(n, fed.lora0).ssop,
                        fed_r.channel_for(n, fed_r.lora0).ssop))
    check(channels_equal, "the backends' channels differ")

    def its(f):
        return {n: infinite_batches(f.data[n].tokens, f.data[n].labels,
                                    f.fed.batch_size, seed=777 + n)
                for n in bucket}

    got = fed.group_steps(bucket, fed.lora0, 1, its(fed), use_split=False)
    it_r = its(fed_r)
    want = {n: fed_r.client_steps(n, fed_r.lora0, 1, it_r[n],
                                  use_split=False)
            for n in bucket}
    loss_err, leaf_err, bit_equal = 0.0, 0.0, True
    for n in bucket:
        (lb, sb), (lr_, sr) = got[n], want[n]
        loss_err = max(loss_err, abs(sb - sr) / abs(sr))
        for a, b in zip(tree_leaves(lb), tree_leaves(lr_)):
            leaf_err = max(leaf_err, (a - b).abs().max().item()
                           / b.abs().max().item())
            bit_equal &= torch.equal(a, b)
        bit_equal &= sb == sr
    print(f"one step at lr {fed.fed.lr} on both backends, clients {bucket} "
          f"(split {split}): largest loss difference {loss_err:.3e} "
          f"relative (tol 1e-6), largest leaf difference {leaf_err:.3e} of "
          f"the leaf's scale (tol 1e-5); bit-equal: {bit_equal}; the "
          f"backends' channels bit-equal: {channels_equal}")
    check(loss_err <= 1e-6, f"loss {loss_err:.3e}")
    check(leaf_err <= 1e-5, f"leaf {leaf_err:.3e}")
    return dict(clients=bucket, split=[split.p, split.q, split.o],
                lr=fed.fed.lr, loss_rel_err=loss_err,
                leaf_rel_err=leaf_err, bit_equal=bool(bit_equal),
                channels_equal=bool(channels_equal))


# ---------------------------------------------------------------------------
# 13. the event runtime
# ---------------------------------------------------------------------------

def _trace_consistent(trace, n_clients, rounds_run):
    """The event trace's bookkeeping: per client, in the order the
    scheduler logged them, each arrival or crash follows a dispatch of that
    client no later in simulated time, so arrivals plus crashes never
    outnumber dispatches; one cloud aggregation per round run."""
    sent, done, last = [0] * n_clients, [0] * n_clients, [None] * n_clients
    for t, kind, client, _, _ in trace.records:
        if kind == "dispatch":
            sent[client] += 1
            last[client] = t
        elif kind in ("arrival", "crash"):
            done[client] += 1
            check(done[client] <= sent[client] and last[client] is not None
                  and last[client] <= t,
                  f"client {client}: {kind} at {t} without a dispatch before "
                  f"it ({done[client]} done, {sent[client]} sent)")
    check(trace.count("cloud_agg") == rounds_run,
          f"{trace.count('cloud_agg')} cloud aggregations in {rounds_run} "
          f"rounds")
    return sent, done


def runtime_phase(fed, phase10, rounds=2, steps=4):
    """Phase 10's federation on the event-driven edge runtime:
    ``fed.run("elsa", runtime=RuntimeConfig(policy=p))`` for 2 rounds of 4
    local steps.  ``sync`` with no churn must reproduce phase 10's history
    bit for bit (round, accuracy, loss, delta, client losses) with a
    strictly increasing simulated clock.  ``deadline`` and ``async`` run
    under the JAX package's churn trace (``tests/test_runtime.py``'s
    ``_churny_config``) and a fault trace over half the clients (crash,
    drop, dup and corrupt at 0.1 each; sign-flipped and scaled updates).
    Every ``run_clients`` call must launch each kernel real members x steps
    x a client step's count and make one host sync; the event trace must
    be consistent and every loss finite.  The kernels' counts are zeroed
    just before each run and read just after it."""
    n = fed.fed.n_clients
    churn = make_churn_trace(n, 10_000.0, mean_on_s=40.0, mean_off_s=15.0,
                             churn_frac=0.5, seed=2)
    faults = make_fault_trace(n, faulty_frac=0.5, crash_rate=0.1,
                              drop_rate=0.1, dup_rate=0.1, corrupt_rate=0.1,
                              corrupt_modes=("signflip", "scale"), seed=3)
    per_step = _per_step(fed.cfg.num_layers, remat=False)
    out, launches = {}, {k: 0 for k in _counts()}
    for policy, kw in (("sync", {}),
                       ("deadline", dict(churn=churn, faults=faults)),
                       ("async", dict(churn=churn, faults=faults))):
        base = _memory_base()
        hist, wall, counts, calls = _counted_run(
            fed, per_step, rounds, steps,
            runtime=RuntimeConfig(policy=policy, **kw))
        peak = _peak_gib(base)
        launches = {k: launches[k] + v for k, v in counts.items()}
        trace = hist["trace"]
        check(hist["policy"] == policy and len(hist["round"]) >= 1,
              f"{policy}: history {hist['round']}")
        sent, done = _trace_consistent(trace, n, len(hist["round"]))
        syncs = [len(c["syncs"]) for c in calls]
        warm = calls[0]
        check(len(warm["clients"]) * warm["steps"]
              == n * fed.fed.local_warmup_steps, f"warm-up call {warm}")
        rounds_calls = calls[1:]
        cohort = [len(c["clients"]) for c in rounds_calls]
        step_ms = _step_ms(rounds_calls)
        if policy == "sync":
            for key in ("round", "accuracy", "loss", "delta"):
                check(hist[key] == phase10[key],
                      f"sync: {key} {hist[key]} is not phase 10's "
                      f"{phase10[key]}")
            check(hist["client_losses"] == phase10["client_losses"],
                  "sync: the client losses are not phase 10's")
            t = hist["time"]
            check(all(b > a for a, b in zip(t, t[1:])), f"sync: time {t}")
        print(f"runtime {policy}: rounds {hist['round']}, simulated time "
              f"{[round(x, 3) for x in hist['time']]} s (trace ends at "
              f"{trace.end_time():.3f} s), accuracy {hist['accuracy']}, "
              f"loss {[round(x, 4) for x in hist['loss']]}, delta "
              f"{[f'{x:.3e}' for x in hist['delta']]}")
        print(f"  trace {trace.summary()}; dispatches a client {sent}, "
              f"arrivals and crashes {done}")
        print(f"  {len(rounds_calls)} run_clients calls after the warm-up, "
              f"cohorts {cohort} (mean {statistics.mean(cohort):.2f}), "
              f"{step_ms:.2f} ms a client step (calls "
              f"{[round(c['client_step_ms'], 1) for c in rounds_calls]}); "
              f"host syncs a call {syncs}; run {wall:.1f}s; launches "
              f"{counts}; peak memory {peak:.2f} GiB above the "
              f"{base / 2 ** 30:.2f} GiB held before")
        out[policy] = dict(
            round=hist["round"], time=hist["time"],
            accuracy=hist["accuracy"], loss=hist["loss"],
            delta=hist["delta"], trace_summary=trace.summary(),
            trace_end_s=trace.end_time(), dispatches=sent,
            arrivals_and_crashes=done, calls=calls,
            calls_after_warmup=len(rounds_calls), cohorts=cohort,
            mean_cohort=statistics.mean(cohort), step_ms=step_ms,
            syncs_per_call=syncs, run_s=wall, launches=counts,
            peak_gib=peak, base_gib=base / 2 ** 30)
    return out, launches


# ---------------------------------------------------------------------------
# 14. update screening
# ---------------------------------------------------------------------------

def _stats_f64(base, trees, weights):
    """The screening statistics recomputed on the CPU in float64 from the
    same trees: finite masks, delta norms, cosines against the
    finite-masked weighted-mean delta."""
    def host(tree):
        return [x.detach().to("cpu", torch.float64) for x in tree_leaves(tree)]
    b = host(base)
    deltas = [[x - y for x, y in zip(host(t), b)] for t in trees]
    fin = np.array([all(bool(torch.isfinite(x).all()) for x in d)
                    for d in deltas])
    norms = np.array([float(sum(torch.sum(x * x) for x in d)) ** 0.5
                      for d in deltas])
    w = np.asarray(weights, np.float64) * fin
    wsum = max(float(w.sum()), 1e-12)
    mean = [sum(float(wi) * torch.where(torch.isfinite(d[j]), d[j], 0.0)
                for wi, d in zip(w, deltas)) / wsum for j in range(len(b))]
    mnorm = float(sum(torch.sum(m * m) for m in mean)) ** 0.5
    dot = np.array([float(sum(torch.sum(x * m) for x, m in zip(d, mean)))
                    for d in deltas])
    return fin, norms, dot / np.maximum(norms * mnorm, 1e-12)


def _raw_verdicts(stats, cfg):
    """Each update's verdict before the trust floor (nonfinite, norm, flip
    or ok), and whether its statistic lies within 1e-5 relative of the
    threshold that decided it."""
    fin, norms, cos = stats
    med = float(np.median(norms[fin])) if fin.any() else 0.0
    out = []
    for i in range(len(fin)):
        near = bool(fin[i]) and (
            (med > 0 and abs(norms[i] - cfg.norm_k * med)
             <= 1e-5 * cfg.norm_k * med)
            or abs(cos[i] - cfg.cos_min) <= 1e-5 * abs(cfg.cos_min))
        if not fin[i]:
            v = "nonfinite"
        elif med > 0 and norms[i] > cfg.norm_k * med:
            v = "norm"
        elif cos[i] < cfg.cos_min:
            v = "flip"
        else:
            v = "ok"
        out.append((v, near))
    return out


@contextlib.contextmanager
def _checked_screen_stats(cfg, passes):
    """Every screening pass's ``screen_stats`` (the round loop's and the
    schedulers') timed, its host syncs counted, and held against
    :func:`_stats_f64`: equal finite masks, norms and cosines to 1e-5
    relative (cosines to 1e-5 absolute), equal verdicts except within
    1e-5 of a threshold.  Each pass goes to ``passes``."""
    from repro_torch.federation import engine, simulation
    from repro_torch.runtime import schedulers
    real = engine.screen_stats

    def stats(base, trees, weights):
        torch.cuda.synchronize()
        t0 = time.time()
        out, syncs = _syncs_of(lambda: real(base, trees, weights))
        ms = (time.time() - t0) * 1e3
        want = _stats_f64(base, trees, weights)
        fin = want[0]
        check(np.array_equal(out[0], fin),
              f"finite masks {out[0]} != {fin}")
        norm_err = float(np.max(np.abs(out[1][fin] - want[1][fin])
                                / np.maximum(want[1][fin], 1e-30),
                                initial=0.0))
        cos_err = float(np.max(np.abs(out[2][fin] - want[2][fin]),
                               initial=0.0))
        check(norm_err <= 1e-5 and cos_err <= 1e-5,
              f"screen_stats against f64: norms {norm_err:.2e}, cosines "
              f"{cos_err:.2e}")
        got_v, want_v = _raw_verdicts(out, cfg), _raw_verdicts(want, cfg)
        differ = [i for i, (a, b) in enumerate(zip(got_v, want_v))
                  if a[0] != b[0]]
        check(all(want_v[i][1] for i in differ),
              f"verdicts {got_v} != f64 {want_v} away from a threshold")
        passes.append(dict(n=len(trees), ms=ms, syncs=len(syncs),
                           where=syncs, norm_rel_err=norm_err,
                           cos_abs_err=cos_err, differ=len(differ),
                           near=sum(b[1] for b in want_v)))
        return out

    simulation.screen_stats = schedulers.screen_stats = stats
    try:
        yield
    finally:
        simulation.screen_stats = schedulers.screen_stats = real


def _screened_config():
    """Phase 10's federation with ``screen=True`` and Eq. 16's threshold at
    0, so that every run takes both rounds: an edge whose only update is
    screened out keeps its model, and the round's delta can then fall
    under the default threshold."""
    return dataclasses.replace(_bert_fed_config(), screen=True, xi=0.0)


def _nan_faults(n):
    """The JAX package's screening acceptance trace
    (``tests/test_fault_tolerance.py``) at ``n`` clients: a quarter of
    them ship NaN updates on every dispatch."""
    return make_fault_trace(n, faulty_frac=0.25, corrupt_rate=1.0,
                            corrupt_modes=("nan",), seed=11)


def screening_phase():
    """Phase 10's federation with ``screen=True`` (:func:`_screened_config`):
    (a) ``run("elsa")`` on the plain loop, (b) the sync runtime under the
    NaN fault trace, (c) the deadline and async runtimes under phase 13's
    churn and fault traces (sign-flipped and scaled updates), each 2
    rounds of 4 local steps.  Every screening pass is held against its
    float64 recomputation (:func:`_checked_screen_stats`) and must make
    one host sync; in (b) every update of a faulty client must be judged
    nonfinite and theta finite at every round's evaluation; the losses
    are finite, the event traces consistent, and every ``run_clients``
    call launches phase 10's counts with one host sync.  Reports the
    verdicts by kind, the fallbacks, the trust EMA's min and mean, the
    screening time and syncs a pass, and the wall a client step of each
    run."""
    from repro_torch import telemetry as tm
    fed_cfg = _screened_config()
    n = fed_cfg.n_clients
    churn = make_churn_trace(n, 10_000.0, mean_on_s=40.0, mean_off_s=15.0,
                             churn_frac=0.5, seed=2)
    faults = make_fault_trace(n, faulty_frac=0.5, crash_rate=0.1,
                              drop_rate=0.1, dup_rate=0.1, corrupt_rate=0.1,
                              corrupt_modes=("signflip", "scale"), seed=3)
    nan_faults = _nan_faults(n)
    fed = Federation(fed_cfg, device="cuda")
    per_step = _per_step(fed.cfg.num_layers, remat=False)
    out, launches = {}, {k: 0 for k in _counts()}
    for label, runtime in (
            ("plain", None),
            ("sync, NaN updates", RuntimeConfig("sync", faults=nan_faults)),
            ("deadline", RuntimeConfig("deadline", churn=churn,
                                       faults=faults)),
            ("async", RuntimeConfig("async", churn=churn, faults=faults))):
        passes, evals, log0 = [], [], len(fed.screen_log)

        def checked_eval(theta, evaluate=fed.evaluate):
            evals.append(all(bool(torch.isfinite(x).all())
                             for x in tree_leaves(theta)))
            return evaluate(theta)
        fed.evaluate = checked_eval
        tel = tm.enable()
        try:
            with _checked_screen_stats(fed.screening, passes):
                hist, wall, counts, calls = _counted_run(
                    fed, per_step, runtime=runtime)
        finally:
            tm.disable()
            del fed.evaluate
        launches = {k: launches[k] + v for k, v in counts.items()}
        reports = fed.screen_log[log0:]
        check(len(passes) > 0, f"{label}: no screening pass")
        check(all(p_["syncs"] == 1 for p_ in passes),
              f"{label}: host syncs a screening pass "
              f"{[p_['where'] for p_ in passes]}")
        check(all(evals), f"{label}: theta not finite at an evaluation "
                          f"{evals}")
        if runtime is not None:
            _trace_consistent(hist["trace"], n, len(hist["round"]))
        if label.startswith("sync"):
            judged = [(c, v) for r in reports
                      for c, v in zip(r.clients, r.verdicts)]
            check(any(v == "nonfinite" for _, v in judged),
                  f"{label}: no update judged nonfinite: {judged}")
            check(all(v == "nonfinite" for c, v in judged
                      if c in nan_faults.faulty),
                  f"{label}: a NaN update passed: {judged}")
            check(len(evals) == len(hist["round"]) == 2,
                  f"{label}: rounds {hist['round']}")
        verdicts = {k.split("=")[1].rstrip("}"): int(v)
                    for k, v in tel.counters.items()
                    if k.startswith("screening.verdicts{")}
        fallbacks = {k.split("=")[1].rstrip("}"): int(v)
                     for k, v in tel.counters.items()
                     if k.startswith("screening.fallbacks{")}
        led = fed.trust_ledger
        rounds_calls = calls[1:]
        step_ms = _step_ms(rounds_calls)
        pass_ms = [p_["ms"] for p_ in passes]
        print(f"screening, {label}: rounds {hist['round']}, accuracy "
              f"{hist['accuracy']}, loss {[round(x, 4) for x in hist['loss']]}"
              f", delta {[f'{x:.3e}' for x in hist['delta']]}")
        print(f"  verdicts {verdicts}, fallbacks {fallbacks}; trust EMA min "
              f"{led.scores.min():.4f} mean {led.scores.mean():.4f}, passes "
              f"{led.passes.tolist()} fails {led.fails.tolist()}")
        print(f"  {len(passes)} screening passes of "
              f"{sorted({p_['n'] for p_ in passes})} updates: "
              f"{statistics.median(pass_ms):.2f} ms a pass (median; max "
              f"{max(pass_ms):.2f}), host syncs a pass "
              f"{sorted({p_['syncs'] for p_ in passes})}; against f64: "
              f"norms {max(p_['norm_rel_err'] for p_ in passes):.2e} "
              f"relative, cosines "
              f"{max(p_['cos_abs_err'] for p_ in passes):.2e}; verdicts "
              f"differing {sum(p_['differ'] for p_ in passes)}, statistics "
              f"within 1e-5 of a threshold "
              f"{sum(p_['near'] for p_ in passes)}")
        print(f"  {len(rounds_calls)} run_clients calls after the warm-up, "
              f"{step_ms:.2f} ms a client step; run {wall:.1f}s; launches "
              f"{counts}"
              + (f"; trace {hist['trace'].summary()}" if runtime else ""))
        out[label] = dict(
            round=hist["round"], accuracy=hist["accuracy"],
            loss=hist["loss"], delta=hist["delta"],
            client_losses=hist["client_losses"],
            time=hist.get("time"), verdicts=verdicts, fallbacks=fallbacks,
            reports=[dict(clients=list(map(int, r.clients)),
                          verdicts=r.verdicts, kept=r.kept,
                          fallback=r.fallback) for r in reports],
            trust_min=float(led.scores.min()),
            trust_mean=float(led.scores.mean()),
            trust=led.scores.tolist(), passes_ok=led.passes.tolist(),
            fails=led.fails.tolist(), screen_passes=passes,
            pass_ms_median=statistics.median(pass_ms),
            syncs_per_pass=sorted({p_["syncs"] for p_ in passes}),
            step_ms=step_ms, calls=calls, run_s=wall, launches=counts,
            trace_summary=(hist["trace"].summary() if runtime else None))
    del fed
    torch.cuda.empty_cache()
    return out, launches


# ---------------------------------------------------------------------------
# 15. checkpoints
# ---------------------------------------------------------------------------

def _same_history(got, want, keys, label):
    for key in keys:
        check(got[key] == want[key],
              f"{label}: {key} {got[key]} != {want[key]}")


def checkpoint_phase(phase10, phase14):
    """Full-state federation checkpoints.  Phase 10's federation for 2
    rounds of 4 local steps with ``CheckpointConfig(every=1, keep=2)``:
    its history must be phase 10's bit for bit (checkpointing is off the
    math path).  A new ``Federation`` resumed from the round-0 file must
    finish with the uninterrupted run's history and final theta bit for
    bit.  The same on the sync runtime with phase 14 (b)'s screening and
    NaN fault trace, where the trust ledger must also come back equal;
    the deadline and async policies must refuse ``checkpoint=`` with the
    ``ValueError``.  Reports each file's bytes and the save and restore
    times."""
    import tempfile

    from repro_torch import telemetry as tm
    from repro_torch.checkpoint import CheckpointConfig, tree_equal
    from repro_torch.checkpoint import federation as fedckpt
    keys = ("round", "accuracy", "loss", "delta", "client_losses")
    base_cfg, screen_cfg = _bert_fed_config(), _screened_config()
    sync = RuntimeConfig("sync", faults=_nan_faults(base_cfg.n_clients))
    out, launches = {}, {k: 0 for k in _counts()}
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        for label, cfg, runtime, want in (
                ("plain", base_cfg, None, phase10),
                ("sync, screening, NaN updates", screen_cfg, sync, None)):
            d = os.path.join(tmp, label.split(",")[0])
            fed = Federation(cfg, device="cuda")
            per_step = _per_step(fed.cfg.num_layers, remat=False)
            tel = tm.enable()
            try:
                hist, wall, counts, calls = _counted_run(
                    fed, per_step, runtime=runtime,
                    checkpoint=CheckpointConfig(dir=d, every=1, keep=2))
            finally:
                tm.disable()
            launches = {k: launches[k] + v for k, v in counts.items()}
            files = fedckpt.list_checkpoints(d)
            check([os.path.basename(f) for f in files]
                  == ["ckpt_round_000000.msgpack",
                      "ckpt_round_000001.msgpack"], f"{label}: {files}")
            if want is not None:
                _same_history(hist, want, keys, f"{label} vs phase 10")
            theta, ledger = fed.last_theta, fed.trust_ledger
            del fed
            torch.cuda.empty_cache()
            fed = Federation(cfg, device="cuda")
            tel_r = tm.enable()
            try:
                res, wall_r, counts_r, calls_r = _counted_run(
                    fed, per_step, runtime=runtime,
                    resume_from=fedckpt.round_path(d, 0))
            finally:
                tm.disable()
            launches = {k: launches[k] + v for k, v in counts_r.items()}
            check(len(calls_r) == (len(calls) - 1) // 2,
                  f"{label}: the resume ran {len(calls_r)} run_clients "
                  f"calls, the run {len(calls)} (a warm-up and 2 rounds)")
            _same_history(res, hist, keys + (("time",) if runtime else ()),
                          f"{label}: resumed vs uninterrupted")
            check(tree_equal(fed.last_theta, theta),
                  f"{label}: the resumed final theta differs")
            if runtime is not None:
                check(res["trace"].records == hist["trace"].records,
                      f"{label}: the resumed event trace differs")
                for k in ("scores", "passes", "fails"):
                    check(np.array_equal(getattr(fed.trust_ledger, k),
                                         getattr(ledger, k)),
                          f"{label}: ledger {k} differs after the resume")
            if runtime is not None:
                for policy in ("deadline", "async"):
                    try:
                        fed.run("elsa", global_rounds=2,
                                runtime=RuntimeConfig(policy),
                                checkpoint=CheckpointConfig(dir=d))
                        check(False, f"{policy} took checkpoint=")
                    except ValueError as e:
                        check("'sync' runtime policy only" in str(e),
                              f"{policy}: {e}")
            save_h = tel.histograms["checkpoint.save_s"]
            restore_h = tel_r.histograms["checkpoint.restore_s"]
            sizes = [os.path.getsize(f) for f in files]
            same_14 = None
            if runtime is not None:
                p14 = phase14["sync, NaN updates"]
                same_14 = all(hist[k] == p14[k] for k in keys + ("time",))
            print(f"checkpoints, {label}: history {hist['accuracy']}, loss "
                  f"{[round(x, 4) for x in hist['loss']]}"
                  + (" = phase 10's bit for bit" if want is not None else
                     f" (phase 14 (b)'s bit for bit: {same_14})"))
            print(f"  files {sizes} bytes; save "
                  f"{save_h.sum / save_h.count:.3f} s a file (max "
                  f"{save_h.max:.3f}), restore "
                  f"{restore_h.sum:.3f} s; run {wall:.1f}s, resumed run "
                  f"{wall_r:.1f}s ({_step_ms(calls_r):.2f} ms a client step; "
                  f"launches {counts_r}); resumed history, theta"
                  + (", trace and ledger" if runtime else "")
                  + " bit-equal")
            out[label] = dict(
                accuracy=hist["accuracy"], loss=hist["loss"],
                delta=hist["delta"], file_bytes=sizes,
                save_s=[save_h.sum / save_h.count, save_h.max],
                restore_s=restore_h.sum, run_s=wall, resumed_run_s=wall_r,
                step_ms=_step_ms(calls[1:]),
                resumed_step_ms=_step_ms(calls_r), launches=counts,
                resumed_launches=counts_r, same_as_phase14b=same_14)
            del fed
            torch.cuda.empty_cache()
    return out, launches


# ---------------------------------------------------------------------------
# 16. populations and telemetry
# ---------------------------------------------------------------------------

def _host_rss_mib():
    """This process's resident host memory (MiB, ``VmRSS`` of
    /proc/self/status; nan where the kernel does not report it) and its
    peak (``getrusage``'s ``ru_maxrss``)."""
    import resource
    rss = float("nan")
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                rss = int(line.split()[1]) / 1024
    return rss, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def _population_fed(pop_cfg):
    """Phase 10's federation on the card with a population of ``pop_cfg``
    whose bookkeeping (``begin_round``, ``note_updates``, ``end_round``)
    and identity channel builds are timed: each call's host ms and host
    syncs go to ``log``, keyed by the round last begun (-1: the profile,
    before round 0).  Also kept: each round's cohort, every pinned
    identity, and each ``note_updates`` call's ids beside the slots'
    occupants at the time.  Returns (federation, population, log,
    record)."""
    from repro_torch.population import PopulationRuntime
    fed = Federation(_bert_fed_config(), device="cuda")
    pop = PopulationRuntime(fed, pop_cfg)
    log = []
    rec = {"round": -1, "cohorts": [], "pins": [], "notes": []}

    def timed(what, fn):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out, syncs = _syncs_of(lambda: fn(*a, **kw))
            log.append(dict(what=what, round=rec["round"],
                            ms=(time.perf_counter() - t0) * 1e3,
                            syncs=len(syncs), where=syncs))
            return out
        return wrapped

    begin, note, pin = pop.begin_round, pop.note_updates, pop.pin

    def begin_round(g, t=None):
        rec["round"] = g
        ids = begin(g, t=t)
        rec["cohorts"].append([int(c) for c in ids])
        return ids

    def note_updates(slots, trees, base, ids=None):
        occupants = [int(pop.slot_to_id[s]) for s in slots]
        rec["notes"].append(dict(
            ids=occupants if ids is None else [int(c) for c in ids],
            occupants=occupants))
        return note(slots, trees, base, ids=ids)

    def pinned(slot):
        rec["pins"].append(pin(slot))
        return rec["pins"][-1]

    pop.begin_round = timed("begin_round", begin_round)
    pop.note_updates = timed("note_updates", note_updates)
    pop.end_round = timed("end_round", pop.end_round)
    pop.pin = pinned
    fed._build_identity_channel = timed("channel_build",
                                        fed._build_identity_channel)
    return fed, pop, log, rec


def _bookkeeping(log):
    """Per round: calls, host ms and host syncs of each bookkeeping kind;
    printed one line a round."""
    out = {}
    for e in log:
        k = out.setdefault(e["round"], {}).setdefault(
            e["what"], {"calls": 0, "ms": 0.0, "syncs": 0})
        k["calls"] += 1
        k["ms"] += e["ms"]
        k["syncs"] += e["syncs"]
    for g in sorted(out):
        print(f"  bookkeeping, {'profile' if g < 0 else f'round {g}'}: "
              + "; ".join(f"{k} {v['calls']}x {v['ms']:.2f} ms, "
                          f"{v['syncs']} syncs"
                          for k, v in sorted(out[g].items())), flush=True)
    return out


def _big_population(churn):
    """Phase 16 (b)'s population: 10^5 registered ids, uniform cohorts
    (seed 17) filtered by ``churn``, adapter shards of 8 float16 rows (a
    full-width bert-base row is ~0.9 M floats)."""
    from repro_torch.population import PopulationConfig
    return PopulationConfig(registered=100_000, strategy="uniform", seed=17,
                            churn=churn, shard_rows=8,
                            adapter_dtype="float16")


def population_phase(phase10):
    """Registry-backed populations (``run(population=PopulationConfig(
    ...))``) on phase 10's federation, with telemetry's round records.
    (a) ``registered=8`` (the identity population) on the plain loop inside
    a telemetry session: the history must be phase 10's bit for bit.
    (b) ``registered=100_000`` (uniform, seed 17, a population-sized churn
    trace, adapter shards of 8 float16 rows) for 3 rounds of 4 steps,
    streaming to a ``JsonlSink``: each round's cohort new and online,
    participations summing to 3 x 8, one channel build for each identity
    that trained, an evicted identity's rebuilt channel bit-equal to its
    first, the registry holding only the touched shards, and the file read
    back with one record a round and rendered by the report.  (c)
    ``deadline`` and ``async`` with ``registered=1_000`` under phase 13's
    traces and a 1,000-client churn trace: every update written back under
    an identity pinned at a dispatch.  (d) (b)'s configuration for 2
    rounds with a checkpoint a round, resumed from round 0 by a new
    ``Federation``: history, theta, registry columns and adapter shards bit
    for bit.  In every run each ``run_clients`` call must launch phase 10's
    counts and make 1 host sync.  Reports the registry's MiB and shards,
    host RSS, the wall a client step, and the bookkeeping's host ms and
    syncs a round."""
    import tempfile

    from repro_torch import telemetry as tm
    from repro_torch.analysis.telemetry_report import render
    from repro_torch.checkpoint import CheckpointConfig, tree_equal
    from repro_torch.checkpoint import federation as fedckpt
    from repro_torch.population import PopulationConfig
    keys = ("round", "accuracy", "loss", "delta", "client_losses")
    per_step = _per_step(_bert_fed_config().layers, remat=False)
    n = _bert_fed_config().n_clients
    out, launches = {}, {k: 0 for k in _counts()}
    os.makedirs(OUT_DIR, exist_ok=True)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    # (a) the identity population, telemetry on
    fed, pop, log, _ = _population_fed(PopulationConfig(registered=n))
    with tm.session({"phase": "16a"}) as tel:
        hist, wall, counts, calls = _counted_run(fed, per_step,
                                                 population=pop)
    add(counts)
    _same_history(hist, phase10, keys, "16a: registered=8 vs phase 10")
    check([r["round"] for r in tel.rounds] == [0, 1],
          f"16a: round records {[r['round'] for r in tel.rounds]}")
    check(pop.registry.participations.tolist() == [2] * n,
          f"16a: participations {pop.registry.participations.tolist()}")
    spans = sorted({s["name"] for r in tel.rounds for s in r["spans"]})
    print(f"populations (a), registered={n}, telemetry on: history phase "
          f"10's bit for bit; {len(calls)} run_clients calls, 1 host sync "
          f"each, {_step_ms(calls[1:]):.2f} ms a client step; round records "
          f"{[r['round'] for r in tel.rounds]}, spans {spans}")
    out["a"] = dict(accuracy=hist["accuracy"], loss=hist["loss"],
                    step_ms=_step_ms(calls[1:]), run_s=wall,
                    launches=counts, spans=spans)
    del fed, pop
    torch.cuda.empty_cache()

    # (b) 10^5 registered ids through the 8 slots, streamed to a JsonlSink
    t0 = time.time()
    churn = make_churn_trace(100_000, 1_000.0, mean_on_s=60.0,
                             mean_off_s=20.0, churn_frac=0.5, seed=17,
                             version=2)
    churn_s = time.time() - t0
    t0 = time.time()
    fed, pop, log, rec = _population_fed(_big_population(churn))
    bind_s = time.time() - t0
    path = os.path.join(OUT_DIR, "population_telemetry.jsonl")
    with tm.session({"phase": "16b"}, sink=tm.JsonlSink(path)):
        hist, wall, counts, calls = _counted_run(
            fed, per_step, rounds=3, steps=4, population=pop)
    add(counts)
    reg, cohorts = pop.registry, rec["cohorts"]
    check(len(cohorts) == 3 and all(len(set(c)) == n for c in cohorts)
          and len({c for ids in cohorts for c in ids}) == 3 * n,
          f"16b: cohorts {cohorts}")
    check(all(churn.is_online(c, 0.0) for ids in cohorts for c in ids),
          f"16b: an offline id was sampled: {cohorts}")
    check(int(reg.participations.sum()) == 3 * n,
          f"16b: participations sum {int(reg.participations.sum())}")
    trained = {c for nt in rec["notes"] for c in nt["ids"]}
    builds = [e for e in log if e["what"] == "channel_build"]
    profile_builds = sum(e["round"] < 0 for e in builds)
    check(profile_builds == n and pop._chan_misses == len(builds)
          and len(builds) - n == len(trained - set(range(n)))
          and pop._chan_evictions == 0,
          f"16b: {len(builds)} channel builds ({profile_builds} at the "
          f"profile) for {len(trained)} ids that trained")
    run_log = list(log)                       # the run's bookkeeping
    cid = cohorts[0][0]                       # evict one identity, rebuild
    first = pop._channels.pop(cid)
    again = pop.channel_for_id(cid)
    check(again is not first and torch.equal(again.ssop.u, first.ssop.u)
          and torch.equal(again.ssop.v, first.ssop.v),
          f"16b: identity {cid}'s rebuilt channel differs")
    shard_bytes = pop.cfg.shard_rows * pop.adapter_dim * 2
    columns = sum(c.nbytes for c in reg.columns.values())
    check(0 < reg.allocated_shards <= len(trained)
          and reg.nbytes == columns + reg.allocated_shards * shard_bytes,
          f"16b: {reg.allocated_shards} shards, {reg.nbytes} bytes")
    data = tm.read_jsonl(path)
    check([r["round"] for r in data["rounds"]] == [0, 1, 2],
          f"16b: the JSONL's rounds {[r['round'] for r in data['rounds']]}")
    report = render(data, show_rounds=True)
    check(report.startswith("telemetry summary (3 rounds")
          and "local_steps" in report, f"16b: report {report[:300]}")
    rss, hwm = _host_rss_mib()
    step_ms = _step_ms(calls[1:])
    print(f"populations (b), registered=100,000 (churn trace built in "
          f"{churn_s:.2f}s, federation and registry in {bind_s:.2f}s): "
          f"cohorts {cohorts}; accuracy {hist['accuracy']}, loss "
          f"{[round(x, 4) for x in hist['loss']]}")
    print(f"  registry {reg.nbytes / 2 ** 20:.2f} MiB: columns "
          f"{columns / 2 ** 20:.2f} MiB + {reg.allocated_shards} of "
          f"{reg.n_shards} adapter shards x {shard_bytes / 2 ** 20:.2f} MiB "
          f"(adapter_dim {pop.adapter_dim}); host RSS {rss:.0f} MiB (peak "
          f"{hwm:.0f}); {len(calls)} run_clients calls, 1 host sync each, "
          f"{step_ms:.2f} ms a client step; {len(builds)} channel builds "
          f"({profile_builds} at the profile) for {len(trained)} ids that "
          f"trained; rebuilt channel of id {cid} bit-equal")
    book = _bookkeeping(run_log)
    print("  " + report.replace("\n", "\n  "), flush=True)
    out["b"] = dict(cohorts=cohorts, accuracy=hist["accuracy"],
                    loss=hist["loss"], registry_bytes=reg.nbytes,
                    column_bytes=columns, shards=reg.allocated_shards,
                    n_shards=reg.n_shards, shard_bytes=shard_bytes,
                    adapter_dim=pop.adapter_dim, rss_mib=rss, hwm_mib=hwm,
                    step_ms=step_ms, run_s=wall, launches=counts,
                    channel_builds=len(builds),
                    profile_builds=profile_builds, trained=len(trained),
                    bookkeeping=book, churn_build_s=churn_s, bind_s=bind_s,
                    calls=calls)
    del fed, pop
    torch.cuda.empty_cache()

    # (c) deadline and async with 1,000 registered ids
    slot_churn = make_churn_trace(n, 10_000.0, mean_on_s=40.0,
                                  mean_off_s=15.0, churn_frac=0.5, seed=2)
    faults = make_fault_trace(n, faulty_frac=0.5, crash_rate=0.1,
                              drop_rate=0.1, dup_rate=0.1, corrupt_rate=0.1,
                              corrupt_modes=("signflip", "scale"), seed=3)
    pop_churn = make_churn_trace(1_000, 10_000.0, mean_on_s=40.0,
                                 mean_off_s=15.0, churn_frac=0.5, seed=2)
    for policy in ("deadline", "async"):
        fed, pop, log, rec = _population_fed(PopulationConfig(
            registered=1_000, seed=17, churn=pop_churn))
        hist, wall, counts, calls = _counted_run(
            fed, per_step, population=pop, runtime=RuntimeConfig(
                policy, churn=slot_churn, faults=faults))
        add(counts)
        _trace_consistent(hist["trace"], n, len(hist["round"]))
        pins = set(rec["pins"])
        noted = [c for nt in rec["notes"] for c in nt["ids"]]
        moved = sum(c != o for nt in rec["notes"]
                    for c, o in zip(nt["ids"], nt["occupants"]))
        check(noted and set(noted) <= pins,
              f"16c {policy}: updates written under ids never dispatched: "
              f"{sorted(set(noted) - pins)}")
        reg = pop.registry
        print(f"populations (c), {policy}, registered=1,000: rounds "
              f"{hist['round']}, simulated time "
              f"{[round(x, 3) for x in hist['time']]}, loss "
              f"{[round(x, 4) for x in hist['loss']]}, cohorts "
              f"{rec['cohorts']}; {len(calls)} run_clients calls, 1 host "
              f"sync each, {_step_ms(calls[1:]):.2f} ms a client step; "
              f"{len(pins)} ids dispatched, {len(noted)} updates written "
              f"back, {moved} of them under a pinned id that no longer held "
              f"its slot; trace {hist['trace'].summary()}")
        book = _bookkeeping(log)
        out[f"c {policy}"] = dict(
            round=hist["round"], time=hist["time"], loss=hist["loss"],
            cohorts=rec["cohorts"], step_ms=_step_ms(calls[1:]),
            run_s=wall, launches=counts, dispatched=len(pins),
            noted=len(noted), moved=moved,
            trace_summary=hist["trace"].summary(), bookkeeping=book)
        del fed, pop
        torch.cuda.empty_cache()

    # (d) (b)'s population checkpointed each round, resumed by a new
    # Federation from round 0
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        fed, pop, _, _ = _population_fed(_big_population(churn))
        tel = tm.enable()
        try:
            hist, wall, counts, calls = _counted_run(
                fed, per_step, population=pop,
                checkpoint=CheckpointConfig(dir=tmp, every=1, keep=2))
        finally:
            tm.disable()
        add(counts)
        theta, reg = fed.last_theta, pop.registry
        sizes = [os.path.getsize(f) for f in fedckpt.list_checkpoints(tmp)]
        save_h = tel.histograms["checkpoint.save_s"]
        del fed, pop
        torch.cuda.empty_cache()
        t0 = time.time()
        fed, pop, _, _ = _population_fed(_big_population(churn))
        res, wall_r, counts_r, calls_r = _counted_run(
            fed, per_step, population=pop,
            resume_from=fedckpt.round_path(tmp, 0))
        resume_s = time.time() - t0
        add(counts_r)
        _same_history(res, hist, keys, "16d: resumed vs uninterrupted")
        check(tree_equal(fed.last_theta, theta),
              "16d: the resumed final theta differs")
        for name, col in reg.columns.items():
            check(col.tobytes() == pop.registry.columns[name].tobytes(),
                  f"16d: registry column {name} differs after the resume")
        a, b = reg.state()["adapter_shards"], \
            pop.registry.state()["adapter_shards"]
        check([i for i, _ in a] == [i for i, _ in b]
              and all(x.tobytes() == y.tobytes()
                      for (_, x), (_, y) in zip(a, b)),
              "16d: adapter shards differ after the resume")
        print(f"populations (d), registered=100,000, a checkpoint a round: "
              f"files {sizes} bytes, save {save_h.sum / save_h.count:.3f} s "
              f"a file; a new Federation resumed from round 0 in "
              f"{resume_s:.1f}s ({len(calls_r)} run_clients calls): history, "
              f"theta, {len(reg.columns)} registry columns and {len(a)} "
              f"adapter shards bit-equal", flush=True)
        out["d"] = dict(file_bytes=sizes, save_s=save_h.sum / save_h.count,
                        run_s=wall, resume_s=resume_s, shards=len(a),
                        launches=counts, resumed_launches=counts_r)
        del fed, pop
        torch.cuda.empty_cache()
    return out, launches


# ---------------------------------------------------------------------------
# 10b. split-training parity at full width
# ---------------------------------------------------------------------------

def split_parity_phase(qk_scale=0.1):
    """One ``split_loss`` gradient of bert-base at full width (d 768, 12
    heads; f32, 4 layers, split (1, 1, 2): both cuts real) through the
    channel (SS-OP r 8, sketch Y 3, Z 121), the kernel path against the
    plain path (autograd through the plain versions) on the same weights,
    batch and channel.  As phase 7, each block's LoRA gradient must agree
    with the plain path to 4x that block's own floor, or 1e-5 of its
    scale, with wq and wk scaled by ``qk_scale`` (soft attention: at the
    init the scores reach ~100 and the f32 error swamps the check).  The
    floor is the larger of the plain path's f32-vs-f64 error and how far
    the plain path's gradient moves when the channel's input is perturbed
    by one f32 rounding (relative 2^-23, two draws): the median decode has
    near-ties (about ten features a cut within 1e-6 of the scale here),
    and a rounding that flips one routes that feature's gradient through
    another bucket, which the kernel path's other summation order can do
    too.  Block 0's tolerance must stay within a tenth of its scale, so a
    wrong channel backward (18% of the scale in phase 7's mutation) still
    fails."""
    m = get_split_model("bert-base", reduced=False, num_layers=4,
                        dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(11)
    p = init_tree(m.specs(4), gen, torch.float32, "cuda")
    _random_b(p["lora"], gen, 0.02)
    for layer in p["frozen"]["blocks"]:
        layer["attn"]["wq"].mul_(qk_scale)
        layer["attn"]["wk"].mul_(qk_scale)
    d = m.cfg.d_model
    u = torch.linalg.qr(torch.randn(d, 8, generator=gen, device="cuda"))[0]
    v = torch.linalg.qr(torch.randn(8, 8, generator=gen, device="cuda"))[0]
    ch = Channel(SSOP(u, v), make_plan(d, 3, int(d / (2.1 * 3)), seed=11,
                                       device="cuda"))
    toks = torch.randint(0, m.cfg.vocab_size, (8, 128), generator=gen,
                         device="cuda")
    batch = {"tokens": toks, "labels": torch.randint(
        0, 4, (8,), generator=gen, device="cuda")}
    split = split_training.Split(1, 1, 2)

    def grad(model, params, channel=ch):
        loss, g = split_training.loss_and_grad(
            lambda lp: split_training.split_loss(
                model, params["frozen"], lp, batch, split, channel),
            params["lora"])
        torch.cuda.synchronize()
        return float(loss), g

    def perturbed(seed):
        noise_gen = torch.Generator(device="cuda").manual_seed(seed)

        def call(h):
            e = torch.randn(h.shape, generator=noise_gen, device=h.device,
                            dtype=h.dtype)
            return ch(h * (1 + 2 ** -23 * e))
        return call

    m64 = get_split_model("bert-base", reduced=False, num_layers=4,
                          dtype="float64")
    p64 = {k: tree_map(lambda t: t.double(), v) for k, v in p.items()}
    _zero_counts()
    k_loss, k_g = grad(m, p)
    counts = _counts()
    check(counts == _per_step(4, remat=False), f"kernel path {counts}")
    with plain_path():
        p_loss, p_g = grad(m, p)
        t_loss, t_g = grad(m64, p64)
        moved = [grad(m, p, perturbed(seed))[1] for seed in (1, 2)]
    check(_counts() == counts, "the plain path launched a kernel")
    tol_loss = max(4 * abs(p_loss - t_loss), 1e-5 * abs(p_loss))
    print(f"bert-base full width, f32, 4 layers, wq/wk x {qk_scale}: loss "
          f"kernel {k_loss:.6f} plain {p_loss:.6f} (f64 {t_loss:.6f}), err "
          f"{abs(k_loss - p_loss):.3e} (tol {tol_loss:.3e})")
    check(abs(k_loss - p_loss) <= tol_loss, "loss")
    names = [f"block {i}" for i in range(4)] + ["pooler", "head"]

    def part(g, name):
        return g["blocks"][int(name[-1])] if name.startswith("block") \
            else g[name]
    blocks = []
    for name in names:
        kg, pg = part(k_g, name), part(p_g, name)
        blk = dict(part=name, max_g=_max_abs(pg), err=_max_abs(kg, pg),
                   floor_f64=_max_abs(pg, part(t_g, name)),
                   floor_moved=max(_max_abs(pg, part(g, name))
                                   for g in moved))
        blk["tol"] = max(4 * blk["floor_f64"], 4 * blk["floor_moved"],
                         1e-5 * blk["max_g"])
        blocks.append(blk)
        print(f"  {name}: max|g| {blk['max_g']:.3e}, kernel vs plain "
              f"{blk['err']:.3e} (tol {blk['tol']:.3e} = "
              f"{blk['tol'] / blk['max_g']:.3%} of max|g|; plain f32 vs f64 "
              f"{blk['floor_f64']:.3e}, moved by a rounding of the channel's "
              f"input {blk['floor_moved']:.3e})")
        check(blk["err"] <= blk["tol"], f"{name}: {blk['err']:.3e} > "
                                        f"{blk['tol']:.3e}")
    check(blocks[0]["tol"] <= 0.1 * blocks[0]["max_g"],
          "block 0's tolerance is over a tenth of its scale; the check "
          "would not see a wrong channel backward")
    del p, p64, k_g, p_g, t_g, moved
    torch.cuda.empty_cache()
    return dict(qk_scale=qk_scale, loss_kernel=k_loss, loss_plain=p_loss,
                loss_f64=t_loss, parts=blocks, launches=counts)


# ---------------------------------------------------------------------------
# 12. the causal-LM federation
# ---------------------------------------------------------------------------

def _olmo_full(num_layers=None, dtype=None, **overrides):
    """olmo-1b at full width (d 2048, 16 heads, vocab 50304), through the
    registry's factory hook, as ``_bert_full``."""
    cfg = get_config("olmo-1b").with_(**overrides)
    if num_layers is not None:
        cfg = cfg.with_(num_layers=num_layers)
    if dtype is not None:
        cfg = cfg.with_(param_dtype=dtype, activation_dtype=dtype)
    return CausalLMSplitModel(cfg)


def causal_lm_federation_phase():
    """The federation of a dense decoder: full-width olmo-1b (16 layers,
    f32) registered as ``"olmo-1b-full"``, 4 clients on 2 edges, client 1
    poisoned, the launcher's 8 x 64 stream, ``run("elsa")`` for 2 rounds
    of 2 local steps on the default (batched) backend, each client step
    clipped to a global norm of 1.  As phase 10, every ``run_clients``
    call must launch exactly real members x steps x what a client step of
    16 blocks implies; the losses must be finite."""
    register_split_model("olmo-1b-full", _olmo_full)
    fed_cfg = FedConfig(model="olmo-1b-full", layers=16, n_clients=4,
                        n_edges=2, alpha=0.2, poisoned=(1,),
                        total_examples=400, batch_size=8, seq_len=64,
                        probe_q=8, local_warmup_steps=2, t_rounds=1,
                        lr=5e-3, clip_norm=1.0)
    base = _memory_base()
    fed = Federation(fed_cfg, device="cuda")
    cfg = fed.cfg
    check(fed.backend == "batched" and fed.model.task == "causal-lm",
          f"{fed.backend} {fed.model.task}")
    check((cfg.d_model, cfg.num_heads, cfg.num_layers, cfg.vocab_size)
          == (2048, 16, 16, 50304), f"not full width: {cfg}")
    hist, wall, counts, calls, (groups, div, trust) = _run_federation(
        fed, rounds=2, steps=2)
    peak = _peak_gib(base)
    step_ms, call_ms = _round_walls(calls)
    syncs = [len(c["syncs"]) for c in calls]
    print(f"causal-LM federation (olmo-1b full width, f32, 4 clients, 2 "
          f"edges): groups { {k: v for k, v in groups.items() if v} }, "
          f"trust {np.round(trust, 3).tolist()}")
    print(f"  history: accuracy {hist['accuracy']}, loss "
          f"{[round(x, 4) for x in hist['loss']]}, delta "
          f"{[f'{x:.3e}' for x in hist['delta']]}")
    for c in calls:
        print(f"  run_clients: {len(c['clients'])} clients x {c['steps']} "
              f"steps, {c['buckets']} split buckets, {c['ms']:.1f} ms "
              f"({c['client_step_ms']:.2f} ms a client step), host syncs "
              f"{c['syncs']}")
    print(f"  run {wall:.1f}s; rounds: {step_ms:.2f} ms a client step "
          f"(8 x 64 tokens); launches in the run {counts}; peak memory "
          f"{peak:.2f} GiB (above the {base / 2 ** 30:.2f} GiB held before)")
    out = dict(groups={str(k): v for k, v in groups.items()},
               trust=list(map(float, trust)), accuracy=hist["accuracy"],
               loss=hist["loss"], delta=hist["delta"], run_s=wall,
               step_ms=step_ms, step_ms_calls=call_ms, calls=calls,
               syncs_per_call=syncs,
               launches_per_step={k: v // (len(calls[-1]["clients"])
                                           * calls[-1]["steps"])
                                  for k, v in calls[-1]["launches"].items()},
               launches=counts, peak_gib=peak, base_gib=base / 2 ** 30)

    # where a client step's time goes (phase 18d): one run_clients call of
    # every assigned client for one step, each on its first 8 examples
    members = sorted(n for g in groups.values() for n in g)
    splits = {n: fed.split_for(n) for n in members}
    channels = {n: fed.channel_for(n, fed.lora0) for n in members}
    batches = {n: [(fed.data[n].tokens[:8], fed.data[n].labels[:8])]
               for n in members}

    def one():
        fed.engine.run_clients(fed.last_theta, members, splits, channels,
                               batches)

    one()
    out["breakdown"] = device_breakdown(one, per=len(members), show=False)
    del fed
    torch.cuda.empty_cache()
    return out, counts


# ---------------------------------------------------------------------------
# 17. the MoE family
# ---------------------------------------------------------------------------

# depth on the card: every published width kept, the depth cut so that one
# model's bf16 weights fit beside its activations (grok-1: 4 MoE blocks,
# 42.6 GB; deepseek-v2: the dense first layer + 4 MLA/MoE blocks, 34.5 GB)
MOE_DEPTH = {"grok-1-314b": 4, "deepseek-v2-236b": 5}


@contextlib.contextmanager
def _recording_routes(routes):
    """Record every MoE routing decision (``sel``, ``keep``) of the block
    into ``routes``."""
    route = moe_lib.route

    def recorded(cfg, router, xt):
        out = route(cfg, router, xt)
        routes.append((out[2].clone(), out[3].clone()))
        return out

    moe_lib.route = recorded
    try:
        yield routes
    finally:
        moe_lib.route = route


def _soften_attention(frozen_block):
    """wq/wk (grok-1) or the query up-projection (deepseek-v2) x 0.1, as
    phase 7 softens olmo-1b's: at the init the attention is sharp enough
    that the plain path's own f32 error would leave little to check."""
    for k in ("wq", "wk", "w_uq"):
        if k in frozen_block["attn"]:
            frozen_block["attn"][k].mul_(0.1)


def _moe_block_parity(arch, B=2, S=64):
    """One MoE block (grok-1's GQA + MoE; deepseek-v2's MLA + MoE) at full
    width in f32: the kernel path against the plain path on the same
    weights and input, the plain path also in f64 (its weights converted
    in place, one leaf at a time).  Each of the output, the aux loss, the
    input gradient and every LoRA gradient (of ``sum(out * g) + aux``)
    must agree to 4x the plain path's own f32 error (against its f64
    run), or 1e-5 of its scale; the routing (``sel``, ``keep``) of the two
    f32 paths equal as integers."""
    cfg = get_config(arch).with_(param_dtype="float32",
                                 activation_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(17)
    frozen = init_tree(transformer._one_block_specs(cfg, use_moe=True), gen,
                       torch.float32, "cuda")
    lora = init_tree(transformer._one_block_lora_specs(cfg), gen,
                     torch.float32, "cuda")
    _random_b({"blocks": [lora]}, gen, 0.02)
    _soften_attention(frozen)
    x = torch.randn(B, S, cfg.d_model, generator=gen, device="cuda")
    g = torch.randn(B, S, cfg.d_model, generator=gen, device="cuda")
    pos = torch.arange(S, device="cuda")

    def run(c, f, lp, x_, g_):
        leaves = [t.requires_grad_(True) for t in tree_leaves(lp)]
        xr = x_.clone().requires_grad_(True)
        routes = []
        with _recording_routes(routes):
            out, _, aux = transformer._block_apply(c, f, lp, xr,
                                                   positions=pos,
                                                   use_moe=True)
            grads = torch.autograd.grad((out * g_).sum() + aux,
                                        leaves + [xr])
        torch.cuda.synchronize()
        for t in leaves:
            t.requires_grad_(False)
        return {"out": out.detach(), "aux": aux.detach(), "dx": grads[-1],
                **{f"d{i}": t for i, t in enumerate(grads[:-1])}}, routes[0]

    _zero_counts()
    kern, k_route = run(cfg, frozen, lora, x, g)
    counts = _counts()
    want = {"ssop_apply": 0, "sketch_scatter": 0, "sketch_gather": 0,
            "lora_matmul": 0 if cfg.mla else 4, "flash_attention": 1}
    check(counts == want, f"{arch} block: kernel path launches {counts}")
    with plain_path():
        plain, p_route = run(cfg, frozen, lora, x, g)
        for tree in (frozen, lora):
            for leaf in tree_leaves(tree):
                leaf.data = leaf.data.double()
        cfg64 = cfg.with_(param_dtype="float64", activation_dtype="float64")
        ref, r_route = run(cfg64, frozen, lora, x.double(), g.double())
    check(_counts() == counts, "the plain path launched a kernel")
    check(torch.equal(k_route[0], p_route[0])
          and torch.equal(k_route[1], p_route[1]),
          f"{arch} block: the kernel path routed other tokens than the "
          f"plain path")
    same64 = (torch.equal(p_route[0], r_route[0])
              and torch.equal(p_route[1], r_route[1]))
    rows = {}
    for key in kern:
        err = (kern[key] - plain[key]).abs().max().item()
        floor = (plain[key].double() - ref[key]).abs().max().item()
        scale = ref[key].abs().max().item()
        tol = max(4 * floor, 1e-5 * scale)
        rows[key] = dict(err=err, floor=floor, scale=scale, tol=tol)
        check(torch.isfinite(kern[key]).all().item(), f"{arch} {key}")
        check(err <= tol, f"{arch} block {key}: kernel vs plain "
                          f"{err:.3e} > {tol:.3e} (plain f32 vs f64 "
                          f"{floor:.3e}, scale {scale:.3e})")
    worst = max(rows.values(), key=lambda r: r["err"] / r["scale"])
    kept = int(k_route[1].sum())
    print(f"{arch} block (f32, B {B} x S {S}): out err "
          f"{rows['out']['err']:.3e} (tol {rows['out']['tol']:.3e}), aux "
          f"{rows['aux']['err']:.3e} (tol {rows['aux']['tol']:.3e}), dx "
          f"{rows['dx']['err']:.3e} (tol {rows['dx']['tol']:.3e}); "
          f"{len(kern) - 3} LoRA gradients, worst err/scale "
          f"{worst['err'] / worst['scale']:.2e}; routing equal, "
          f"{kept}/{k_route[1].numel()} (token, choice) pairs kept"
          f"{'' if same64 else ' (f64 routes differently)'}; launches "
          f"{counts}", flush=True)
    del frozen, lora, kern, plain, ref
    torch.cuda.empty_cache()
    return dict(rows=rows, kept=kept, pairs=k_route[1].numel(),
                f64_same_routing=same64, launches=counts)


def _moe_serving(arch, cfg, frozen, lora, gen):
    """``ServingEngine`` over the depth-cut model: one batch of 8 requests
    for 16 new tokens, ``swap_adapter``, a second batch."""
    engine = ServingEngine(cfg, params={"frozen": frozen, "lora": lora},
                           batch_size=8, max_len=48)
    engine.submit([1, 2, 3], max_new_tokens=2)        # warm-up batch
    engine.run_until_drained()
    torch.cuda.synchronize()
    ticks0, tokens0, dt0 = (engine.stats["ticks"], engine.stats["tokens"],
                            engine.stats["decode_s"])
    rng = np.random.default_rng(17)

    def requests():
        return [engine.submit(rng.integers(0, cfg.vocab_size, n).tolist(),
                              max_new_tokens=16)
                for n in rng.integers(4, 17, size=8)]
    _zero_counts()                                   # the main path starts
    first = requests()
    engine.run_until_drained()
    fresh = init_tree(zoo.get_model(cfg).specs(cfg)["lora"], gen,
                      cfg.dtype(), "cuda")
    engine.swap_adapter(_random_b(fresh, gen, 0.02))
    second = requests()
    engine.run_until_drained()
    counts = _counts()                               # the main path ends
    ticks = engine.stats["ticks"] - ticks0
    tokens = engine.stats["tokens"] - tokens0
    dt = engine.stats["decode_s"] - dt0
    for r in first + second:
        check(r.done and len(r.output) == 16,
              f"{arch} request {r.request_id}: {len(r.output)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.output),
              f"{arch} request {r.request_id}: token out of vocab")
    per_tick = 0 if cfg.mla else 4 * cfg.num_layers
    want = {k: 0 for k in counts} | {"lora_matmul": per_tick * ticks}
    check(counts == want, f"{arch} serving launches {counts} != {want}")
    # a tick reads every weight once (the dense dispatch reads every
    # expert) but the embedding's 8 rows
    nbytes = sum(t.numel() * t.element_size()
                 for t in tree_leaves(frozen) + tree_leaves(fresh))
    emb = frozen["embed"]
    nbytes -= (emb.shape[0] - 8) * emb.shape[1] * emb.element_size()
    floor_ms = nbytes / roofline.HBM_BW * 1e3
    out = dict(ticks=ticks, tokens=tokens, decode_s=dt,
               tokens_per_s=tokens / dt, ms_per_tick=dt / ticks * 1e3,
               floor_ms_per_tick=floor_ms, weight_bytes=nbytes,
               lora_launches_per_tick=counts["lora_matmul"] / ticks,
               launches=counts)

    # where a tick's time goes (phase 18d): 8 requests of 4 prompt and 4
    # new tokens, once for the ticks they take, once under the profiler
    def batch_of_8():
        for n in range(8):
            engine.submit([1 + n, 2, 3, 4], max_new_tokens=4)
        engine.run_until_drained()
    ticks0 = engine.stats["ticks"]
    batch_of_8()
    out["breakdown"] = device_breakdown(
        batch_of_8, per=engine.stats["ticks"] - ticks0, show=False)
    print(f"{arch} serving ({cfg.num_layers} layers, bf16): 16 requests in "
          f"2 batches, {ticks} ticks, {tokens} tokens in {dt:.3f}s -> "
          f"{tokens / dt:.1f} tokens/s, {dt / ticks * 1e3:.2f} ms/tick "
          f"(floor {floor_ms:.2f} ms: {nbytes / 1e9:.2f} GB of weights at "
          f"3.35 TB/s); LoRA launches {counts['lora_matmul']} "
          f"({counts['lora_matmul'] / ticks:.0f} a tick)", flush=True)
    return out, counts


def _moe_training(arch, cfg, frozen, gen, steps=10):
    """``make_train_step`` with the launcher's channel (``channel_params``,
    ``SketchPlan`` built once, ``batch_stream`` 8 x 64), lr 3e-3, bf16,
    from the LoRA init (B zero), as ``launch/train.py::_main`` runs it."""
    n_prefix = cfg.moe.first_dense_layers
    n_blocks = cfg.num_layers - n_prefix
    check(train.elsa_boundaries(cfg) == (1, 1),
          f"{arch}: cuts {train.elsa_boundaries(cfg)}")
    lora = init_tree(zoo.get_model(cfg).specs(cfg)["lora"], gen,
                     cfg.dtype(), "cuda")
    _, z = train.elsa_channel_specs(cfg)
    ch = train.channel_params(cfg, z, "cuda")
    ch["plan"] = SketchPlan(ch["bucket"], ch["sign"], z)
    opt = AdamW(lr=3e-3)
    opt_state = opt.init(lora)
    step = train.make_train_step(cfg, optimizer=opt, elsa_z=z)
    batches = train.batch_stream(cfg, 8, 64, "cuda")
    base = _memory_base()
    _zero_counts()                                   # the main path starts
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.time()
        batch = {**next(batches), "_channel": ch}
        lora, opt_state, loss = step(frozen, lora, opt_state, batch)
        losses.append(float(loss))                   # syncs with the device
        step_s.append(time.time() - t0)
    counts = _counts()                               # the main path ends
    peak = _peak_gib(base)
    per_step = {"ssop_apply": 8, "sketch_scatter": 4, "sketch_gather": 4,
                "lora_matmul": 0 if cfg.mla else 2 * 4 * n_blocks,
                "flash_attention": n_prefix + 2 * n_blocks}
    want = {k: steps * v for k, v in per_step.items()}
    check(all(np.isfinite(losses)), f"{arch} losses {losses}")
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    check(last < first, f"{arch}: loss did not fall: first 3 {first:.4f}, "
                        f"last 3 {last:.4f}")
    check(counts == want, f"{arch} training launches {counts} != {want}")
    ms = statistics.median(step_s[1:]) * 1e3
    print(f"{arch} training ({cfg.num_layers} layers, bf16, --elsa, cuts "
          f"(1, 1), 8 x 64): {steps} steps, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (first 3 {first:.4f}, last 3 {last:.4f}); step "
          f"{ms:.1f} ms (median of steps 2-{steps}; first "
          f"{step_s[0] * 1e3:.1f}) -> {512 / ms * 1e3:.0f} tokens/s; peak "
          f"{peak:.2f} GiB above the weights; launches per step "
          f"{ {k: v // steps for k, v in counts.items()} }", flush=True)
    return dict(steps=steps, losses=losses, step_ms=ms,
                first_step_ms=step_s[0] * 1e3, tokens_per_s=512 / ms * 1e3,
                peak_gib_above_weights=peak,
                launches_per_step={k: v // steps for k, v in counts.items()}
                ), counts


def moe_family_phase():
    """grok-1 and deepseek-v2 (the MoE family), one at a time: (a) one
    block's parity at full width in f32; (b) serving and (c) training of
    the depth-cut model (``MOE_DEPTH``) at full width in bf16, random
    weights from a seed."""
    out, launches = {}, {}
    for arch in MOE_DEPTH:
        name = arch.split("-")[0] + "-" + arch.split("-")[1]
        t0 = time.time()
        rec = {"parity": _moe_block_parity(arch)}
        cfg = get_config(arch).with_(num_layers=MOE_DEPTH[arch])
        gen = torch.Generator(device="cuda").manual_seed(0)
        frozen = init_tree(zoo.get_model(cfg).specs(cfg)["frozen"], gen,
                           cfg.dtype(), "cuda")
        lora = _random_b(init_tree(zoo.get_model(cfg).specs(cfg)["lora"],
                                   gen, cfg.dtype(), "cuda"), gen, 0.02)
        torch.cuda.synchronize()
        rec["weights_gib"] = torch.cuda.memory_allocated() / 2 ** 30
        print(f"{arch}: {cfg.num_layers} layers at full width, bf16: "
              f"{rec['weights_gib']:.2f} GiB on the card", flush=True)
        rec["serving"], launches[f"{name} serve"] = _moe_serving(
            arch, cfg, frozen, lora, gen)
        del lora
        rec["training"], launches[f"{name} train"] = _moe_training(
            arch, cfg, frozen, gen)
        del frozen
        torch.cuda.empty_cache()
        rec["seconds"] = time.time() - t0
        out[arch] = rec
    return out, launches


# ---------------------------------------------------------------------------
# 18. analysis and dry run
# ---------------------------------------------------------------------------

DRYRUN_DIR = os.path.join(OUT_DIR, "dryrun")


def start_dryrun():
    """``python -m repro_torch.launch.dryrun --arch A --elsa`` on the meta
    device for each assigned architecture A, each in a process of its own
    (no card: ``CUDA_VISIBLE_DEVICES`` is empty; one thread), started with
    the script so that their host minutes overlap the build; they are
    waited for before phase 3, so no timed phase shares the host with
    them.  Returns ``[(arch, process, log file)]``."""
    os.makedirs(DRYRUN_DIR, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": SRC, "CUDA_VISIBLE_DEVICES": "",
           "OMP_NUM_THREADS": "1"}
    procs = []
    for arch in dryrun.ASSIGNED:
        log = open(os.path.join(DRYRUN_DIR, f"{arch}.log"), "w")
        procs.append((arch, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--elsa", "--out-dir", DRYRUN_DIR], cwd=ROOT, env=env,
            stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def stop_dryrun(procs):
    for _, proc, log in procs:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        log.close()


def wait_dryrun(procs, timeout=600):
    """Waits for the dry run's processes; returns each one's exit code and
    the last line of its log."""
    t0 = time.time()
    out = {}
    for arch, proc, log in procs:
        proc.wait(timeout=max(1.0, timeout - (time.time() - t0)))
        log.close()
        with open(os.path.join(DRYRUN_DIR, f"{arch}.log")) as f:
            out[arch] = (proc.returncode, f.read().splitlines()[-20:])
    print(f"the dry run's {len(procs)} processes ended {time.time() - t0:.1f}s "
          f"after the build")
    return out


def dryrun_phase(ends):
    """18a: every (assigned arch x input shape) dry-run record is ``ok``,
    or ``skipped`` for ``skip_reason``'s reason; prints the roofline table
    and the host seconds."""
    for arch, (rc, tail) in ends.items():
        check(rc == 0, f"the dry run of {arch} exited {rc}: "
                       + "\n".join(tail))
    records = []
    for name in sorted(os.listdir(DRYRUN_DIR)):
        if name.endswith(".json"):
            records.append(roofline.load_record(
                os.path.join(DRYRUN_DIR, name)))
    check(len(records) == len(dryrun.ASSIGNED) * len(dryrun.INPUT_SHAPES),
          f"{len(records)} dry-run records")
    for rec in records:
        reason = dryrun.skip_reason(rec["arch"], rec["shape"])
        check(rec["status"] == ("skipped" if reason else "ok")
              and rec.get("reason") == reason,
              f"dry run {rec['arch']} {rec['shape']}: {rec['status']} "
              f"{rec.get('error', '')}")
        rec["roofline"] = roofline.roofline_terms(rec)
    print(roofline.make_table(records))
    host = sum(r.get("host_s", 0) for r in records)
    print(f"dry run on meta: {len(records)} records, {host:.1f} host s over "
          f"them; " + "; ".join(f"{arch}: {tail[-1]}"
                                for arch, (_, tail) in ends.items()))
    return [{k: v for k, v in r.items() if k not in ("traceback", "parsed")}
            for r in records]


def _phase8_step():
    """Phase 8's step on the card: full olmo-1b, bf16, the launcher's
    channel (plan built once), its first 8 x 64 batch, seed 0."""
    cfg = get_config("olmo-1b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    tree = init_tree(zoo.get_model(cfg).specs(cfg), gen, cfg.dtype(),
                     "cuda")
    _, z = train.elsa_channel_specs(cfg)
    ch = train.channel_params(cfg, z, "cuda")
    ch["plan"] = SketchPlan(ch["bucket"], ch["sign"], z)
    opt = AdamW(lr=3e-3)
    step = train.make_train_step(cfg, optimizer=opt, elsa_z=z)
    batch = {**next(train.batch_stream(cfg, 8, 64, "cuda")), "_channel": ch}
    return step, (tree["frozen"], tree["lora"], opt.init(tree["lora"]),
                  batch)


def _row_diff(a, b, n=20):
    keys = sorted(k for k in set(a.rows) | set(b.rows)
                  if a.rows.get(k) != b.rows.get(k))
    return [(k, a.rows.get(k), b.rows.get(k)) for k in keys[:n]]


def _card_peak(build, run):
    """The bytes ``build()`` allocates and the peak of ``run(*built)``
    above what was allocated before ``build``, from a reset after one
    warm-up run (the kernels built, cuBLAS's workspace in place)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    m0 = torch.cuda.memory_allocated()
    built = build()
    run(*built)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = run(*built)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - m0, out


def same_work_phase():
    """18b and 18c.  (b) Phase 8's full-width olmo-1b ``--elsa`` step counted
    on the card and dry-run on meta: flops, bytes and each kernel's calls
    (and declared work) equal, each kernel's calls the step's launches as
    phase 8 counts them.  (c) The dry run's peak of that step and of one
    llama3-8b serving tick at batch 8 (phase 5's cache of 128) against
    ``torch.cuda.max_memory_allocated()`` of the same work on the card,
    from a reset: within 10%."""
    out = {}
    shape = InputShape("phase 8", 64, 8, "train")
    meta, _ = dryrun.count("olmo-1b", shape, elsa=True, microbatches=1)
    launches = {}

    def counted_step(step, args):
        _zero_counts()
        c = op_cost.count(step, *args)[0]
        torch.cuda.synchronize()
        launches.update(_counts())
        return c
    peak, card = _card_peak(_phase8_step, counted_step)
    calls = {k: int(v[0]) for k, v in card.kernels.items()}
    print(f"olmo-1b --elsa step (bf16, 8 x 64), counted on the card: "
          f"{card.cost.flops:.6e} flops, {card.cost.bytes:.6e} bytes; on "
          f"meta {meta.cost.flops:.6e}, {meta.cost.bytes:.6e}; kernel calls "
          f"{calls}, launches {launches}")
    diff = _row_diff(card, meta)
    for k, a, b in diff:
        print(f"  differs: {k}: card {a}, meta {b}")
    check(not diff and (card.cost.flops, card.cost.bytes)
          == (meta.cost.flops, meta.cost.bytes),
          "the card's count of the step is not the meta dry run's")
    check(card.kernels == meta.kernels, f"kernels: card {card.kernels}, "
                                        f"meta {meta.kernels}")
    want = _per_step(get_config("olmo-1b").num_layers, remat=True)
    check(calls == launches == want, f"kernel calls {calls}, launches "
                                     f"{launches}, phase 8's {want}")
    out["olmo_step"] = dict(flops=card.cost.flops, bytes=card.cost.bytes,
                            kernels=card.kernels, launches=launches,
                            card_peak_bytes=peak,
                            dryrun_peak_bytes=meta.peak_bytes)

    cfg = get_config("llama3-8b")
    tick = InputShape("phase 5 tick", 128, 8, "decode")
    meta_tick, _ = dryrun.count("llama3-8b", tick)
    model = zoo.get_model(cfg)
    serve = make_serve_step(cfg, window=0, chunk=4096)   # dryrun.build's

    def weights():
        gen = torch.Generator(device="cuda").manual_seed(0)
        p = init_tree(model.specs(cfg), gen, cfg.dtype(), "cuda")
        cache = init_tree(model.cache_specs(cfg, 8, 128), gen, cfg.dtype(),
                          "cuda")
        tok = torch.ones((8, 1), dtype=torch.int64, device="cuda")
        return p["frozen"], p["lora"], cache, {"tokens": tok}

    def counted_tick(*args):
        return op_cost.count(serve, *args)[0]
    tick_peak, card_tick = _card_peak(weights, counted_tick)
    same = not _row_diff(card_tick, meta_tick) and \
        card_tick.kernels == meta_tick.kernels
    print(f"llama3-8b tick (bf16, batch 8, cache 128): card "
          f"{card_tick.cost.flops:.6e} flops, {card_tick.cost.bytes:.6e} "
          f"bytes; meta {meta_tick.cost.flops:.6e}, "
          f"{meta_tick.cost.bytes:.6e} ({'the same' if same else 'differ'})")
    out["llama_tick"] = dict(flops=card_tick.cost.flops,
                             bytes=card_tick.cost.bytes, same_count=same,
                             card_peak_bytes=tick_peak,
                             dryrun_peak_bytes=meta_tick.peak_bytes)
    torch.cuda.empty_cache()
    for name, rec in out.items():
        ratio = rec["dryrun_peak_bytes"] / rec["card_peak_bytes"]
        rec["peak_ratio"] = ratio
        print(f"peak of the {name.replace('_', ' ')}: dry run "
              f"{rec['dryrun_peak_bytes'] / 2 ** 30:.3f} GiB, card "
              f"{rec['card_peak_bytes'] / 2 ** 30:.3f} GiB (max allocated "
              f"above the bytes before its weights), ratio {ratio:.4f}")
        check(abs(ratio - 1) <= 0.10, f"{name}: the dry run's peak is "
                                      f"{ratio:.4f} of the card's")
    return out


def _print_breakdown(name, bd):
    print(f"{name}: device busy {bd['busy_ms']:.3f} ms, profiled wall "
          f"{bd['wall_ms']:.3f} ms, idle share {bd['idle_share']:.1%}, "
          f"{bd['kernels']:.0f} kernels (a step)")
    for us, n, key in bd["rows"][:10]:
        print(f"  {us / 1e3:8.3f} ms {us / 1e3 / bd['busy_ms']:6.1%}  "
              f"{n:5.0f}x  {key[:80]}")
    for g in bd["gaps"]:
        where = (f"host op {g['host_op']} (outermost {g['outer_host_op']})"
                 if g["host_op"] else "no host op open (between ops)")
        print(f"  idle gap {g['ms']:.3f} ms at {g['at_ms']:.1f} ms: {where}")


def shares_phase(t_prof, federation, olmo_step):
    """18e: for the olmo-1b step (phase 9's profile, 18b's count) and the
    bert-base client step (phase 10's profile and count; f32, as the
    federation runs it): model flops over (busy x peak) and over (wall x
    peak), and the counted roofline step over busy."""
    out = {}
    fed = federation["profile"]
    for name, cfg, dtype, shape, busy_ms, wall_ms, counted in (
            ("olmo-1b step", get_config("olmo-1b"), "bfloat16",
             InputShape("", 64, 8, "train"), t_prof["device_busy_ms"],
             t_prof["wall_ms"], olmo_step),
            ("bert-base client step", get_config("bert-base"), "float32",
             InputShape("", 128, 16, "train"), fed["device_busy_ms"],
             fed["wall_ms"], fed["counted"])):
        peak = roofline.PEAK_FLOPS[dtype]
        mf = roofline.model_flops(cfg, shape)
        step_ms, by = roofline.bound_ms(counted["flops"], counted["bytes"],
                                        dtype)
        rec = dict(model_flops=mf, peak_flops=peak, busy_ms=busy_ms,
                   wall_ms=wall_ms, mfu_busy=mf / (busy_ms / 1e3 * peak),
                   mfu_wall=mf / (wall_ms / 1e3 * peak),
                   roofline_step_ms=step_ms, roofline_bound_by=by,
                   roofline_over_busy=step_ms / busy_ms)
        out[name] = rec
        print(f"{name} ({dtype}, peak {peak:.3g} FLOP/s): model flops "
              f"{mf:.4e}; model_flops/(busy x peak) {rec['mfu_busy']:.2%} "
              f"(busy {busy_ms:.2f} ms); model_flops/(wall x peak) "
              f"{rec['mfu_wall']:.2%} (wall {wall_ms:.2f} ms); counted "
              f"roofline step {step_ms:.3f} ms ({by}) = "
              f"{rec['roofline_over_busy']:.1%} of busy")
    return out


def build_phase():
    """The four libraries, one nvcc each, started together."""
    t0 = time.time()
    libs = (lora_ops.library, ssop_ops.library, cs_ops.library,
            fa_ops.library)
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        for f in [pool.submit(lib) for lib in libs]:
            f.result()
    print(f"built and loaded {len(libs)} kernel libraries in "
          f"{time.time() - t0:.1f}s")


def _record_row(name, source, replaces, launches, row):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]}


def main():
    if "--channel-times-of" in sys.argv:
        with phase("1 device"):
            device_phase()
        with phase("3b channel kernel times"):
            channel_times()
        return
    with phase("1 device"):
        smi = device_phase()
    dry = start_dryrun()
    try:
        run_phases(smi, dry)
    finally:
        stop_dryrun(dry)


def run_phases(smi, dry):
    """Phases 2 to 18; ``dry`` are phase 18a's dry-run processes."""
    with phase("2 build"):
        build_phase()
        dry_ends = wait_dryrun(dry)
    with phase("3 kernel against plain version"):
        rows = kernel_phase()
        sweep = lora_cut_sweep()
    with phase("3b channel kernels against plain versions"):
        ch_rows = channel_kernel_phase()
        ch_sweep = channel_sweep()
    with phase("3c flash attention against plain version"):
        fa_rows = flash_kernel_phase()
    with phase("init full llama3-8b"):
        cfg = get_config("llama3-8b")
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = init_tree(zoo.get_model(cfg).specs(cfg), gen, cfg.dtype(),
                           "cuda")
        _random_b(params["lora"], gen, 0.02)
        torch.cuda.synchronize()
        print(f"weights on device: "
              f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    with phase("4 full-width parity"):
        parity_phase(params)
    path_calls = {}
    with phase("5 serving"), _recording_lora_calls(path_calls):
        serving, serve_launches = serving_phase(cfg, params)
    with phase("6 profile"):
        prof = profile_phase(cfg, params)
    del params
    torch.cuda.empty_cache()
    with phase("7 training parity"):
        t_parity = train_parity_phase()
    with phase("8 training"), _recording_lora_calls(path_calls):
        training, train_launches = train_phase()
    with phase("8b step-0 witness"):
        step0 = step0_phase(training["losses"][0])
    with phase("9 training profile"):
        t_prof = train_profile_phase()
    with phase("10 federation, batched"), _recording_lora_calls(path_calls):
        fed, federation, fed_launches = federation_phase()
    with phase("10r federation, reference backend"), \
            _recording_lora_calls(path_calls):
        fed_r, fed_ref, ref_launches = federation_reference_phase()
    with phase("10c one step on both backends"):
        cross = cross_backend_phase(fed, fed_r)
    del fed_r
    torch.cuda.empty_cache()
    with phase("13 the event runtime"), _recording_lora_calls(path_calls):
        runtime, runtime_launches = runtime_phase(fed, federation)
    del fed
    torch.cuda.empty_cache()
    with phase("14 update screening"), _recording_lora_calls(path_calls):
        screening, screening_launches = screening_phase()
    with phase("15 checkpoints"), _recording_lora_calls(path_calls):
        ckpts, ckpt_launches = checkpoint_phase(federation, screening)
    with phase("16 populations and telemetry"), \
            _recording_lora_calls(path_calls):
        populations, population_launches = population_phase(federation)
    with phase("10b split-training parity"):
        s_parity = split_parity_phase()
    with phase("12 causal-LM federation"), _recording_lora_calls(path_calls):
        causal, causal_launches = causal_lm_federation_phase()
    with phase("17 the MoE family"), _recording_lora_calls(path_calls):
        moe_family, moe_launches = moe_family_phase()
    with phase("11 every LoRA shape of the paths against plain version"):
        path_rows = path_shapes_phase(path_calls)
    with phase("18 analysis and dry run"):
        analysis = dict(dryrun=dryrun_phase(dry_ends),
                        same_work=same_work_phase())
        for name, bd in (
                ("olmo-1b step (phase 9)", t_prof["breakdown"]),
                ("bert-base run_clients call, a client step (phase 10)",
                 federation["profile"]["breakdown"]),
                ("causal-LM run_clients call, a client step (phase 12)",
                 causal["breakdown"]),
                ("grok-1 serving tick (phase 17)",
                 moe_family["grok-1-314b"]["serving"]["breakdown"])):
            _print_breakdown(name, bd)
        analysis["shares"] = shares_phase(
            t_prof, federation, analysis["same_work"]["olmo_step"])

    def pick(kernel, op, case="train", dtype="bfloat16"):
        return next(r for r in ch_rows if r["kernel"] == kernel
                    and r["op"] == op and r["case"] == case
                    and r["dtype"] == dtype)

    timed = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "max_abs_err", "copy_ms", "bytes_copy_ms")

    def by_path(name):
        out = {"train": train_launches[name],
               "federation": fed_launches[name],
               "federation reference": ref_launches[name],
               "runtime": runtime_launches[name],
               "screening": screening_launches[name],
               "checkpoints": ckpt_launches[name],
               "populations": population_launches[name],
               "causal-LM federation": causal_launches[name],
               **{path: c[name] for path, c in moe_launches.items()}}
        if name == "lora_matmul":
            out = {"serve": serve_launches, **out}
        return out

    q = next(r for r in rows if r["shape"] == "q" and r["dtype"] == "bfloat16")
    t512 = next(r for r in rows if r["shape"] == "train"
                and r["dtype"] == "bfloat16")
    t2048 = next(r for r in rows if r["shape"] == "fed")
    lora = _record_row("lora_matmul", "src/repro_torch/csrc/lora_matmul.cu",
                       "src/repro/kernels/lora/kernel.py:58",
                       sum(by_path("lora_matmul").values()), q)
    lora.update(shape="T=8 K=4096 O=4096 r=16 bfloat16 (q projection)",
                launches_by_path=by_path("lora_matmul"),
                at_train_shape={k: t512[k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "max_abs_err")} | {"shape": "T=512 K=2048 O=2048 r=16 "
                                                "bfloat16"},
                at_federation_shape={k: t2048[k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "max_abs_err")} | {"shape": "T=2048 K=768 O=768 r=8 "
                                                "float32"},
                at_grok_shapes=[{k: r_[k] for k in (
                    "shape", "T", "K", "O", "r", "ms", "plain_ms",
                    "library_ms", "bound_ms", "bound_by", "max_abs_err",
                    "route")} for r_ in rows if r_["shape"].startswith(
                        "grok")])
    kernels = [lora]
    for name, src, repl, fwd, bwd in (
            ("ssop_apply", "src/repro_torch/csrc/ssop.cu",
             "src/repro/kernels/ssop/kernel.py:40", "ssop forward",
             "ssop backward"),
            ("sketch_scatter", "src/repro_torch/csrc/count_sketch.cu",
             "src/repro/kernels/count_sketch/kernel.py:56", "compress",
             "median backward"),
            ("sketch_gather", "src/repro_torch/csrc/count_sketch.cu",
             "src/repro/kernels/count_sketch/kernel.py:107", "decompress",
             "compress backward")):
        row = _record_row(name, src, repl, sum(by_path(name).values()),
                          pick(name, fwd))
        b = pick(name, bwd)
        fed = {op: pick(name, op, "federation", "float32")
               for op in (fwd, bwd)}
        clm = {op: pick(name, op, "causal-LM", "float32")
               for op in (fwd, bwd)}
        moe_shapes = {case: {op: {k: r_[k] for k in timed + ("route",)}
                             for op in (fwd, bwd)
                             for r_ in [pick(name, op, case)]}
                      for case in ("grok-1", "deepseek-v2")}
        row.update(shape=f"{fwd}, T=512 D=2048 r=16 Y=3 Z=325 bfloat16",
                   launches_by_path=by_path(name),
                   backward={k: b[k] for k in timed} | {"op": bwd},
                   at_federation_shape={
                       op: {k: r_[k] for k in timed}
                       for op, r_ in fed.items()} | {
                       "shape": "T=2048 D=768 r=8 Y=3 Z=121 float32"},
                   at_causal_lm_shape={
                       op: {k: r_[k] for k in timed}
                       for op, r_ in clm.items()} | {
                       "shape": "T=512 D=2048 r=8 Y=3 Z=325 float32"},
                   at_grok_shape=moe_shapes["grok-1"] | {
                       "shape": "T=512 D=6144 r=16 Y=3 Z=975 bfloat16"},
                   at_deepseek_shape=moe_shapes["deepseek-v2"] | {
                       "shape": "T=512 D=5120 r=16 Y=3 Z=812 bfloat16"})
        row["copy_ms"] = pick(name, fwd)["copy_ms"]
        row["bytes_copy_ms"] = pick(name, fwd)["bytes_copy_ms"]
        if name == "sketch_gather":   # the composite of three library calls
            row["composite_ms"] = pick(name, fwd)["composite_ms"]
            row["at_federation_shape"][fwd]["composite_ms"] = \
                fed[fwd]["composite_ms"]
        kernels.append(row)
    bert_case = fa_rows[0]
    flash = _record_row("flash_attention",
                        "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:92",
                        sum(by_path("flash_attention").values()), bert_case)
    flash.update(shape="B=16 S=128 H=12 Dh=64 float32 non-causal (bert-base)",
                 launches_by_path=by_path("flash_attention"),
                 launches_per_step={
                     "federation client step, batched":
                         federation["launches_per_step"]["flash_attention"],
                     "federation client step, reference":
                         fed_ref["launches_per_step"]["flash_attention"],
                     "causal-LM federation client step":
                         causal["launches_per_step"]["flash_attention"],
                     "olmo-1b training step":
                         training["launches_per_step"]["flash_attention"],
                     **{f"{arch} training step": rec["training"][
                         "launches_per_step"]["flash_attention"]
                        for arch, rec in moe_family.items()}},
                 cases=[{k: r[k] for k in (
                     "case", "B", "S", "H", "KV", "Dh", "Dv", "dtype", "causal",
                     "window", "ms", "plain_ms", "library_ms", "bound_ms",
                     "bound_by", "max_abs_err", "grad_rel_err",
                     "grad_peak_mib", "bwd_ms", "library_bwd_ms")}
                     for r in fa_rows[1:]])
    kernels.append(flash)
    record = {"kernels": kernels}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "lora_shapes": rows, "lora_cut_sweep": sweep,
                   "channel_shapes": ch_rows, "channel_sweep": ch_sweep,
                   "flash_shapes": fa_rows, "serving": serving,
                   "profile": prof, "train_parity": t_parity,
                   "training": training, "step0_witness": step0,
                   "train_profile": t_prof, "lora_path_shapes": path_rows,
                   "federation": federation,
                   "federation_reference": fed_ref,
                   "cross_backend_step": cross, "runtime": runtime,
                   "screening": screening, "checkpoints": ckpts,
                   "populations": populations,
                   "split_parity": s_parity,
                   "causal_lm_federation": causal,
                   "moe_family": moe_family, "analysis": analysis,
                   **record}, f, indent=1, default=str)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
