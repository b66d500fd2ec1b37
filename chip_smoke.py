#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA H100 (sm_90a).

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on any failed check:

1. device: the card's name and power limit, compute capability (9, 0);
   TF32 off for matmuls and cuDNN;
2. build: the LoRA kernel library from ``src/repro_torch/csrc`` by nvcc;
3. kernel against its plain version at llama3-8b's decode shapes (and one
   ragged shape), in bf16 and f32, with times, bounds and a library yardstick;
4. full-width parity: llama3-8b decode steps, kernel path against plain path
   on the same weights (f32 at 2 layers, bf16 at full depth);
5. serving: full llama3-8b (32 layers, bf16, random weights from a seed) in
   ``ServingEngine`` through the kernel, then ``swap_adapter`` and a second
   batch; the kernel's launch count must be 4 projections x 32 layers x ticks;
6. where the time goes: a ``torch.profiler`` window over decode ticks.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository beside it, the script fails before printing either.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.lora import ops as lora_ops  # noqa: E402
from repro_torch.kernels.lora.ref import lora_matmul_ref  # noqa: E402
from repro_torch.launch.train import make_serve_step  # noqa: E402
from repro_torch.models import common, zoo  # noqa: E402
from repro_torch.models.params import init_tree  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12,    # tensor cores
              torch.float32: 67e12}      # CUDA cores (TF32 is off)
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


def _bound(T, K, O, r, dtype):
    el = torch.tensor([], dtype=dtype).element_size()
    nbytes = (T * K + K * O + K * r + r * O + T * O) * el
    flops = 2 * T * K * O + 2 * T * K * r + 2 * T * r * O
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_phase():
    """bf16: max abs error <= 2^-7 * max|y_plain|; f32: <= 1e-5 *
    max|y_plain| (rtol 1e-5 against the output's scale).  Both sides
    accumulate in fp32 and round once, so they differ only in the order of
    summation (and, in bf16, in at most one rounding of an output)."""
    shapes = [("q", 8, 4096, 4096, 16), ("k/v", 8, 4096, 1024, 16),
              ("o", 8, 4096, 4096, 16), ("ragged", 5, 4000, 1000, 16)]
    rows = []
    g = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        for name, T, K, O, r in shapes:
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
            bound_ms, bound_by = _bound(T, K, O, r, dtype)
            row = dict(shape=name, T=T, K=K, O=O, r=r,
                       dtype=str(dtype).removeprefix("torch."),
                       max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)
            rows.append(row)
            print(f"lora {name:6s} {row['dtype']:8s} T={T} K={K} O={O} r={r}: "
                  f"err {err:.3e} (tol {tol:.3e})  kernel {ms * 1e3:.2f} us  "
                  f"plain {plain_ms * 1e3:.2f} us  library {lib_ms * 1e3:.2f} us"
                  f"  bound {bound_ms * 1e3:.2f} us ({bound_by})  "
                  f"{bound_ms / ms:.1%} of bound", flush=True)
            del sets, w, a, b
    return rows


# ---------------------------------------------------------------------------
# 4. full-width parity
# ---------------------------------------------------------------------------

def _random_b(lora, gen, std):
    """Nonzero LoRA B (the spec init leaves it zero, which would leave the
    adapter half of the kernel unexercised)."""
    for layer in lora["blocks"]:
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

def profile_phase(cfg, params, n_ticks=8):
    """Where a tick's time goes, at batch 8: ``n_ticks`` greedy decode steps
    timed on the host clock (each ends in a device-to-host copy of the next
    tokens), then the same under ``torch.profiler`` for the device time of
    each kernel.  Idle share = 1 - device busy / unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(fresh())
    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue                                  # CPU ops: no double count
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        rows.append((dev_us / n_ticks, ev.count / n_ticks, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    check(busy_ms > 0, "the profiler saw no device time")
    print(f"profile ({cfg.name}, batch 8, {n_ticks} ticks): wall "
          f"{wall_ms:.2f} ms/tick without the profiler, device busy "
          f"{busy_ms:.2f} ms/tick -> idle share {1 - busy_ms / wall_ms:.1%}, "
          f"{sum(r[1] for r in rows):.0f} kernels/tick")
    for us, n, key in rows[:12]:
        print(f"  {us / 1e3:8.3f} ms/tick {us / 1e3 / busy_ms:6.1%}  "
              f"{n:5.0f}/tick  {key[:80]}")
    os.makedirs(OUT_DIR, exist_ok=True)
    prof.export_chrome_trace(os.path.join(OUT_DIR, "decode_trace.json"))
    lora_us = sum(us for us, _, key in rows if "lora_matmul" in key)
    return dict(wall_ms_per_tick=wall_ms, device_busy_ms_per_tick=busy_ms,
                idle_share=1 - busy_ms / wall_ms,
                lora_ms_per_tick=lora_us / 1e3,
                top_kernels=[dict(ms_per_tick=us / 1e3, per_tick=n, name=key)
                             for us, n, key in rows[:12]])


def main():
    with phase("1 device"):
        smi = device_phase()
    with phase("2 build"):
        t0 = time.time()
        lora_ops.library()
        print(f"built and loaded the lora_matmul library in "
              f"{time.time() - t0:.1f}s")
    with phase("3 kernel against plain version"):
        rows = kernel_phase()
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
    with phase("5 serving"):
        serving, launches = serving_phase(cfg, params)
    with phase("6 profile"):
        prof = profile_phase(cfg, params)

    q = next(r for r in rows if r["shape"] == "q" and r["dtype"] == "bfloat16")
    record = {"kernels": [{
        "name": "lora_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/lora_matmul.cu",
        "replaces": "src/repro/kernels/lora/kernel.py:58",
        "launches": launches, "max_abs_err": q["max_abs_err"],
        "ms": q["ms"], "plain_ms": q["plain_ms"], "bound_ms": q["bound_ms"],
        "bound_by": q["bound_by"], "library_ms": q["library_ms"],
        "shape": "T=8 K=4096 O=4096 r=16 bfloat16 (q projection)",
    }]}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "lora_shapes": rows, "serving": serving,
                   "profile": prof, **record}, f, indent=1)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
