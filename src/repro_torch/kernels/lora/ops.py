"""Wrapper of the fused LoRA projection ``y = x W + s (x A) B``.

A CPU tensor goes to the plain version (:func:`lora_matmul_ref`); a CUDA
tensor launches the hand-written kernel ``csrc/lora_matmul.cu`` or raises.
There is no fallback from the kernel to the plain version.

The projection is a ``torch.autograd.Function``.  W is frozen (no dW); the
backward computes ``dx = g Wᵀ + s (g Bᵀ) Aᵀ``, ``dA = s xᵀ (g Bᵀ)`` and
``dB = s (x A)ᵀ g`` as plain ``torch.matmul`` products: the JAX package
has no backward kernel for LoRA and leaves these products to XLA, so they
are plain products here too (a hand-written backward is in ROADMAP.md's
perf queue).

``lora_matmul.launches`` counts kernel launches (never plain-version
calls), so a run can show that its projections went through the kernel.
A ``meta`` tensor takes the card's route up to the launch: the same checks
and the same output, then nothing is launched or counted (the dry run,
:mod:`repro_torch.launch.dryrun`).  Every call declares :func:`work` to the
active cost counter (:mod:`repro_torch.kernels._cost`).

The library has two routes behind the same C functions, chosen by shape:
the decode kernels (8 rows of x a block, K split over a cluster) and, from
T = ``_TILE_MIN_ROWS`` rows on when the 16-byte copies hold and r is a
multiple of 8, the tile kernels (128 rows a block; bf16 on ``wgmma`` fed by
TMA, f32 on fp32 FMAs).
:func:`_uses_tiles` is the C rule's twin, so that a CPU test can pin the
route each path's shapes take; :func:`_plan` asks the built library itself.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _cost
from repro_torch.kernels.lora.ref import lora_matmul_ref

MAX_RANK = 64
_SOURCES = ("lora_matmul.cu",)
_FUNCS = {torch.bfloat16: "lora_matmul_bf16", torch.float32: "lora_matmul_f32"}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_ROUTE_FUNCS = {torch.bfloat16: "lora_matmul_route_bf16",
                torch.float32: "lora_matmul_route_f32"}
_ROUTE_ARGTYPES = _ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_void_p]
_PLAN_ARGTYPES = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]

# The cut of the route rule of csrc/lora_matmul.cu (kTileMinRows)
_TILE_MIN_ROWS = 64
_ROUTES = {"decode": 1, "tile": 2}


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    sigs = {name: (_ARGTYPES, ctypes.c_int) for name in _FUNCS.values()}
    sigs.update({name: (_ROUTE_ARGTYPES, ctypes.c_int)
                 for name in _ROUTE_FUNCS.values()})
    sigs["lora_matmul_plan"] = (_PLAN_ARGTYPES, ctypes.c_int)
    return _build.load("lora_matmul", _SOURCES, sigs)


def work(T: int, K: int, O: int, r: int, dtype):
    """``(operations, bytes)`` of one call of T rows: each of x, W, A, B
    and y moved once, ``2 T K O + 2 T K r + 2 T r O`` operations."""
    nbytes = (T * K + K * O + K * r + r * O + T * O) * dtype.itemsize
    return 2 * T * K * O + 2 * T * K * r + 2 * T * r * O, nbytes


def _uses_tiles(T: int, K: int, O: int, r: int, dtype, aligned: bool) -> bool:
    """Whether a call takes the tile kernels: T rows reach the cut, the
    16-byte copies hold (``aligned``: K and O multiples of 16 bytes' worth
    of elements of ``dtype``, x, w and a 16-byte aligned) and r is a
    multiple of 8 (A's rows are read by TMA).  The twin of ``uses_tiles`` in
    ``csrc/lora_matmul.cu``; K, O and dtype enter only through ``aligned``
    (both types share the cut: phase 3's sweep)."""
    return bool(aligned) and r % 8 == 0 and T >= _TILE_MIN_ROWS


def _plan(T: int, K: int, O: int, r: int, dtype, aligned: bool):
    """The C library's own answer for these shapes: ``None`` for the decode
    kernels, else (rows, columns, grid x, grid y, grid z) of a tile kernel,
    z the K split (needs the built library; held against
    :func:`_uses_tiles` on the card)."""
    out = (ctypes.c_int * 6)()
    library().lora_matmul_plan(T, K, O, r, torch.empty((), dtype=dtype)
                               .element_size(), int(aligned), out)
    return tuple(out[1:]) if out[0] else None


def lora_matmul(x, w, a, b, scale: float):
    """x: (..., K); w: (K, O); a: (K, r); b: (r, O) -> (..., O).

    ``r`` may be 0 (no adapter).  On CUDA all four tensors must share
    ``x``'s dtype (bf16 or f32) and be contiguous, and ``r <= 64``.
    """
    K = x.shape[-1]
    O = w.shape[-1]
    r = a.shape[-1]
    if w.shape != (K, O) or a.shape != (K, r) or b.shape != (r, O):
        raise ValueError(f"lora_matmul shapes: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}")
    return LoRAMatmulFunction.apply(x, w, a, b, float(scale))


lora_matmul.launches = 0


class LoRAMatmulFunction(torch.autograd.Function):
    """``x W + s (x A) B`` with gradients for x, A and B (W is frozen)."""

    @staticmethod
    def forward(ctx, x, w, a, b, scale):
        ctx.save_for_backward(x, w, a, b)
        ctx.scale = scale
        K, O = w.shape
        with _cost.declared("lora_matmul", work, x.numel() // max(K, 1), K,
                            O, a.shape[1], x.dtype):
            if x.device.type == "cpu":
                return lora_matmul_ref(x, w, a, b, scale)
            return _launch(x, w, a, b, scale)

    @staticmethod
    def backward(ctx, g):
        x, w, a, b = ctx.saved_tensors
        if ctx.needs_input_grad[1]:
            raise NotImplementedError(
                "lora_matmul: W is a frozen weight and gets no gradient")
        K, O = w.shape
        x2, g2 = x.reshape(-1, K), g.reshape(-1, O)
        gs = g2 * ctx.scale                               # (T, O)
        gb = gs @ b.T                                     # (T, r)
        dx = da = db = None
        if ctx.needs_input_grad[0]:
            dx = (g2 @ w.T + gb @ a.T).reshape(x.shape)
        if ctx.needs_input_grad[2]:
            da = x2.T @ gb
        if ctx.needs_input_grad[3]:
            db = (x2 @ a).T @ gs
        return dx, None, da, db, None


def _launch(x, w, a, b, scale: float, route=None):
    """Launch the kernel on CUDA tensors; on ``meta`` tensors, the same
    checks and output and no launch.  ``route`` is for timing and
    testing the routes only (``chip_smoke.py``, the card tests): ``None``
    lets the shape choose, as every caller in the port does; ``"decode"``
    or ``"tile"`` forces a route, an int a tile kernel's width."""
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"lora_matmul: no kernel for device {x.device}")
    fn_name = _FUNCS.get(x.dtype)
    if fn_name is None:
        raise TypeError(f"lora_matmul kernel takes bf16 or f32, got {x.dtype}")
    for name, t in (("w", w), ("a", a), ("b", b)):
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError(f"lora_matmul: {name} is {t.dtype} on {t.device}, "
                            f"x is {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"lora_matmul: {name} is not contiguous")
    if not x.is_contiguous():
        raise ValueError("lora_matmul: x is not contiguous")
    K, O, r = w.shape[0], w.shape[1], a.shape[1]
    if r > MAX_RANK:
        raise ValueError(f"lora_matmul kernel takes rank <= {MAX_RANK}, got {r}")
    T = x.numel() // K
    y = torch.empty(x.shape[:-1] + (O,), dtype=x.dtype, device=x.device)
    if T == 0 or O == 0 or x.device.type == "meta":
        return y
    n_vec = 16 // x.element_size()
    vec = (K % n_vec == 0 and O % n_vec == 0
           and all(t.data_ptr() % 16 == 0 for t in (x, w, a)))
    args = (x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            y.data_ptr(), T, K, O, r, float(scale), int(vec))
    if route is not None:
        fn_name = _ROUTE_FUNCS[x.dtype]
        args += (_ROUTES.get(route, route),)
    fn = getattr(library(), fn_name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"lora_matmul kernel launch failed: CUDA error "
                           f"{err} (T={T}, K={K}, O={O}, r={r}, {x.dtype}, "
                           f"route {route})")
    lora_matmul.launches += 1
    return y
