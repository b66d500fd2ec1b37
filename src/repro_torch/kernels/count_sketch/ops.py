"""Wrappers of the count-sketch kernels: compress (a signed scatter by
bucket) and median decode (a signed gather and the median over the hash
rows), each a ``torch.autograd.Function`` whose backward is the other
kernel in its second mode:

- :func:`sketch_compress` forward is the scatter kernel, its backward the
  gather kernel summing over y;
- :func:`sketch_decompress` forward is the gather kernel with the median,
  its backward the scatter kernel weighting each feature by the median's
  routing, recomputed from the saved sketch (nothing of size T x Y x D is
  saved).

The raw ops :func:`sketch_scatter` and :func:`sketch_gather` send a CPU
tensor to the plain versions (``ref.py``) and launch the kernels of
``csrc/count_sketch.cu`` on a CUDA tensor, or raise; they carry no gradient.
Their ``launches`` attributes count kernel launches.  A ``meta`` tensor (and
plan) takes the card's route up to the launch (the same checks and output;
nothing launched or counted), and every call declares :func:`work` to the
active cost counter (:mod:`repro_torch.kernels._cost`).

A plan is any object with ``bucket`` (Y, D) int32, ``sign`` (Y, D) float32,
``z``, the inverse index ``ptr`` (Y Z + 1,) / ``sidx`` (Y D,) int32 (each
entry d signed: ``~d`` where the sign is -1), the lists' ``order``
(Y Z,) int32, longest first, and the packed index ``gidx`` (Y, D) int32
(``bucket``, or ``~bucket`` where the sign is -1), that
:class:`repro_torch.core.sketch.SketchPlan` builds.

The scatter has two routes behind the same C functions: the tile route (R
rows a block, copied in by bulk copies; the median backward's network run
once a column into shared memory) wherever its shared memory fits, else
the first, simpler kernel (4 rows a block, the rows route).  :func:`_scatter_plan` is
the C rule's twin and :func:`_scatter_smem` its shared-memory layout's, so
that a CPU test can pin both; :func:`_plan_scatter` asks the built library.
The gather has one kernel, a tile of R rows by a slice of Dc columns a
block (rows of u by bulk copies, ``gidx`` by 16-byte loads, 16-byte
stores); :func:`_gather_plan` and :func:`_gather_smem` are its rule's and
layout's twins, :func:`_plan_gather` the library's answer (with the grid).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, _cost
from repro_torch.kernels.count_sketch.ref import (compress_ref, decompress_ref,
                                                  gather_sum_ref,
                                                  median_backward_ref)

MAX_Y = 8
ROWS_PER_BLOCK = 4                   # csrc/count_sketch.cu kRows
MAX_SHARED_BYTES = 232448            # per block on sm_90
# the scatter's tile route: kMaxScatterRows (compress, the median backward)
# and kScatterTargetBlocks
_SCATTER_MAX_ROWS = (8, 4)
_SCATTER_TARGET_BLOCKS = 128
# the gather: kGatherRuleRows, kGatherTargetBlocks, kGatherMaxCols and
# kGatherThreads (also the most column runs a forced tile may have)
_GATHER_RULE_ROWS = 8
_GATHER_TARGET_BLOCKS = 256
_GATHER_MAX_COLS = 512
_GATHER_THREADS = 256
_SOURCES = ("count_sketch.cu",)
_V = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"sketch_scatter_plan": ([_I] * 6 + [ctypes.POINTER(_I)], _I),
               "sketch_gather_plan": ([_I] * 7 + [ctypes.POINTER(_I)], _I)}
for _t in ("bf16", "f32"):
    _SIGNATURES[f"sketch_scatter_{_t}"] = ([_V] * 8 + [_I] * 5 + [_V], _I)
    _SIGNATURES[f"sketch_scatter_route_{_t}"] = ([_V] * 8 + [_I] * 6 + [_V],
                                                 _I)
    _SIGNATURES[f"sketch_gather_{_t}"] = ([_V] * 3 + [_I] * 7 + [_V], _I)
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    return _build.load("count_sketch", _SOURCES, _SIGNATURES)


def work(op: str, T: int, D: int, Y: int, Z: int, dtype):
    """``(operations, bytes)`` of one call over T rows, ``op`` one of
    ``"compress"`` and ``"median backward"`` (the scatter), ``"decompress"``
    and ``"compress backward"`` (the gather): each input read once and each
    output written once, the plan's arrays (ptr, sidx, order, bucket, sign)
    at 4 bytes an entry; the gather reads only the packed index (Y D
    entries)."""
    el = dtype.itemsize
    TD, TYZ, YD, ptr = T * D, T * Y * Z, Y * D, Y * Z + 1
    nbytes, ops = {
        "compress": ((TD + TYZ) * el + (ptr + 2 * YD) * 4, 2 * T * YD),
        "median backward": ((TD + 2 * TYZ) * el + (ptr + 3 * YD) * 4,
                            2 * T * YD),
        "decompress": ((TYZ + TD) * el + YD * 4, TD * Y * Y),
        "compress backward": ((TYZ + TD) * el + YD * 4, 2 * T * YD),
    }[op]
    return ops, nbytes


def _plan_shapes(plan):
    Y, D = plan.bucket.shape
    return Y, D, plan.z


def _round16(a: int) -> int:
    return -(-a // 16) * 16


def _scatter_smem(rows: int, D: int, Y: int, Z: int, median_bwd: bool,
                  el: int) -> int:
    """Bytes of dynamic shared memory of a tile-route scatter block of
    ``rows`` rows: the twin of ``scatter_layout`` in ``csrc/count_sketch.cu``
    (the mbarrier, the plan's ptr, order and sidx, the rows of x and, for
    the median backward, of u, each run with 16 bytes of room for its
    alignment, the first stage's rows x Y x D fp32 values, and the rows of
    the output)."""
    n = 16 + _round16((Y * Z + 1) * 4) + 16 + _round16(Y * Z * 4) + 16
    n += _round16(Y * D * 4) + 16 + _round16(rows * D * el) + 16
    if median_bwd:
        n += _round16(rows * Y * Z * el) + 16 + rows * Y * D * 4
    return n + _round16(rows * Y * Z * el)


def _scatter_plan(T: int, D: int, Y: int, Z: int, median_bwd: bool, dtype):
    """The scatter's route for these shapes: the tile route's rows a block
    (the most of 8, 4, 2 and 1 for compress, of 4, 2 and 1 for the median
    backward, that leave 128 blocks, halved until its shared memory fits),
    0 for the rows route (4 rows a block, where no tile fits but 4 (D
    [+ Y Z]) floats do), ``None`` where neither fits: the twin of
    ``scatter_plan`` in ``csrc/count_sketch.cu``."""
    el = torch.empty((), dtype=dtype).element_size()
    rows, cand = 1, _SCATTER_MAX_ROWS[int(median_bwd)]
    while cand > 1:
        if -(-T // cand) >= _SCATTER_TARGET_BLOCKS:
            rows = cand
            break
        cand //= 2
    while rows > 1 and _scatter_smem(rows, D, Y, Z, median_bwd,
                                     el) > MAX_SHARED_BYTES:
        rows //= 2
    if _scatter_smem(rows, D, Y, Z, median_bwd, el) <= MAX_SHARED_BYTES:
        return rows
    floats = D + (Y * Z if median_bwd else 0)
    return 0 if ROWS_PER_BLOCK * floats * 4 <= MAX_SHARED_BYTES else None


def _plan_scatter(T: int, D: int, Y: int, Z: int, median_bwd: bool, dtype):
    """The C library's own answer: (rows a block or 0 for the rows route,
    blocks, shared memory bytes), or ``None`` where no route fits (needs the
    built library; held against :func:`_scatter_plan` on the card)."""
    out = (ctypes.c_int * 3)()
    library().sketch_scatter_plan(T, D, Y, Z, int(median_bwd),
                                  torch.empty((), dtype=dtype).element_size(),
                                  out)
    return None if out[0] < 0 else tuple(out)


def _gather_smem(rows: int, Y: int, Z: int, el: int) -> int:
    """Bytes of dynamic shared memory of a gather block of ``rows`` rows:
    the twin of ``gather_smem`` in ``csrc/count_sketch.cu`` (an mbarrier a
    row, and the rows of u with 16 bytes of room for their alignment)."""
    return _round16(rows * 8) + _round16(rows * Y * Z * el) + 16


def _gather_plan(T: int, D: int, Y: int, Z: int, dtype):
    """The gather's tile for these shapes, ``(rows, cols)``: D in the fewest
    slices of at most 512 columns, split evenly and rounded up to the
    thread's 16-byte run of columns; the most of 8, 4, 2 and 1 rows a
    block that leave 256 blocks, halved until the rows fit in shared
    memory; ``None`` where one row does not fit.  The twin of
    ``gather_plan`` in ``csrc/count_sketch.cu``."""
    el = torch.empty((), dtype=dtype).element_size()
    run = 16 // el
    slices = -(-D // _GATHER_MAX_COLS)
    rows, cand = 1, _GATHER_RULE_ROWS
    while cand > 1:
        if -(-T // cand) * slices >= _GATHER_TARGET_BLOCKS:
            rows = cand
            break
        cand //= 2
    while rows > 1 and _gather_smem(rows, Y, Z, el) > MAX_SHARED_BYTES:
        rows //= 2
    if _gather_smem(rows, Y, Z, el) > MAX_SHARED_BYTES:
        return None
    return rows, -(-(-(-D // slices)) // run) * run


def _plan_gather(T: int, D: int, Y: int, Z: int, dtype, rows: int = 0,
                 cols: int = 0):
    """The C library's own answer: (rows, cols, blocks, shared memory bytes,
    threads a block) of the rule's tile, or of the tile ``rows`` x ``cols``
    where both are given, or ``None`` where it does not fit (needs the built
    library; held against :func:`_gather_plan` on the card)."""
    out = (ctypes.c_int * 5)()
    library().sketch_gather_plan(T, D, Y, Z,
                                 torch.empty((), dtype=dtype).element_size(),
                                 rows, cols, out)
    return None if out[0] < 0 else tuple(out)


def sketch_scatter(x, plan, u=None):
    """Compress x (..., D) -> (..., Y, Z); with ``u`` (..., Y, Z), the
    median decode's backward instead: x is the gradient of the decoded
    (..., D) estimate of ``u``.  No gradient."""
    Y, D, Z = _plan_shapes(plan)
    if x.shape[-1] != D or (u is not None
                            and u.shape != x.shape[:-1] + (Y, Z)):
        raise ValueError(f"sketch_scatter shapes: x {tuple(x.shape)}, u "
                         f"{None if u is None else tuple(u.shape)}, plan "
                         f"Y={Y} D={D} Z={Z}")
    T = math.prod(x.shape[:-1])
    with _cost.declared("sketch_scatter", work, "compress" if u is None
                        else "median backward", T, D, Y, Z, x.dtype):
        if x.device.type == "cpu":
            if u is None:
                return compress_ref(x, plan.bucket, plan.sign, Z)
            return median_backward_ref(x, u, plan.bucket, plan.sign)
        out = torch.empty(x.shape[:-1] + (Y, Z), dtype=x.dtype,
                          device=x.device)
        if _launch("scatter", x, u, plan, out, T):
            sketch_scatter.launches += 1
        return out


sketch_scatter.launches = 0


def sketch_gather(u, plan, *, median: bool = True):
    """u (..., Y, Z) -> (..., D): the median decode, or with
    ``median=False`` the sum over y (compress's backward).  No gradient."""
    Y, D, Z = _plan_shapes(plan)
    if u.shape[-2:] != (Y, Z):
        raise ValueError(f"sketch_gather shapes: u {tuple(u.shape)}, plan "
                         f"Y={Y} D={D} Z={Z}")
    T = math.prod(u.shape[:-2])
    with _cost.declared("sketch_gather", work, "decompress" if median
                        else "compress backward", T, D, Y, Z, u.dtype):
        if u.device.type == "cpu":
            if median:
                return decompress_ref(u, plan.bucket, plan.sign)
            return gather_sum_ref(u, plan.bucket, plan.sign)
        out = torch.empty(u.shape[:-2] + (D,), dtype=u.dtype,
                          device=u.device)
        if _launch("gather", u, None, plan, out, T,
                   mode=0 if median else 1):
            sketch_gather.launches += 1
        return out


sketch_gather.launches = 0


def _launch(kind, x, u, plan, out, n_rows: int, mode=0, rows=None,
            cols=None) -> bool:
    """Check the operands and launch the kernel over ``n_rows`` rows (of
    D features for the scatter's input, of Y x Z for the gather's) into
    ``out``; returns whether it launched (no rows, or ``meta`` tensors,
    launch nothing).
    ``rows`` forces the scatter's route (a tile route's rows a block, or
    ``"rows"`` for the rows route), ``rows`` and ``cols`` (both or neither)
    the gather's tile, for timing and testing only."""
    if kind == "gather" and (rows is None) != (cols is None):
        raise ValueError(f"sketch_gather: a forced tile needs rows and cols, "
                         f"got rows={rows}, cols={cols}")
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"sketch_{kind}: no kernel for device {x.device}")
    suffix = _SUFFIX.get(x.dtype)
    if suffix is None:
        raise TypeError(f"sketch_{kind} kernel takes bf16 or f32, got "
                        f"{x.dtype}")
    Y, D, Z = _plan_shapes(plan)
    if not 1 <= Y <= MAX_Y:
        raise ValueError(f"sketch_{kind} kernel takes 1 <= Y <= {MAX_Y}, "
                         f"got {Y}")
    if u is not None and (u.dtype != x.dtype or u.device != x.device):
        raise TypeError(f"sketch_{kind}: u is {u.dtype} on {u.device}, x "
                        f"is {x.dtype} on {x.device}")
    if kind == "scatter":
        wants = [("bucket", plan.bucket, torch.int32),
                 ("sign", plan.sign, torch.float32),
                 ("ptr", plan.ptr, torch.int32),
                 ("sidx", plan.sidx, torch.int32),
                 ("order", plan.order, torch.int32)]
    else:
        wants = [("gidx", plan.gidx, torch.int32)]
    for name, t, dtype in wants:
        if t.device != x.device or t.dtype != dtype or not t.is_contiguous():
            raise TypeError(f"sketch_{kind}: plan.{name} must be contiguous "
                            f"{dtype} on {x.device}, got {t.dtype} on "
                            f"{t.device}")
    if kind == "scatter":
        fits = _scatter_plan(n_rows, D, Y, Z, u is not None,
                             x.dtype) is not None
    else:
        fits = _gather_plan(n_rows, D, Y, Z, x.dtype) is not None
    if not fits:
        raise ValueError(f"sketch_{kind}: D={D}, Y*Z={Y * Z} need more "
                         f"shared memory than a block has")
    xc = x.contiguous()
    if n_rows == 0 or x.device.type == "meta":
        return False
    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if kind == "scatter":
            uc = u.contiguous() if u is not None else None
            args = (xc.data_ptr(), None if uc is None else uc.data_ptr(),
                    plan.ptr.data_ptr(), plan.order.data_ptr(),
                    plan.sidx.data_ptr(),
                    plan.sign.data_ptr(), plan.bucket.data_ptr(),
                    out.data_ptr(), n_rows, D, Y, Z, 0 if u is None else 1)
            if rows is None:
                err = getattr(lib, f"sketch_scatter_{suffix}")(*args, stream)
            else:
                err = getattr(lib, f"sketch_scatter_route_{suffix}")(
                    *args, -1 if rows == "rows" else rows, stream)
        else:
            err = getattr(lib, f"sketch_gather_{suffix}")(
                xc.data_ptr(), plan.gidx.data_ptr(), out.data_ptr(), n_rows,
                D, Y, Z, mode, rows or 0, cols or 0, stream)
    if err != 0:
        raise RuntimeError(f"sketch_{kind} kernel launch failed: CUDA error "
                           f"{err} (rows={n_rows}, D={D}, Y={Y}, Z={Z}, "
                           f"{x.dtype})")
    return True


class CompressFunction(torch.autograd.Function):
    """h (..., D) -> sketch (..., Y, Z); backward: the signed gather-sum."""

    @staticmethod
    def forward(ctx, h, plan):
        ctx.plan = plan
        return sketch_scatter(h, plan)

    @staticmethod
    def backward(ctx, g):
        return sketch_gather(g, ctx.plan, median=False), None


class DecompressFunction(torch.autograd.Function):
    """sketch (..., Y, Z) -> median estimate (..., D); backward: the
    median-weighted signed scatter."""

    @staticmethod
    def forward(ctx, u, plan):
        ctx.plan = plan
        ctx.save_for_backward(u)
        return sketch_gather(u, plan, median=True)

    @staticmethod
    def backward(ctx, g):
        (u,) = ctx.saved_tensors
        return sketch_scatter(g, ctx.plan, u=u), None


def sketch_compress(h, plan):
    """h: (..., D) -> (..., Y, Z), in h's dtype."""
    return CompressFunction.apply(h, plan)


def sketch_decompress(u, plan):
    """u: (..., Y, Z) -> (..., D) median estimates, in u's dtype."""
    return DecompressFunction.apply(u, plan)
