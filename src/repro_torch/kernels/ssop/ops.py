"""Wrappers of the SS-OP rotation ``H -> H + (H U) W Uᵀ``.

:func:`ssop_apply_td` is the raw op: a CPU tensor goes to the plain version
(:func:`ssop_apply_ref`), a CUDA tensor launches the hand-written kernel
``csrc/ssop.cu`` or raises; it carries no gradient.  :func:`ssop_apply` and
:func:`ssop_apply_inverse`, the counterparts of the JAX package's
``repro/kernels/ssop/ops.py``, go through a ``torch.autograd.Function``
whose backward is the same op with Wᵀ (the map is linear in H; U and W are
constants and get no gradient), so on the card both directions launch the
kernel and nothing of size T x D is saved.

``ssop_apply_td.launches`` counts kernel launches, forward and backward.
A ``meta`` tensor takes the card's route up to the launch (the same checks
and output; nothing launched or counted), and every call declares
:func:`work` to the active cost counter (:mod:`repro_torch.kernels._cost`).

The library has two routes behind the same C functions, chosen by shape:
the tile route (D split over a cluster of blocks, tiles of H brought in by
bulk copies and read from device memory once) where rows of H are 16-byte
aligned and its shared memory fits, and the rows route (4 rows a block)
otherwise.  :func:`_tile_plan` is the C rule's twin, so that a CPU test
can pin the route and grid the paths' shapes take; :func:`_plan` asks the
built library itself.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _cost
from repro_torch.kernels.ssop.ref import ssop_apply_ref

MAX_RANK = 64
_SOURCES = ("ssop.cu",)
_FUNCS = {torch.bfloat16: "ssop_apply_bf16", torch.float32: "ssop_apply_f32"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_ROUTE_FUNCS = {torch.bfloat16: "ssop_apply_route_bf16",
                torch.float32: "ssop_apply_route_f32"}
_ROUTE_ARGTYPES = _ARGTYPES[:-1] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_PLAN_ARGTYPES = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
_ROUTES = {"rows": -1, "tile": 1}

# The tile route's rule in csrc/ssop.cu: kSliceCols, kMinCluster, kMaxCluster,
# kTargetBlocks, the rows a tile it tries, kMaxSmem and the block's warps
_SLICE_COLS = 1024
_MIN_CLUSTER = 2
_MAX_CLUSTER = 8
_TARGET_BLOCKS = 256
_TILE_ROWS = (32, 16, 8)
_MAX_SMEM = 232448
_WARPS = 8


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    sigs = {name: (_ARGTYPES, ctypes.c_int) for name in _FUNCS.values()}
    sigs.update({name: (_ROUTE_ARGTYPES, ctypes.c_int)
                 for name in _ROUTE_FUNCS.values()})
    sigs["ssop_plan"] = (_PLAN_ARGTYPES, ctypes.c_int)
    return _build.load("ssop", _SOURCES, sigs)


def work(T: int, D: int, r: int, dtype):
    """``(operations, bytes)`` of one call of T rows: H read and the output
    written once, U and W read once; ``4 T D r + 2 T r²`` operations (H U,
    then (H U) W, then its product with Uᵀ and the sum)."""
    nbytes = (2 * T * D + D * r + r * r) * dtype.itemsize
    return 4 * T * D * r + 2 * T * r * r, nbytes


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _tile_smem(Ds: int, R: int, r: int, el: int, C: int) -> int:
    """Bytes of shared memory of a tile block: the twin of ``tile_layout``
    in ``csrc/ssop.cu`` (U^T and the tile of H in rows of Ds + 16 / el
    elements, U's rows as they lie with 16 bytes of room for their shift,
    the partial sums of P padded by one column, the cluster's C partials
    of P, P, (P W)^T, W and two mbarriers)."""
    kR = next(k for k in (8, 16, 32, 64) if r <= k)
    ld, rows = Ds + 16 // el, _round_up(R, 16)
    n_red = _WARPS if el == 2 else 256 // ((R // 4) * (kR // 4))
    off = _round_up(kR * ld * el, 16) + _round_up(Ds * kR * el, 16) + 16
    off += _round_up(rows * ld * el, 16)
    off += _round_up(rows * kR * (n_red + 1) * 4, 16)
    off += C * R * kR * 4 + 2 * R * kR * 4 + kR * kR * 4
    return _round_up(off, 16) + 16


def _tile_plan(T: int, D: int, r: int, dtype, aligned: bool):
    """The tile route's (cluster size, rows a tile, slice width) for these
    shapes, or ``None`` for the rows route: the twin of ``tile_plan`` in
    ``csrc/ssop.cu``.  ``aligned``: h and out 16-byte aligned.  The tile
    route needs D x element size a multiple of 16 and its shared memory
    within a block's; D is split over
    ceil(D / 1024) blocks but at least 2 (at most ceil(D / 16), so that no
    block is without columns), or more (at most 8) where a slice does not
    fit, and a tile is the largest of 32, 16 and 8 rows that leaves 256
    blocks, else 8."""
    el = torch.empty((), dtype=dtype).element_size()
    if not aligned or (D * el) % 16 or not 1 <= r <= MAX_RANK:
        return None
    C = min(max(-(-D // _SLICE_COLS), _MIN_CLUSTER), -(-D // 16))
    for C in range(min(max(C, 1), _MAX_CLUSTER), _MAX_CLUSTER + 1):
        Ds = _round_up(-(-D // C), 16)
        R = next((c for c in _TILE_ROWS[:-1]
                  if -(-T // c) * C >= _TARGET_BLOCKS), _TILE_ROWS[-1])
        if _tile_smem(Ds, R, r, el, C) <= _MAX_SMEM:
            return C, R, Ds
    return None


def _plan(T: int, D: int, r: int, dtype, aligned: bool):
    """The C library's own answer for these shapes: ``None`` for the rows
    route, else (cluster size, rows a tile, tiles, slice width, shared
    memory bytes) of the tile route, one cluster a tile (needs the built
    library; held against :func:`_tile_plan` on the card)."""
    out = (ctypes.c_int * 6)()
    library().ssop_plan(T, D, r, torch.empty((), dtype=dtype).element_size(),
                        int(aligned), out)
    return tuple(out[1:]) if out[0] else None


def ssop_apply_td(h, u, w):
    """h: (..., D); u: (D, r); w: (r, r) -> H + (H U) W Uᵀ, no gradient.

    On CUDA, u and w must share h's dtype (bf16 or f32) and device, and
    ``1 <= r <= 64``."""
    D = h.shape[-1]
    r = u.shape[-1]
    if u.shape != (D, r) or w.shape != (r, r):
        raise ValueError(f"ssop shapes: h {tuple(h.shape)}, u "
                         f"{tuple(u.shape)}, w {tuple(w.shape)}")
    with _cost.declared("ssop_apply", work, h.numel() // max(D, 1), D, r,
                        h.dtype):
        if h.device.type == "cpu":
            return ssop_apply_ref(h, u, w)
        return _launch(h, u, w)


ssop_apply_td.launches = 0


def _launch(h, u, w, route=None, cluster=0, rows=0):
    """Launch the kernel on CUDA tensors; on ``meta`` tensors, the same
    checks and output and no launch.  ``route`` (``"rows"`` or
    ``"tile"``) and the tile route's ``cluster`` size and ``rows`` a tile
    force what the rule would choose, for timing and testing only
    (``chip_smoke.py``, the card tests)."""
    if h.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssop_apply: no kernel for device {h.device}")
    fn_name = _FUNCS.get(h.dtype)
    if fn_name is None:
        raise TypeError(f"ssop_apply kernel takes bf16 or f32, got {h.dtype}")
    for name, t in (("u", u), ("w", w)):
        if t.device != h.device or t.dtype != h.dtype:
            raise TypeError(f"ssop_apply: {name} is {t.dtype} on {t.device}, "
                            f"h is {h.dtype} on {h.device}")
    D, r = u.shape
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"ssop_apply kernel takes 1 <= r <= {MAX_RANK}, "
                         f"got {r}")
    hc, uc, wc = h.contiguous(), u.contiguous(), w.contiguous()
    T = hc.numel() // D
    out = torch.empty_like(hc)
    if T == 0 or h.device.type == "meta":
        return out
    args = (hc.data_ptr(), uc.data_ptr(), wc.data_ptr(), out.data_ptr(), T, D,
            r)
    forced = route is not None or cluster or rows
    if forced:
        fn = getattr(library(), _ROUTE_FUNCS[h.dtype])
        args += (_ROUTES.get(route, 0), cluster, rows)
    else:
        fn = getattr(library(), fn_name)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"ssop_apply kernel launch failed: CUDA error "
                           f"{err} (T={T}, D={D}, r={r}, {h.dtype}"
                           + (f", route {route}, cluster {cluster}, rows "
                              f"{rows})" if forced else ")"))
    ssop_apply_td.launches += 1
    return out


class SSOPFunction(torch.autograd.Function):
    """``H -> H + (H U) W Uᵀ`` with the gradient ``g -> g + (g U) Wᵀ Uᵀ``."""

    @staticmethod
    def forward(ctx, h, u, w):
        ctx.save_for_backward(u, w)
        return ssop_apply_td(h, u, w)

    @staticmethod
    def backward(ctx, g):
        u, w = ctx.saved_tensors
        return ssop_apply_td(g, u, w.T.contiguous()), None, None


def ssop_apply(h, u, v):
    """H -> H Qᵀ = H + (HU)(Vᵀ - I)Uᵀ.  h: (..., D); u and Vᵀ - I are cast
    to h's dtype."""
    w = v.T - torch.eye(v.shape[0], dtype=v.dtype, device=v.device)
    return SSOPFunction.apply(h, u.to(h.dtype), w.to(h.dtype))


def ssop_apply_inverse(h, u, v):
    """H -> H Q = H + (HU)(V - I)Uᵀ (the exact inverse, Q orthogonal)."""
    w = v - torch.eye(v.shape[0], dtype=v.dtype, device=v.device)
    return SSOPFunction.apply(h, u.to(h.dtype), w.to(h.dtype))
