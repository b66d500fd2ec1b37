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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssop.ref import ssop_apply_ref

MAX_RANK = 64
_SOURCES = ("ssop.cu",)
_FUNCS = {torch.bfloat16: "ssop_apply_bf16", torch.float32: "ssop_apply_f32"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    return _build.load("ssop", _SOURCES, {
        name: (_ARGTYPES, ctypes.c_int) for name in _FUNCS.values()})


def ssop_apply_td(h, u, w):
    """h: (..., D); u: (D, r); w: (r, r) -> H + (H U) W Uᵀ, no gradient.

    On CUDA, u and w must share h's dtype (bf16 or f32) and device, and
    ``1 <= r <= 64``."""
    D = h.shape[-1]
    r = u.shape[-1]
    if u.shape != (D, r) or w.shape != (r, r):
        raise ValueError(f"ssop shapes: h {tuple(h.shape)}, u "
                         f"{tuple(u.shape)}, w {tuple(w.shape)}")
    if h.device.type == "cpu":
        return ssop_apply_ref(h, u, w)
    return _launch(h, u, w)


ssop_apply_td.launches = 0


def _launch(h, u, w):
    if h.device.type != "cuda":
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
    if T == 0:
        return out
    fn = getattr(library(), fn_name)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = fn(hc.data_ptr(), uc.data_ptr(), wc.data_ptr(), out.data_ptr(),
                 T, D, r, stream)
    if err != 0:
        raise RuntimeError(f"ssop_apply kernel launch failed: CUDA error "
                           f"{err} (T={T}, D={D}, r={r}, {h.dtype})")
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
