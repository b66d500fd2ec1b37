"""Wrappers of the flash-attention kernel.

:func:`flash_attention_fwd` is the raw forward: a CPU tensor goes to the
plain version (:func:`~repro_torch.kernels.flash_attention.ref.attention_ref`),
a CUDA tensor launches the hand-written kernel ``csrc/flash_attention.cu``
or raises; it returns ``(o, m, l)`` and carries no gradient.
:func:`flash_attention`, the counterpart of the JAX package's
``repro/kernels/flash_attention/ops.py::flash_attention``, goes through
:class:`FlashAttentionFunction`, which saves only q, k, v, o, m and l and
recomputes the probabilities one kv chunk at a time in its backward, as the
JAX package's custom VJP ``models/common.py::_chunked_attn`` does.  That
backward is plain PyTorch on both devices: the JAX package has no backward
kernel either (a hand-written one is in ROADMAP.md's perf queue).

``flash_attention_fwd.launches`` counts kernel launches (never plain-version
calls).  A ``meta`` tensor takes the card's route up to the launch (the
same checks and outputs; nothing launched or counted), and every forward
declares :func:`work` to the active cost counter
(:mod:`repro_torch.kernels._cost`); the plain backward's products are
counted as the aten ops they are.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, _cost
from repro_torch.kernels.flash_attention.ref import (NEG_INF, attend_mask,
                                                     attention_ref)

# (query/key head dim, value head dim) pairs the kernel takes: the dense
# models' 64 and 128, and multi-head latent attention's expanded form
# (deepseek-v2: 128 nope + 64 rope dims of q.k, v 128)
HEAD_DIMS = frozenset({(64, 64), (128, 128), (192, 128)})
BWD_CHUNK = 256        # kv rows per backward chunk: bounds its fp32 blocks
_SOURCES = ("flash_attention.cu",)
_FUNCS = {torch.bfloat16: "flash_attention_fwd_bf16",
          torch.float32: "flash_attention_fwd_f32"}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    return _build.load("flash_attention", _SOURCES, {
        name: (_ARGTYPES, ctypes.c_int) for name in _FUNCS.values()})


def attended_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one head, query i (from 0) against
    keys j < Sk with j <= i if ``causal`` and j > i - ``window`` if
    ``window``: the work the masks leave (a kernel that skips masked tiles
    need do no more)."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def work(B: int, Sq: int, Sk: int, H: int, KV: int, Dqk: int, Dv: int,
         dtype, causal: bool, window: int):
    """``(operations, bytes)`` of one forward: q (B Sq H Dqk) and o (B Sq
    H Dv), k (B Sk KV Dqk) and v (B Sk KV Dv) read or written once, m and
    l (B H Sq fp32); ``2 (Dqk + Dv)`` operations per attended pair and
    head (q·k and p·v)."""
    nbytes = ((B * Sq * H + B * Sk * KV) * (Dqk + Dv)) * dtype.itemsize \
        + 8 * B * H * Sq
    ops = 2 * (Dqk + Dv) * B * H * attended_pairs(Sq, Sk, causal, window)
    return ops, nbytes


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"flash_attention shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, _, H, Dh = q.shape
    if k.shape[0] != B or k.shape[3] != Dh or H % k.shape[2]:
        raise ValueError(f"flash_attention shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} (q heads must be a multiple of "
                         f"kv heads)")


def flash_attention_fwd(q, k, v, *, causal: bool, window: int, scale: float):
    """q: (B, Sq, H, Dh); k: (B, Sk, KV, Dh); v: (B, Sk, KV, Dv) -> ``(o,
    m, l)``: o (B, Sq, H, Dv) in q's dtype, m and l (B, H, Sq) fp32 on CUDA
    (the accumulation dtype on the CPU).  No gradient.

    On CUDA: bf16 or f32, q, k and v of one dtype and device, (Dh, Dv) one
    of ``HEAD_DIMS`` ((64, 64), (128, 128), (192, 128)),
    the last dimension contiguous (the others are read with their
    strides), base pointers 16-byte aligned and strides whole 16-byte
    pieces (the kernel copies tiles in 16-byte pieces), and every query
    row attending to a key (with a window, Sq < Sk + window)."""
    _check_shapes(q, k, v)
    (B, Sq, H, Dh), (Sk, KV, Dv) = q.shape, v.shape[1:]
    with _cost.declared("flash_attention", work, B, Sq, Sk, H, KV, Dh, Dv,
                        q.dtype, bool(causal), int(window)):
        if q.device.type == "cpu":
            # o in the kernel's layout (the plain version's is a permuted
            # view), so the ops after it count the same as on the card
            o, m, l = attention_ref(q, k, v, causal=causal, window=window,
                                    scale=scale)
            return o.contiguous(), m, l
        return _launch(q, k, v, causal, window, scale)


flash_attention_fwd.launches = 0


def _launch(q, k, v, causal, window, scale):
    """Launch the kernel on CUDA tensors; on ``meta`` tensors, the same
    checks and outputs and no launch."""
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    fn_name = _FUNCS.get(q.dtype)
    if fn_name is None:
        raise TypeError(f"flash_attention kernel takes bf16 or f32, got "
                        f"{q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype} on "
                            f"{t.device}, q is {q.dtype} on {q.device}")
    B, Sq, H, Dh = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    if (Dh, Dv) not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes (head dim, value "
                         f"head dim) in {sorted(HEAD_DIMS)}, got {(Dh, Dv)}")
    if window > 0 and Sq >= Sk + window:
        # query rows >= Sk + window - 1 see no key: the plain version gives
        # them the mean of v (its finite NEG_INF), the kernel o = 0 and l = 0
        raise ValueError(f"flash_attention kernel: with window {window}, "
                         f"query rows >= {Sk + window - 1} attend to no key "
                         f"(Sq {Sq}, Sk {Sk})")
    vec = 16 // q.element_size()   # the kernel copies 16-byte pieces
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s last dimension is "
                             f"not contiguous")
        if t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3]):
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             f"aligned (pointer {t.data_ptr() % 16} bytes "
                             f"off, strides {t.stride()[:3]} not multiples "
                             f"of {vec})")
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    m = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0 or q.device.type == "meta":
        return o, m, l
    fn = getattr(library(), fn_name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 m.data_ptr(), l.data_ptr(), B, Sq, Sk, H, KV, Dh, Dv,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 float(scale), int(bool(causal)), int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err} (B={B}, Sq={Sq}, Sk={Sk}, H={H}, KV={KV}, "
                           f"Dh={Dh}, Dv={Dv}, {q.dtype})")
    flash_attention_fwd.launches += 1
    return o, m, l


def attention_bwd(q, k, v, o, m, l, do, *, causal: bool, window: int,
                  scale: float, chunk: int = BWD_CHUNK):
    """The gradient of the attention from the saved (q, k, v, o, m, l): for
    each kv chunk, ``P = exp(s - m) / max(l, 1e-30)``, ``dP = dO Vᵀ``,
    ``dS = P (dP - Σ dO·O) scale``; dV = Pᵀ dO and dK = dSᵀ Q are summed
    over the G query heads of each kv head, dQ = dS K over the chunks.
    The steps of the JAX package's ``_chunked_attn_bwd``, in the
    accumulation dtype, each gradient rounded once to its input's dtype."""
    B, Sq, H, Dh = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KV
    acc_dt = torch.promote_types(q.dtype, torch.float32)
    dev = q.device
    qf = q.reshape(B, Sq, KV, G, Dh).to(acc_dt)
    dof = do.reshape(B, Sq, KV, G, Dv).to(acc_dt)
    of = o.reshape(B, Sq, KV, G, Dv).to(acc_dt)
    mm = m.reshape(B, KV, G, Sq).to(acc_dt)
    ll = l.reshape(B, KV, G, Sq).to(acc_dt).clamp_min(1e-30)
    dsum = torch.einsum("bqkgd,bqkgd->bkgq", dof, of)
    dq = torch.zeros_like(qf)
    dk = torch.empty((B, Sk, KV, Dh), dtype=acc_dt, device=dev)
    dv = torch.empty((B, Sk, KV, Dv), dtype=acc_dt, device=dev)
    q_pos = torch.arange(Sq, device=dev)
    for c0 in range(0, Sk, chunk):
        kc = k[:, c0:c0 + chunk].to(acc_dt)
        vc = v[:, c0:c0 + chunk].to(acc_dt)
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kc) * scale
        k_pos = torch.arange(c0, c0 + kc.shape[1], device=dev)
        s = torch.where(attend_mask(q_pos, k_pos, causal=causal,
                                    window=window), s, NEG_INF)
        p = torch.exp(s - mm[..., None]) / ll[..., None]
        dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vc)
        ds = p * (dp - dsum[..., None]) * scale
        dv[:, c0:c0 + chunk] = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
        dk[:, c0:c0 + chunk] = torch.einsum("bkgqs,bqkgd->bskd", ds, qf)
        dq += torch.einsum("bkgqs,bskd->bqkgd", ds, kc)
    return (dq.reshape(B, Sq, H, Dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with the memory-lean backward: saves q, k, v, o and
    the row statistics m, l (nothing of size Sq x Sk)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        o, m, l = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                      scale=scale)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.opts = dict(causal=causal, window=window, scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, o, m, l, do, **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    kv_valid=None, scale=None):
    """q: (B, Sq, H, Dh); k: (B, Sk, KV, Dh); v: (B, Sk, KV, Dv) -> (B,
    Sq, H, Dv), with a gradient for q, k and v.

    The training/prefill case only (``q_offset`` 0, the whole of k valid),
    as in the JAX package; decode attention runs the einsum path of
    :mod:`repro_torch.models.common`."""
    if q_offset != 0 or kv_valid is not None:
        raise ValueError("flash_attention covers the train/prefill case "
                         "(q_offset 0, no kv_valid)")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return FlashAttentionFunction.apply(q, k, v, bool(causal), int(window),
                                        float(scale))
