"""Plain PyTorch version of the flash-attention forward.

The semantics the CUDA kernel (``csrc/flash_attention.cu``) is held to,
and those of the JAX package's ``repro/kernels/flash_attention``: scores
``scale q·k`` in fp32 (f64 inputs stay f64), masked scores set to the
finite ``NEG_INF``, an online softmax over kv chunks with running row
maximum m, row sum l and accumulator, and the output ``acc / max(l,
1e-30)`` rounded once to q's dtype.  P·V is taken in the accumulation
dtype, as the Pallas kernel and its oracle take it (the JAX package's
einsum attention casts P to v's dtype first).  The port's decode over a
long cache (``models/common.py::gqa_attention`` with Sk > chunk) runs this
loop too, with its offsets, ``kv_valid`` and ring-cache positions.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attend_mask(q_pos, k_pos, *, causal: bool, window: int, kv_valid=None):
    """q_pos (Sq,), k_pos (C,) -> bool (Sq, C), True = attend; slots at or
    beyond ``kv_valid`` (a cache's current length) are masked."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    if kv_valid is not None:
        m &= k_pos[None, :] < kv_valid
    return m


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  scale=None, chunk: int = 512, q_offset=0, kv_offset=0,
                  kv_valid=None, k_positions=None):
    """q: (B, Sq, H, Dh); k: (B, Sk, KV, Dh); v: (B, Sk, KV, Dv), H a
    multiple of KV.  ``q_offset`` and ``kv_offset`` are the absolute
    positions of q[:, 0] and k[:, 0]; ``k_positions`` (Sk,), when given,
    replaces the latter with each slot's position (ring cache).

    Returns ``(o, m, l)``: o (B, Sq, H, Dv) in q's dtype; m and l (B, H,
    Sq) in the accumulation dtype (at least f32).  Any Sq and Sk; kv is
    walked in chunks of ``chunk`` rows (the last one may be short)."""
    B, Sq, H, Dh = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KV
    scale = Dh ** -0.5 if scale is None else scale
    acc_dt = torch.promote_types(q.dtype, torch.float32)
    dev = q.device
    qf = q.reshape(B, Sq, KV, G, Dh).to(acc_dt)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    if k_positions is None:
        k_positions = kv_offset + torch.arange(Sk, device=dev)
    m_run = torch.full((B, KV, G, Sq), NEG_INF, dtype=acc_dt, device=dev)
    l_run = torch.zeros((B, KV, G, Sq), dtype=acc_dt, device=dev)
    acc = torch.zeros((B, KV, G, Sq, Dv), dtype=acc_dt, device=dev)
    for c0 in range(0, Sk, chunk):
        kc = k[:, c0:c0 + chunk].to(acc_dt)
        vc = v[:, c0:c0 + chunk].to(acc_dt)
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kc) * scale
        s = torch.where(attend_mask(q_pos, k_positions[c0:c0 + chunk],
                                    causal=causal, window=window,
                                    kv_valid=kv_valid), s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vc)
        m_run = m_new
    o = acc / l_run.clamp_min(1e-30)[..., None]
    o = o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv).to(q.dtype)
    return o, m_run.reshape(B, H, Sq), l_run.reshape(B, H, Sq)
