"""Plain PyTorch version of the SS-OP rotation.

The semantics the CUDA kernel (``csrc/ssop.cu``) is held to, and those of
the JAX package's ``repro/kernels/ssop/ref.py``: ``H + ((H U) W) Uᵀ``
accumulated in fp32 and rounded once to ``h.dtype``.  f64 inputs stay in
f64, so f64 parity runs are not re-quantized to f32.
"""
from __future__ import annotations

import torch


def ssop_apply_ref(h, u, w):
    """h: (..., D); u: (D, r); w: (r, r) -> (..., D)."""
    acc = torch.promote_types(h.dtype, torch.float32)
    hf, uf, wf = h.to(acc), u.to(acc), w.to(acc)
    return (hf + ((hf @ uf) @ wf) @ uf.T).to(h.dtype)
