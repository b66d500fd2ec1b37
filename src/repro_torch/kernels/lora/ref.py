"""Plain PyTorch version of the fused LoRA projection.

The semantics the CUDA kernel (``csrc/lora_matmul.cu``) is held to, and
those of the JAX package's ``repro/kernels/lora/ref.py``: accumulate in
fp32, round once to ``x.dtype``.  f64 inputs accumulate in f64, as the JAX
package's ``models/common.py::project`` does, so f64 parity runs are not
re-quantized to f32.
"""
from __future__ import annotations

import torch


def lora_matmul_ref(x, w, a, b, scale: float):
    """x: (..., K); w: (K, O); a: (K, r); b: (r, O) -> (..., O)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    y = xf @ w.to(acc) + scale * ((xf @ a.to(acc)) @ b.to(acc))
    return y.to(x.dtype)
