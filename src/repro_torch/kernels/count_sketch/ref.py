"""Plain PyTorch versions of the count-sketch kernels and their backwards.

The semantics the CUDA kernels (``csrc/count_sketch.cu``) are held to, and
those of the JAX package's ``repro/kernels/count_sketch/ref.py``, written as
the hash scatter and gather of the paper's Eqs. 20-21 rather than as
products with the dense selection tensor.  A plan is ``bucket`` (Y, D)
int32 in [0, Z) and ``sign`` (Y, D) float32 in {-1, +1}.  Sums are in fp32
(f64 stays f64) and are rounded once to the input's dtype.
"""
from __future__ import annotations

import torch


def _acc(t):
    return torch.promote_types(t.dtype, torch.float32)


def median_rows(rows):
    """Median of a list of equally shaped tensors by the compare-exchange
    network of the JAX package's ``_median_rows``; an even count averages
    the middle two.  Its gradient splits a min/max tie in halves, as JAX's
    does."""
    rows = list(rows)
    n = len(rows)
    for i in range(n):
        for j in range(n - 1 - i):
            lo = torch.minimum(rows[j], rows[j + 1])
            hi = torch.maximum(rows[j], rows[j + 1])
            rows[j], rows[j + 1] = lo, hi
    if n % 2:
        return rows[(n - 1) // 2]
    return 0.5 * (rows[n // 2 - 1] + rows[n // 2])


def _estimates(uf, bucket, sign):
    """(..., Y, Z) -> the Y signed estimates (..., D), one per hash row."""
    return [uf[..., y, :][..., bucket[y].long()] * sign[y].to(uf.dtype)
            for y in range(bucket.shape[0])]


def compress_ref(h, bucket, sign, z: int):
    """h: (..., D) -> (..., Y, Z): out[..., y, b] = Σ_{d: bucket[y,d]=b}
    sign[y, d] h[..., d]."""
    hf = h.to(_acc(h))
    rows = [hf.new_zeros(h.shape[:-1] + (z,)).index_add(
                -1, bucket[y].long(), hf * sign[y].to(hf.dtype))
            for y in range(bucket.shape[0])]
    return torch.stack(rows, dim=-2).to(h.dtype)


def decompress_ref(u, bucket, sign):
    """u: (..., Y, Z) -> (..., D): the median over y of
    sign[y, d] u[..., y, bucket[y, d]]."""
    return median_rows(_estimates(u.to(_acc(u)), bucket, sign)).to(u.dtype)


def gather_sum_ref(g, bucket, sign):
    """Backward of :func:`compress_ref`: g (..., Y, Z) -> (..., D),
    Σ_y sign[y, d] g[..., y, bucket[y, d]], y ascending."""
    ests = _estimates(g.to(_acc(g)), bucket, sign)
    out = ests[0]
    for e in ests[1:]:
        out = out + e
    return out.to(g.dtype)


def median_weights(rows):
    """The weight each of the Y rows takes in the median of
    :func:`median_rows`, elementwise: (..., Y), by carrying each network
    position's weights forward through the compares (a tie gives each input
    half of each output, JAX's rule for min and max).  The weights are sums
    of products of 0, 1/2 and 1, so they are exact."""
    rows = list(rows)
    n = len(rows)
    eye = torch.eye(n, dtype=rows[0].dtype, device=rows[0].device)
    coef = [eye[i].expand(rows[0].shape + (n,)) for i in range(n)]
    for i in range(n):
        for j in range(n - 1 - i):
            a, b = rows[j], rows[j + 1]
            half = 0.5 * (a == b).to(a.dtype)
            a_lo = ((a < b).to(a.dtype) + half)[..., None]
            a_hi = ((a > b).to(a.dtype) + half)[..., None]
            coef[j], coef[j + 1] = (a_lo * coef[j] + a_hi * coef[j + 1],
                                    a_hi * coef[j] + a_lo * coef[j + 1])
            rows[j], rows[j + 1] = torch.minimum(a, b), torch.maximum(a, b)
    if n % 2:
        return coef[(n - 1) // 2]
    return 0.5 * (coef[n // 2 - 1] + coef[n // 2])


def median_backward_ref(g, u, bucket, sign):
    """Backward of :func:`decompress_ref` at ``u``: g (..., D) -> (..., Y, Z),
    ``Σ_{d: bucket[y,d]=z} sign[y,d] m[..., y, d] g[..., d]`` with ``m`` the
    median's routing weights."""
    uf = u.to(_acc(u))
    m = median_weights(_estimates(uf, bucket, sign))      # (..., D, Y)
    gf = g.to(uf.dtype)
    rows = [uf.new_zeros(g.shape[:-1] + (u.shape[-1],)).index_add(
                -1, bucket[y].long(),
                (m[..., y] * gf) * sign[y].to(uf.dtype))
            for y in range(bucket.shape[0])]
    return torch.stack(rows, dim=-2).to(u.dtype)
