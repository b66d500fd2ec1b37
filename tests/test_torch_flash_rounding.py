"""The bf16 flash kernel's one change of rounding, on the CPU.

The bf16 kernel (``csrc/flash_attention.cu``) takes fp32 scores of the bf16
q and k, rounds P to bf16 before P·V (the product of two bf16 values is
exact in fp32, and the sums are fp32), and sums l from the unrounded fp32 P.
The plain version (``kernels/flash_attention/ref.py``) keeps P in fp32.
``_kernel_arithmetic`` below emulates the kernel's arithmetic tile by tile;
it lives here, not in the package, because the package's plain version is
the reference semantics.  At reduced bf16 shapes of ``chip_smoke.py`` phase
3c it is held two ways:

(a) against the plain version: within the 2^-7 · max|o| that phase 3c and
    ``tests/test_torch_cuda.py`` hold the bf16 kernel to, and m, l to 1e-5;
(b) against the JAX package's own online softmax
    (``repro/models/common.py::_chunked_attn_fwd_core``, which also rounds
    P to v's dtype) over the same 64-row kv chunks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jc
from repro_torch.kernels.flash_attention.ref import (NEG_INF, attend_mask,
                                                     attention_ref)

TILE = 64   # the kernel's kv tile

# (name, B, S, H, KV, Dh, causal, window): phase 3c's bf16 cases, reduced
CASES = [("olmo-1b", 2, 64, 4, 4, 128, True, 0),
         ("gqa G4", 1, 128, 8, 2, 64, True, 0),
         ("window 128", 1, 300, 2, 2, 64, True, 128),
         ("ragged 100", 1, 100, 4, 4, 128, True, 0)]


def _inputs(B, S, H, KV, Dh, seed=0):
    """bf16 q, k, v (B, S, heads, Dh) from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(B, S, n, Dh)).astype(
        np.float32)).bfloat16() for n in (H, KV, KV)]


def _kernel_arithmetic(q, k, v, *, causal, window, scale):
    """The bf16 kernel's arithmetic: per 64-row kv tile, fp32 scores (masked
    ones -inf), running max m and sum l of the fp32 P, and acc += bf16(P) ·
    V in fp32.  Returns o in fp32 (before the output's one rounding), m and
    l, each in the plain version's layout."""
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, Sq, KV, G, Dh)
    q_pos = torch.arange(Sq)
    m = torch.full((B, KV, G, Sq), -torch.inf)
    l = torch.zeros((B, KV, G, Sq))
    acc = torch.zeros((B, KV, G, Sq, Dh))
    for k0 in range(0, Sk, TILE):
        kc, vc = k[:, k0:k0 + TILE].float(), v[:, k0:k0 + TILE].float()
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kc) * scale
        mask = attend_mask(q_pos, torch.arange(k0, k0 + kc.shape[1]),
                           causal=causal, window=window)
        s = torch.where(mask, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(m_new == -torch.inf, 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        corr = torch.exp(m - m_safe)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.bfloat16().float(), vc)
        m = m_new
    o = acc / l.clamp_min(1e-30)[..., None]
    m = torch.where(m == -torch.inf, NEG_INF, m)
    return (o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dh),
            m.reshape(B, H, Sq), l.reshape(B, H, Sq))


def _jax_online_softmax(q, k, v, *, causal, window, scale):
    """``_chunked_attn_fwd_core`` on the same bf16 inputs, kv padded to
    64-row chunks and the padding masked by ``kv_valid``: o (fp32, before
    any output rounding), m and l in the plain version's layout."""
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    nc = -(-Sk // TILE)

    def chunks(t):
        t = np.asarray(t.float().numpy())
        t = np.pad(t, ((0, 0), (0, nc * TILE - Sk), (0, 0), (0, 0)))
        return jnp.asarray(t, jnp.bfloat16).reshape(
            B, nc, TILE, KV, Dh).transpose(1, 0, 2, 3, 4)

    qr = jnp.asarray(q.float().numpy(), jnp.bfloat16).reshape(
        B, Sq, KV, H // KV, Dh)
    o, m, l = jc._chunked_attn_fwd_core(
        qr, chunks(k), chunks(v), jnp.arange(nc * TILE).reshape(nc, TILE),
        jnp.arange(Sq), causal=causal, window=window, kv_valid=Sk,
        scale=scale)
    o = torch.from_numpy(np.array(o, np.float32))
    return (o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dh),
            torch.from_numpy(np.array(m, np.float32)).reshape(B, H, Sq),
            torch.from_numpy(np.array(l, np.float32)).reshape(B, H, Sq))


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_rounded_p_fits_the_kernel_tolerance(case):
    """(a): o rounded once to bf16, as the kernel writes it, against the
    plain version's o, within phase 3c's bf16 tolerance 2^-7 · max|o|; m
    and l within its 1e-5 (l is summed from the fp32 P, so only the
    summation order differs)."""
    _, B, S, H, KV, Dh, causal, window = case
    q, k, v = _inputs(B, S, H, KV, Dh)
    scale = Dh ** -0.5
    o, m, l = _kernel_arithmetic(q, k, v, causal=causal, window=window,
                                 scale=scale)
    ro, rm, rl = attention_ref(q, k, v, causal=causal, window=window,
                               scale=scale)
    assert _rel(o.bfloat16(), ro) <= 2 ** -7
    assert _rel(m, rm) <= 1e-5 and _rel(l, rl) <= 1e-5


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_rounded_p_is_the_jax_packages_rounding(case):
    """(b): against the JAX package's online softmax over the same 64-row
    chunks, which rounds P to bf16 as the kernel does.  The two differ in
    the order of the fp32 sums (m and l: 1e-5 relative) and in one rounding
    that only the JAX package makes: its per-chunk bf16 · bf16 einsum
    returns bf16, so each chunk's P·V is rounded to bf16 (half an ulp,
    2^-9 relative) before it is added.  Those roundings move o by at most
    2^-9 · Σ_chunks corr·|P V| / l ≤ 2^-9 · max|v| · (1 + 2^-8) (P rounds
    to within 2^-9 of itself); the bound is stated with 1e-5 · max|o| for
    the summation order."""
    _, B, S, H, KV, Dh, causal, window = case
    q, k, v = _inputs(B, S, H, KV, Dh, seed=1)
    scale = Dh ** -0.5
    o, m, l = _kernel_arithmetic(q, k, v, causal=causal, window=window,
                                 scale=scale)
    jo, jm, jl = _jax_online_softmax(q, k, v, causal=causal, window=window,
                                     scale=scale)
    tol = (2 ** -9 * (1 + 2 ** -8) * v.float().abs().max()
           + 1e-5 * jo.abs().max()).item()
    assert (o - jo).abs().max().item() <= tol
    assert _rel(m, jm) <= 1e-5 and _rel(l, jl) <= 1e-5
