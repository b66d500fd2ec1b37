"""Flash attention in the port against the JAX package's, on the CPU: the
plain version (``kernels/flash_attention/ref.py``) and ``ops.flash_attention``
on CPU tensors against the Pallas kernel in interpret mode (tile-multiple
lengths) and its oracle ``attention_bhsd_ref`` (ragged lengths), and the
gradient of ``FlashAttentionFunction`` against ``jax.vjp`` of the JAX
package's ``gqa_attention`` at a chunk below the length, so that its custom
VJP ``_chunked_attn`` runs.  The CUDA kernel itself is held against the
plain version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase 3c).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention.ref import attention_bhsd_ref
from repro.models import common as jc
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import common as tc

# (B, S, H, KV, Dh, causal, window)
CASES = [(2, 32, 4, 4, 16, True, 0), (1, 32, 4, 2, 16, False, 0),
         (2, 48, 4, 1, 8, True, 20), (1, 32, 2, 2, 8, False, 12)]


def _ids(c):
    B, S, H, KV, Dh, causal, window = c
    return (f"S{S}-H{H}-KV{KV}-{'causal' if causal else 'full'}"
            f"{f'-w{window}' if window else ''}")


def _inputs(B, S, H, KV, Dh, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, n, Dh)).astype(dtype) for n in (H, KV, KV)]


def _bhsd(x):
    B, S, H, D = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, S, D)


def _oracle(q, k, v, causal, window):
    B, S, H, D = q.shape
    o = attention_bhsd_ref(_bhsd(q), _bhsd(k), _bhsd(v), causal=causal,
                           window=window)
    return np.asarray(o).reshape(B, H, S, D).transpose(0, 2, 1, 3)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, (err, scale)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_version_matches_pallas_kernel_and_oracle(case):
    """f32; both sides take fp32 scores and sums, so they agree to 1e-5
    of the output's scale (summation order)."""
    B, S, H, KV, Dh, causal, window = case
    q, k, v = _inputs(B, S, H, KV, Dh)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, bq=16, bk=16, interpret=True))
    _close(want, _oracle(q, k, v, causal, window), 1e-5)
    for chunk in (512, 16, 7):
        o, m, l = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                window=window, chunk=chunk)
        _close(o, want, 1e-5)
    n0 = ops.flash_attention_fwd.launches
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window)
    assert ops.flash_attention_fwd.launches == n0   # the CPU launches nothing
    _close(got, want, 1e-5)


@pytest.mark.parametrize("S", [1, 13, 100, 129])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 9), (False, 30)])
def test_plain_version_matches_oracle_at_ragged_lengths(S, causal, window):
    q, k, v = _inputs(2, S, 4, 2, 8, seed=S)
    want = _oracle(q, k, v, causal, window)
    o, m, l = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=causal,
                            window=window, chunk=32)
    _close(o, want, 1e-5)
    # the row statistics: m is the row maximum of the masked scaled scores,
    # l the sum of exp(s - m) over the row
    qq = torch.from_numpy(q).double().reshape(2, S, 2, 2, 8)
    s = torch.einsum("bqkgd,bskd->bkgqs", qq,
                     torch.from_numpy(k).double()) * 8 ** -0.5
    pos = torch.arange(S)
    mask = torch.ones(S, S, dtype=torch.bool)
    if causal:
        mask &= pos[None] <= pos[:, None]
    if window:
        mask &= pos[None] > pos[:, None] - window
    s = torch.where(mask, s, -1e30)
    want_m = s.amax(-1)
    want_l = torch.exp(s - want_m[..., None]).sum(-1)
    _close(m, want_m.reshape(2, 4, S), 1e-6)
    _close(l, want_l.reshape(2, 4, S), 1e-5)


def test_bf16_output_is_one_rounding_of_the_fp32_result():
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _inputs(1, 40, 4, 2, 16))
    o, _, _ = attention_ref(q, k, v, causal=True, window=0, chunk=16)
    o32, _, _ = attention_ref(q.float(), k.float(), v.float(), causal=True,
                              window=0)
    assert o.dtype == torch.bfloat16
    assert (o.float() - o32).abs().max() <= 2 ** -8 * o32.abs().max()


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_gradient_matches_jax_chunked_custom_vjp(case, dtype):
    """dq, dk, dv of the Function against ``jax.vjp`` of the JAX package's
    ``gqa_attention`` with chunk 8 < S: f64 to 1e-10, f32 to 1e-5 of each
    gradient's scale."""
    B, S, H, KV, Dh, causal, window = case
    q, k, v = _inputs(B, S, H, KV, Dh, dtype=dtype)
    do = np.random.default_rng(9).normal(size=q.shape).astype(dtype)
    with jax.enable_x64(True):
        out, vjp = jax.vjp(lambda a, b, c: jc.gqa_attention(
            a, b, c, causal=causal, window=window, chunk=8),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
        out = np.asarray(out)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = tc.gqa_attention(*leaves, causal=causal, window=window)
    got = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    rtol = 1e-10 if dtype == "float64" else 1e-5
    _close(o.detach(), out, rtol)
    for a, b in zip(got, want):
        assert a.dtype == getattr(torch, dtype)
        _close(a, b, rtol)


def test_function_saves_no_sq_by_sk_tensor():
    """What autograd keeps for the backward: q, k, v, o and the (B, H, S)
    row statistics, nothing of size S x S (fault 1 of ROADMAP.md queue 3:
    the chunked attention's autograd kept every (Sq x chunk) block)."""
    B, S, H, KV, Dh = 1, 96, 2, 1, 8
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _inputs(B, S, H, KV, Dh))
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        o = ops.flash_attention(q, k, v, causal=True)
    assert saved and all(np.prod(s) < S * S for s in saved), saved
    assert sorted(saved) == sorted([(B, S, H, Dh), (B, S, KV, Dh),
                                    (B, S, KV, Dh), (B, S, H, Dh),
                                    (B, H, S), (B, H, S)])
    o.sum().backward()
    assert q.grad.shape == q.shape and k.grad.shape == k.shape


def test_gqa_attention_routes_the_cache_free_case_only():
    """Without a cache (offsets 0, no kv_valid, no ring positions) the
    attention is flash attention, for any length and whatever ``use_flash``
    says; decode over a cache stays on the einsum path."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 37, 4, 2, 8))
    want = attention_ref(q, k, v, causal=True, window=0)[0]
    for use_flash in (False, True):
        got = tc.gqa_attention(q, k, v, causal=True, chunk=8,
                               use_flash=use_flash)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="not divisible"):
        tc.gqa_attention(q, k, v, q_offset=3, chunk=8)
    with pytest.raises(ValueError, match="train/prefill"):
        ops.flash_attention(q, k, v, q_offset=1)
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q[:, :, :3], k, v)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_value_head_dim_differs_from_query_head_dim(dtype):
    """Multi-head latent attention's expanded form at reduced deepseek-v2
    width: q and k of head dim 48 (32 nope + 16 rope), v of 32.  The
    forward of ``ops.flash_attention`` (the plain version on the CPU)
    against the JAX package's ``gqa_attention`` (which its ``mla_full``
    calls), and the Function's gradient (``attention_bwd``, carrying Dv)
    against ``jax.vjp`` of it at a chunk below the length and against
    autograd through the plain version: f64 to 1e-10, f32 to 1e-5 of each
    one's scale."""
    B, S, H, KV, Dqk, Dv = 2, 40, 4, 4, 48, 32
    rng = np.random.default_rng(12)
    q, k = (rng.normal(size=(B, S, H, Dqk)).astype(dtype) for _ in range(2))
    v = rng.normal(size=(B, S, KV, Dv)).astype(dtype)
    do = rng.normal(size=(B, S, H, Dv)).astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        out, vjp = jax.vjp(lambda a, b, c: jc.gqa_attention(
            a, b, c, causal=True, chunk=8),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
        direct = np.asarray(jc.gqa_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
        out = np.asarray(out)
    rtol = 1e-10 if dtype == "float64" else 1e-5
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = ops.flash_attention(*leaves, causal=True)
    assert o.shape == (B, S, H, Dv)
    got = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    _close(o.detach(), out, rtol)
    _close(o.detach(), direct, rtol)
    plain = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    auto = torch.autograd.grad(attention_ref(*plain, causal=True)[0], plain,
                               torch.from_numpy(do))
    for a, b, c in zip(got, want, auto):
        assert a.dtype == getattr(torch, dtype) and a.shape == c.shape
        _close(a, b, rtol)
        _close(a, c.detach(), rtol)
    with pytest.raises(ValueError, match="shapes"):
        ops.flash_attention(leaves[0], leaves[1], leaves[2][:, :, :2],
                            causal=True)
