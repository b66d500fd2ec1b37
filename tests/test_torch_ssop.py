"""The port's SS-OP (``repro_torch.kernels.ssop`` and ``repro_torch.core.ssop``)
against the JAX package's: its Pallas kernel (interpret mode on the CPU, as
``tests/test_kernels.py`` runs it), its jnp oracle and its ``core.ssop``
functions, forward and gradient, on inputs drawn from a numpy seed.

On the CPU the wrappers take the plain version and launch nothing; the
CUDA kernel is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.core import ssop as jssop
from repro.kernels.ssop import ops as jops
from repro.kernels.ssop.ref import ssop_apply_ref as jax_ssop_ref
from repro_torch.core import ssop
from repro_torch.kernels.ssop import ops
from repro_torch.kernels.ssop.ref import ssop_apply_ref

# f32 on both sides, fp32 accumulation in another summation order: rtol
# 1e-5, with an absolute floor of 1e-5 * max|y| for entries that cancel.
RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _inputs(t, d, r, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(t, d)).astype(np.float32)
    u = np.linalg.qr(rng.normal(size=(d, r)))[0].astype(np.float32)
    v = np.linalg.qr(rng.normal(size=(r, r)))[0].astype(np.float32)
    return h, u, v


@pytest.mark.parametrize("r,seed", [(4, 0), (16, 7), (16, 2 ** 40 + 3),
                                    (64, 123)])
def test_random_orthogonal_and_client_seed_bit_identical(r, seed):
    got = ssop.random_orthogonal(r, seed, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jssop.random_orthogonal(r, seed)))
    for salt, n in (("s", 0), ("elsa", 17), ("x||y", 2 ** 31)):
        assert ssop.client_seed(salt, n) == jssop.client_seed(salt, n)


def test_make_ssop_and_q_matrix_match_jax():
    _, u, _ = _inputs(1, 48, 8)
    got = ssop.make_ssop_from_basis(torch.from_numpy(u), "salt", 5)
    want = jssop.make_ssop_from_basis(jnp.asarray(u), "salt", 5)
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))
    q = ssop.q_matrix(got)
    _close(q, jssop.q_matrix(want))
    np.testing.assert_allclose((q @ q.T).numpy(), np.eye(48), atol=1e-5)


def test_semantic_subspace_spans_the_jax_subspace():
    """The singular vectors' signs are LAPACK's choice in both packages;
    the projector U Uᵀ is what is determined."""
    rng = np.random.default_rng(3)
    j = (rng.normal(size=(32, 8)) @ rng.normal(size=(8, 64))
         + 1e-3 * rng.normal(size=(32, 64))).astype(np.float32)
    got = ssop.semantic_subspace(torch.from_numpy(j), 8)
    want = np.asarray(jssop.semantic_subspace(jnp.asarray(j), 8))
    assert got.shape == (64, 8)
    _close(got @ got.T, want @ want.T, rtol=1e-4)


@pytest.mark.parametrize("t,d,r", [(8, 256, 16), (5, 200, 4), (256, 64, 8),
                                   (3, 128, 64)])
def test_plain_matches_jax_kernel_and_oracle(t, d, r):
    h, u, v = _inputs(t, d, r)
    w = (v.T - np.eye(r)).astype(np.float32)
    got = ssop_apply_ref(*(torch.from_numpy(a) for a in (h, u, w)))
    _close(got, jops.ssop_apply(h, u, v))
    _close(got, jax_ssop_ref(h, u, w))


def test_plain_matches_jax_kernel_in_bf16():
    """Both accumulate in fp32 and round once to bf16: they may differ by
    one bf16 rounding of an output, at most 2^-8 of its magnitude; held to
    2^-7 of the largest output."""
    h, u, v = _inputs(16, 256, 16, seed=1)
    w = (v.T - np.eye(16)).astype(np.float32)
    hb, ub, wb = (torch.from_numpy(a).bfloat16() for a in (h, u, w))
    got = ssop_apply_ref(hb, ub, wb)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jops.ssop_apply(jnp.asarray(h, jnp.bfloat16),
                                      jnp.asarray(u, jnp.bfloat16),
                                      jnp.asarray(v, jnp.bfloat16),
                                      w=jnp.asarray(w, jnp.bfloat16)),
                      np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2 ** -7 * np.abs(want).max(), err


@pytest.mark.parametrize("inverse", [False, True], ids=["ssop", "inverse"])
def test_apply_ssop_matches_jax_core_forward_and_gradient(inverse):
    h, u, v = _inputs(6, 96, 16, seed=2)
    g = np.random.default_rng(9).normal(size=h.shape).astype(np.float32)
    jfn = jssop.apply_ssop_inverse if inverse else jssop.apply_ssop
    tfn = ssop.apply_ssop_inverse if inverse else ssop.apply_ssop
    jop = jssop.make_ssop_from_basis(jnp.asarray(u), "k", 1)
    top = ssop.make_ssop_from_basis(torch.from_numpy(u), "k", 1)
    want, vjp = jax.vjp(lambda x: jfn(x, jop), jnp.asarray(h))
    (want_g,) = vjp(jnp.asarray(g))
    ht = torch.from_numpy(h).requires_grad_(True)
    got = tfn(ht, top)
    got.backward(torch.from_numpy(g))
    _close(got.detach(), want)
    _close(ht.grad, want_g)


def test_ssop_is_undone_by_its_inverse_and_keeps_norms():
    h, u, v = _inputs(4, 80, 8, seed=4)
    op = ssop.make_ssop_from_basis(torch.from_numpy(u), "k", 2)
    ht = torch.from_numpy(h)
    rot = ssop.apply_ssop(ht, op)
    _close(ssop.apply_ssop_inverse(rot, op), h)
    _close(rot.norm(dim=-1), ht.norm(dim=-1))
    assert not torch.allclose(rot, ht)


def test_backward_is_the_same_op_with_w_transposed():
    """torch.autograd.gradcheck in f64 of the autograd.Function, whose
    backward calls the op with Wᵀ."""
    h, u, v = _inputs(3, 24, 5, seed=5)
    w = torch.from_numpy(v.T - np.eye(5)).double()
    args = (torch.from_numpy(h).double().requires_grad_(True),
            torch.from_numpy(u).double(), w)
    assert torch.autograd.gradcheck(ops.SSOPFunction.apply, args)


def test_wrapper_on_cpu_uses_plain_version_and_launches_nothing():
    h, u, v = _inputs(5, 64, 4)
    w = torch.from_numpy(v.T - np.eye(4)).float()
    ops.ssop_apply_td.launches = 0
    ht = torch.from_numpy(h).reshape(1, 5, 64)
    y = ops.ssop_apply_td(ht, torch.from_numpy(u), w)
    assert y.shape == (1, 5, 64)
    torch.testing.assert_close(y, ssop_apply_ref(ht, torch.from_numpy(u), w),
                               rtol=0, atol=0)
    ht.requires_grad_(True)
    ops.ssop_apply(ht, torch.from_numpy(u), torch.from_numpy(v)).sum(
    ).backward()
    assert ops.ssop_apply_td.launches == 0


def test_bad_shapes_raise_and_other_devices_never_take_the_plain_version():
    h, u, w = (torch.empty(s) for s in ((3, 64), (64, 4), (4, 4)))
    with pytest.raises(ValueError):
        ops.ssop_apply_td(h, u[:63], w)
    with pytest.raises(ValueError):
        ops.ssop_apply_td(h, u, w[:3])
    with FakeTensorMode():              # a device with no kernel
        fake = (torch.empty(t.shape, device="xpu") for t in (h, u, w))
        with pytest.raises(ValueError, match="no kernel"):
            ops.ssop_apply_td(*fake)
    out = ops.ssop_apply_td(*(t.to("meta") for t in (h, u, w)))
    assert out.device.type == "meta" and out.shape == h.shape
