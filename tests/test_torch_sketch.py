"""The port's count sketch (``repro_torch.kernels.count_sketch`` and
``repro_torch.core.sketch``) against the JAX package's: its Pallas kernels
(interpret mode on the CPU, as ``tests/test_kernels.py`` runs them), its
jnp oracles and its ``core.sketch`` functions, forward and gradient, with
ragged Z, even Y and forced ties in the median, on inputs drawn from a
numpy seed.

On the CPU the wrappers take the plain versions and launch nothing; the
CUDA kernels are held against the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.core import sketch as jsketch
from repro.kernels.count_sketch import ops as jops
from repro.kernels.count_sketch.ref import compress_ref as jax_compress_ref
from repro.kernels.count_sketch.ref import decompress_ref as jax_decompress_ref
from repro_torch.core import sketch
from repro_torch.kernels.count_sketch import ops
from repro_torch.kernels.count_sketch import ref

# compress sums up to D/Z signed terms in fp32 in another order than XLA's
# product with the selection tensor: rtol 1e-5 with an absolute floor of
# 1e-5 * max|y|.  decompress only gathers, negates and compares (and
# averages two values for an even Y, the same fp32 operation on both
# sides), so it is held to equality.
RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _plans(d, y, z, seed=0):
    return (sketch.make_plan(d, y, z, seed, device="cpu"),
            jsketch.make_plan(d, y, z, seed))


def _h(t, d, seed=1):
    return np.random.default_rng(seed).normal(size=(t, d)).astype(np.float32)


def _zeroed(plan):
    return max(1, plan.z // 4)


def _tied_sketch(plan, t, seed=2):
    """A sketch whose first quarter of buckets is zero in every row, so
    every feature that hashes there in two rows gives a tie (0 against 0)
    in the median."""
    u = np.random.default_rng(seed).normal(
        size=(t, plan.y, plan.z)).astype(np.float32)
    u[:, :, :_zeroed(plan)] = 0.0
    return u


def _n_tied_features(plan):
    return int(((plan.bucket < _zeroed(plan)).sum(0) >= 2).sum())


# (D, Y, Z): the launcher's reduced olmo-1b channel (Z = 40), ragged Z, even
# Y, Y = 1 and 8, a D that is no tile multiple
SHAPES = [(256, 3, 40), (512, 4, 37), (2000, 5, 37), (96, 8, 7), (64, 1, 9),
          (130, 2, 11)]


@pytest.mark.parametrize("d,y,z,seed", [(256, 3, 40, 0), (2048, 3, 325, 42),
                                        (100, 8, 7, 5)])
def test_make_plan_bit_identical(d, y, z, seed):
    plan, jplan = _plans(d, y, z, seed)
    assert plan.bucket.dtype == torch.int32 and plan.sign.dtype == torch.float32
    np.testing.assert_array_equal(plan.bucket.numpy(), np.asarray(jplan.bucket))
    np.testing.assert_array_equal(plan.sign.numpy(), np.asarray(jplan.sign))
    assert (plan.y, plan.d, plan.z, plan.rho) == (jplan.y, jplan.d, jplan.z,
                                                  jplan.rho)
    np.testing.assert_array_equal(sketch.selection_matrices(plan).numpy(),
                                  np.asarray(jsketch.selection_matrices(jplan)))


@pytest.mark.parametrize("d,y,z", SHAPES)
def test_inverse_index_covers_each_feature_once_in_order(d, y, z):
    plan, _ = _plans(d, y, z, seed=3)
    ptr, sidx = plan.ptr.numpy(), plan.sidx.numpy()
    idx = np.where(sidx < 0, ~sidx, sidx)      # the signed index, decoded
    bucket = plan.bucket.numpy()
    assert ptr.shape == (y * z + 1,) and idx.shape == (y * d,)
    assert ptr[0] == 0 and ptr[-1] == y * d and np.all(np.diff(ptr) >= 0)
    for yy in range(y):
        seen = []
        for b in range(z):
            lst = idx[ptr[yy * z + b]:ptr[yy * z + b + 1]]
            assert np.all(np.diff(lst) > 0)            # ascending, no repeats
            assert np.all(bucket[yy, lst] == b)
            seen.extend(lst)
        assert sorted(seen) == list(range(d))          # each d exactly once


def test_hand_built_plan_rejects_bucket_ids_out_of_range():
    with pytest.raises(ValueError):
        sketch.SketchPlan(torch.tensor([[0, 3]], dtype=torch.int32),
                          torch.ones(1, 2), 3)


@pytest.mark.parametrize("t,d,y,z", [(8, 256, 3, 40), (5, 512, 4, 37),
                                     (16, 1024, 2, 8)])
def test_plain_matches_jax_kernels_and_oracles(t, d, y, z):
    plan, jplan = _plans(d, y, z)
    h = _h(t, d)
    s = jsketch.selection_matrices(jplan)
    got = ref.compress_ref(torch.from_numpy(h), plan.bucket, plan.sign, z)
    _close(got, jops.sketch_compress(h, jplan))
    _close(got, jax_compress_ref(h, s))
    u = _tied_sketch(plan, t)
    got = ref.decompress_ref(torch.from_numpy(u), plan.bucket, plan.sign)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jops.sketch_decompress(u, jplan)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_decompress_ref(u, s)))


@pytest.mark.parametrize("d,y,z", SHAPES)
@pytest.mark.parametrize("via_matmul", [True, False], ids=["matmul", "scatter"])
def test_compress_and_decompress_match_jax_core(d, y, z, via_matmul):
    plan, jplan = _plans(d, y, z)
    h = _h(3, d).reshape(1, 3, d)
    _close(sketch.compress(torch.from_numpy(h), plan),
           jsketch.compress(jnp.asarray(h), jplan, via_matmul=via_matmul))
    u = _tied_sketch(plan, 3).reshape(1, 3, y, z)
    jp = jplan if via_matmul else jplan._replace(selection=None)
    np.testing.assert_array_equal(
        sketch.decompress(torch.from_numpy(u), plan).numpy(),
        np.asarray(jsketch.decompress(jnp.asarray(u), jp)))


@pytest.mark.parametrize("d,y,z", SHAPES)
def test_gradients_match_jax_core_with_ties(d, y, z):
    """torch.autograd through the port's autograd.Functions (whose
    backwards are the gather-sum and the median-routed scatter) against
    jax.vjp of the JAX package's core functions.  The tied sketch makes JAX
    split min/max gradients 0.5/0.5; the port must route the same."""
    plan, jplan = _plans(d, y, z)
    rng = np.random.default_rng(6)
    h = _h(4, d)
    u = _tied_sketch(plan, 4)
    g_sk = rng.normal(size=u.shape).astype(np.float32)
    g_est = rng.normal(size=h.shape).astype(np.float32)

    _, vjp = jax.vjp(lambda x: jsketch.compress(x, jplan), jnp.asarray(h))
    (want,) = vjp(jnp.asarray(g_sk))
    ht = torch.from_numpy(h).requires_grad_(True)
    sketch.compress(ht, plan).backward(torch.from_numpy(g_sk))
    _close(ht.grad, want)

    _, vjp = jax.vjp(lambda x: jsketch.decompress(x, jplan), jnp.asarray(u))
    (want,) = vjp(jnp.asarray(g_est))
    ut = torch.from_numpy(u).requires_grad_(True)
    sketch.decompress(ut, plan).backward(torch.from_numpy(g_est))
    _close(ut.grad, want)
    assert y == 1 or _n_tied_features(plan) > 0     # ties were exercised


def test_median_tie_splits_gradient_in_halves():
    """Y = 2, both rows hash feature 0 to a zeroed bucket with the same
    sign: the estimates tie and each row takes half of g (JAX's rule)."""
    bucket = torch.tensor([[0, 1], [0, 1]], dtype=torch.int32)
    sign = torch.tensor([[1.0, 1.0], [1.0, -1.0]])
    plan = sketch.SketchPlan(bucket, sign, 2)
    jplan = jsketch.SketchPlan(jnp.asarray(bucket.numpy()),
                               jnp.asarray(sign.numpy()), 2)
    u = np.array([[[0.0, 2.0], [0.0, 3.0]]], np.float32)
    g = np.array([[1.0, 1.0]], np.float32)
    ut = torch.from_numpy(u).requires_grad_(True)
    sketch.decompress(ut, plan).backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda x: jsketch.decompress(x, jplan), jnp.asarray(u))
    (want,) = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(ut.grad.numpy(), np.asarray(want))
    assert ut.grad[0, 0, 0] == 0.5 and ut.grad[0, 1, 0] == 0.5


def test_channel_matches_jax_core_in_bf16():
    """bf16: both sides sum in fp32 and round the sketch to bf16 (the wire
    payload) before the decode, which is exact; they may differ by one bf16
    rounding of a sketch entry (2^-8 relative), which the median can pass
    on: held to 2^-7 of the largest value."""
    plan, jplan = _plans(256, 3, 40)
    h = _h(8, 256, seed=7)
    got = sketch.channel(torch.from_numpy(h).bfloat16(), plan)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jsketch.channel(jnp.asarray(h, jnp.bfloat16), jplan),
                      np.float32)
    assert np.abs(got.float().numpy() - want).max() <= 2 ** -7 * np.abs(
        want).max()
    _close(sketch.channel(torch.from_numpy(h), plan),
           jsketch.channel(jnp.asarray(h), jplan))


def test_wrappers_on_cpu_use_plain_versions_and_launch_nothing():
    plan, _ = _plans(64, 3, 9)
    ops.sketch_scatter.launches = ops.sketch_gather.launches = 0
    h = torch.from_numpy(_h(2, 64)).requires_grad_(True)
    sketch.channel(h, plan).sum().backward()
    assert ops.sketch_scatter.launches == 0 and ops.sketch_gather.launches == 0
    with pytest.raises(ValueError):
        ops.sketch_scatter(torch.zeros(2, 63), plan)
    with pytest.raises(ValueError):
        ops.sketch_gather(torch.zeros(2, 3, 8), plan)
    with FakeTensorMode():              # a device with no kernel
        with pytest.raises(ValueError, match="no kernel"):
            ops.sketch_scatter(torch.empty(2, 64, device="xpu"), plan)
        with pytest.raises(ValueError, match="no kernel"):
            ops.sketch_gather(torch.empty(2, 3, 9, device="xpu"), plan)
    with pytest.raises(TypeError, match="plan"):    # meta needs a meta plan
        ops.sketch_scatter(torch.zeros(2, 64, device="meta"), plan)
    assert ops.sketch_scatter.launches == 0 and ops.sketch_gather.launches == 0


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
def test_median_network_matches_jax(n):
    """``_median`` along an axis, odd and even counts, with repeated values
    so the network meets ties; value and gradient."""
    rng = np.random.default_rng(n)
    x = rng.integers(-3, 4, size=(5, n, 7)).astype(np.float32)
    g = rng.normal(size=(5, 7)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jsketch._median(a, axis=1), jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = sketch._median(xt, 1)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_g))
    # the plain routing weights are exact (sums of products of 0, 1/2, 1):
    # equal to JAX's gradient for a unit cotangent
    w = ref.median_weights(list(torch.from_numpy(x).unbind(1)))
    (ones_g,) = vjp(jnp.ones_like(jnp.asarray(g)))
    np.testing.assert_array_equal(w.permute(0, 2, 1).numpy(),
                                  np.asarray(ones_g))
