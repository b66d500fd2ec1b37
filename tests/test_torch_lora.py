"""The port's fused LoRA projection (``repro_torch.kernels.lora``) against
the JAX package's: its Pallas kernel (interpret mode on the CPU, as
``tests/test_kernels.py`` runs it) and its jnp oracle.

On the CPU the wrapper takes the plain version and launches nothing; the
CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels.lora import ops as jax_lora_ops
from repro.kernels.lora.ref import lora_matmul_ref as jax_lora_ref
from repro_torch.kernels.lora import ops
from repro_torch.kernels.lora.ref import lora_matmul_ref

# f32 on both sides, fp32 accumulation in another summation order: rtol
# 1e-5, with an absolute floor of 1e-5 * max|y| for entries that cancel.
RTOL = 1e-5


def _inputs(t, k, o, r, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, k)).astype(np.float32)
    w = (rng.normal(size=(k, o)) / np.sqrt(k)).astype(np.float32)
    a = (rng.normal(size=(k, r)) / np.sqrt(k)).astype(np.float32)
    b = (rng.normal(size=(r, o)) * 0.1).astype(np.float32)
    return x, w, a, b


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("t,k,o,r", [(3, 256, 512, 4), (5, 512, 1024, 16),
                                     (8, 1024, 512, 8), (16, 128, 256, 64)])
def test_plain_matches_jax_kernel_and_oracle(t, k, o, r):
    x, w, a, b = _inputs(t, k, o, r)
    got = lora_matmul_ref(*(torch.from_numpy(v) for v in (x, w, a, b)), 2.0)
    _close(got, jax_lora_ops.lora_matmul(x, w, a, b, 2.0))
    _close(got, jax_lora_ref(x, w, a, b, 2.0))


def test_wrapper_on_cpu_uses_plain_version_and_launches_nothing():
    x, w, a, b = (torch.from_numpy(v) for v in _inputs(5, 256, 512, 4))
    ops.lora_matmul.launches = 0
    y = ops.lora_matmul(x.reshape(1, 5, 256), w, a, b, 0.5)
    assert y.shape == (1, 5, 512) and y.dtype == torch.float32
    torch.testing.assert_close(y[0], lora_matmul_ref(x, w, a, b, 0.5),
                               rtol=0, atol=0)
    assert ops.lora_matmul.launches == 0


def test_rank_zero_is_the_frozen_projection():
    x, w, _, _ = (torch.from_numpy(v) for v in _inputs(3, 128, 256, 4))
    y = ops.lora_matmul(x, w, x.new_zeros((128, 0)), x.new_zeros((0, 256)),
                        2.0)
    torch.testing.assert_close(y, x @ w, rtol=RTOL, atol=1e-6)


def test_bad_shapes_raise():
    x, w, a, b = (torch.from_numpy(v) for v in _inputs(3, 128, 256, 4))
    with pytest.raises(ValueError):
        ops.lora_matmul(x, w, a, b[:, :255], 1.0)
    with pytest.raises(ValueError):
        ops.lora_matmul(x, w.T.contiguous(), a, b, 1.0)


def test_non_cpu_tensor_never_falls_back_to_the_plain_version():
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel launch, which raises where there is no kernel for it (a
    ``meta`` tensor takes the launch's checks and launches nothing; a fake
    ``xpu`` tensor stands for a device with no kernel)."""
    shapes = ((3, 128), (128, 256), (128, 4), (4, 256))
    with FakeTensorMode():
        x, w, a, b = (torch.empty(s, device="xpu") for s in shapes)
        with pytest.raises(ValueError, match="no kernel"):
            ops.lora_matmul(x, w, a, b, 1.0)
    y = ops.lora_matmul(*(torch.empty(s, device="meta") for s in shapes),
                        1.0)
    assert y.device.type == "meta" and y.shape == (3, 256)
    assert ops.lora_matmul.launches == 0
