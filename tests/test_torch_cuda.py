"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips, with its reason, where there is no CUDA
device.  On a machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.lora import ops
from repro_torch.kernels.lora.ref import lora_matmul_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (T, K, O, r): decode shapes, several T tiles, ragged K and O, O that is
# not a multiple of the 16-byte vector (element loads), r = 0, r = 64, r
# that is not a multiple of 8 (A padded in shared memory) or leaves a 16-
# column strip of A empty (r = 40), and enough output tiles that K is not
# split (a cluster of one block)
SHAPES = [(8, 4096, 4096, 16), (8, 4096, 1024, 16), (5, 4000, 1000, 16),
          (17, 300, 77, 3), (1, 64, 33, 0), (40, 1024, 512, 64), (3, 7, 5, 1),
          (8, 1024, 512, 12), (8, 512, 256, 40), (64, 512, 8192, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_lora_kernel_matches_plain(cuda, shape, dtype):
    T, K, O, r = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(T, K, generator=g, device=cuda).to(dtype)
    w = (torch.randn(K, O, generator=g, device=cuda) / K ** 0.5).to(dtype)
    a = (torch.randn(K, r, generator=g, device=cuda) / K ** 0.5).to(dtype)
    b = (torch.randn(r, O, generator=g, device=cuda) * 0.1).to(dtype)
    before = ops.lora_matmul.launches
    y = ops.lora_matmul(x, w, a, b, 2.0)
    torch.cuda.synchronize()
    assert ops.lora_matmul.launches == before + 1
    want = lora_matmul_ref(x, w, a, b, 2.0).float()
    err = (y.float() - want).abs().max().item()
    scale = want.abs().max().item()
    # both accumulate in fp32 and round once: f32 differs by summation
    # order only; bf16 by at most one rounding of the output
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    assert err <= tol * scale, (err, scale)


def test_lora_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.randn(4, 64, device=cuda)
    w = torch.randn(64, 32, device=cuda)
    a, b = torch.randn(64, 65, device=cuda), torch.randn(65, 32, device=cuda)
    with pytest.raises(ValueError, match="rank"):
        ops.lora_matmul(x, w, a, b, 1.0)
    with pytest.raises(TypeError):
        ops.lora_matmul(x.half(), w.half(), a[:, :4].half(),
                        b[:4].half(), 1.0)
    with pytest.raises(TypeError):
        ops.lora_matmul(x, w.bfloat16(), a[:, :4], b[:4], 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.lora_matmul(x, w.T.contiguous().T, a[:, :4].contiguous(),
                        b[:4], 1.0)
