"""Which of the LoRA projection's two kernel routes each path's shapes take.

``csrc/lora_matmul.cu`` dispatches by shape: the decode kernels (8 rows of x
a block) below a cut in T or where the 16-byte copies do not hold, the tile
kernels (128 rows a block) from the cut on.  ``ops._uses_tiles`` is that
rule's twin in Python (``chip_smoke.py`` holds it against the C library's
own answer on the card); these tests pin the route of the shapes the
port's three paths launch.  On the CPU the
wrapper takes the plain version and launches nothing.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.lora import ops
from repro_torch.kernels.lora.ref import lora_matmul_ref


def _proj_shapes(arch):
    """(K, O) of the q, k, v and o projections of ``arch``."""
    cfg = get_config(arch)
    hd = cfg.d_model // cfg.num_heads
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    return [(cfg.d_model, q), (cfg.d_model, kv), (cfg.d_model, kv),
            (q, cfg.d_model)]


# (path, dtype, rows of x a call, rank, takes the tiles): serving's decode
# tick (batch 8), the launcher's olmo-1b step (batch 8 x 64), a federation
# client step of bert-base (batch 16 x 128)
PATHS = [("llama3-8b", torch.bfloat16, 8, 16, False),
         ("olmo-1b", torch.bfloat16, 8 * 64, 16, True),
         ("bert-base", torch.float32, 16 * 128, 8, True)]


@pytest.mark.parametrize("arch,dtype,T,r,tiles", PATHS,
                         ids=[p[0] for p in PATHS])
def test_each_path_takes_its_route(arch, dtype, T, r, tiles):
    for K, O in _proj_shapes(arch):
        assert ops._uses_tiles(T, K, O, r, dtype, aligned=True) == tiles, \
            (arch, K, O)


def test_unaligned_shapes_take_the_decode_kernels():
    # O = 77 is not a multiple of 16 bytes' worth of elements in either type
    for dtype in (torch.bfloat16, torch.float32):
        assert not ops._uses_tiles(2048, 768, 77, 8, dtype, aligned=False)
        assert not ops._uses_tiles(512, 2048, 2048, 16, dtype, aligned=False)


@pytest.mark.parametrize("r", [1, 3, 12, 33, 63])
def test_ranks_off_the_multiples_of_8_take_the_decode_kernels(r):
    for dtype in (torch.bfloat16, torch.float32):
        assert not ops._uses_tiles(2048, 768, 768, r, dtype, aligned=True)
        assert ops._uses_tiles(2048, 768, 768, r - r % 8, dtype, aligned=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_the_cut_is_one_row(dtype):
    cut = ops._TILE_MIN_ROWS
    assert not ops._uses_tiles(cut - 1, 1024, 512, 16, dtype, aligned=True)
    assert ops._uses_tiles(cut, 1024, 512, 16, dtype, aligned=True)
    assert ops._uses_tiles(cut + 1, 1024, 512, 16, dtype, aligned=True)


def test_adapter_free_projections_take_the_tiles():
    # bert-base's k and o carry no adapter in a federation client step (r 0,
    # a multiple of 8): at T 2048 they take the tile kernel without its x A
    # columns, as its q and v (r 8) take it with them
    for r in (0, 8):
        assert ops._uses_tiles(16 * 128, 768, 768, r, torch.float32,
                               aligned=True)
    assert not ops._uses_tiles(8, 4096, 4096, 0, torch.bfloat16,
                               aligned=True)


@pytest.mark.parametrize("T", [512, 2048])
def test_cpu_wrapper_takes_the_plain_version_at_tile_shapes(T):
    rng = np.random.default_rng(T)
    x, w = rng.normal(size=(T, 64)), rng.normal(size=(64, 32)) / 8
    a, b = rng.normal(size=(64, 8)) / 8, rng.normal(size=(8, 32))
    x, w, a, b = (torch.from_numpy(v).float() for v in (x, w, a, b))
    assert ops._uses_tiles(T, 64, 32, 8, torch.float32, aligned=True)
    before = ops.lora_matmul.launches
    y = ops.lora_matmul(x, w, a, b, 2.0)
    assert ops.lora_matmul.launches == before
    torch.testing.assert_close(y, lora_matmul_ref(x, w, a, b, 2.0),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="no kernel"):
        ops._launch(x, w, a, b, 2.0, route="tile")
