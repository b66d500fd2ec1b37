"""Which route the channel's SS-OP and scatter kernels take for a shape, the
gather's tile, the scatter's and the gather's shared-memory mirrors, and the
plan's signed and packed indexes.

``csrc/ssop.cu`` and ``csrc/count_sketch.cu`` each choose a route by shape:
SS-OP the tile route (D split over a cluster, H read once by bulk copies)
where rows of H take 16-byte copies and its shared memory fits, else the
rows route; the scatter a tile of 1 to 8 rows a block where its shared
memory fits, else the rows route (4 rows a block), else nothing.
The gather takes a tile of R rows by a slice of Dc columns a block.
``ssop.ops._tile_plan``, ``count_sketch.ops._scatter_plan``,
``_scatter_smem``, ``_gather_plan`` and ``_gather_smem`` are the C rules'
twins (``chip_smoke.py`` phase 3b and the card tests hold them against the
built library's own answer); these tests pin what they say for the paths'
shapes and that no shape the kernels took before the tile routes is refused
now.  On the CPU the wrappers take the plain versions and launch nothing.
"""
import numpy as np
import pytest
import torch

from repro.core import sketch as jsketch
from repro_torch.core import sketch
from repro_torch.kernels.count_sketch import ops as cs_ops
from repro_torch.kernels.ssop import ops as ssop_ops

# (path, dtype, T, D, r, Y, Z, SS-OP's (cluster, rows a tile, slice),
# the scatter's rows a block for compress and for the median backward):
# the launcher's olmo-1b step (8 x 64 tokens) and a federation client step
# of bert-base (16 x 128 tokens; Z = max(4, int(768 / (2.1 * 3))))
PATHS = [("olmo-1b", torch.bfloat16, 512, 2048, 16, 3, 325, (2, 8, 1024), 4,
          4),
         ("bert-base", torch.float32, 2048, 768, 8, 3, 121, (2, 16, 384), 8,
          4)]


@pytest.mark.parametrize("path", PATHS, ids=[p[0] for p in PATHS])
def test_each_path_takes_the_tile_routes(path):
    _, dtype, T, D, r, Y, Z, ssop_plan, rows_c, rows_m = path
    assert ssop_ops._tile_plan(T, D, r, dtype, aligned=True) == ssop_plan
    C, R, Ds = ssop_plan
    assert C * Ds >= D > (C - 1) * Ds and Ds % 16 == 0
    assert cs_ops._scatter_plan(T, D, Y, Z, False, dtype) == rows_c
    assert cs_ops._scatter_plan(T, D, Y, Z, True, dtype) == rows_m


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_ssop_rows_without_16_byte_copies_take_the_rows_route(dtype):
    el = torch.empty((), dtype=dtype).element_size()
    assert ssop_ops._tile_plan(512, 2048, 16, dtype, aligned=False) is None
    for D in (300, 1004, 2047, 7):
        assert ((D * el) % 16 == 0) == (
            ssop_ops._tile_plan(16, D, 8, dtype, aligned=True) is not None)
    assert ssop_ops._tile_plan(16, 2048, 65, dtype, aligned=True) is None


@pytest.mark.parametrize("r", [1, 3, 8, 16, 33, 64])
def test_ssop_tile_route_takes_every_rank_to_64(r):
    for dtype in (torch.bfloat16, torch.float32):
        plan = ssop_ops._tile_plan(100, 1024, r, dtype, aligned=True)
        assert plan is not None and plan[1] in ssop_ops._TILE_ROWS


@pytest.mark.parametrize("T,R", [(1, 8), (64, 8), (2048, 16), (8192, 32)])
def test_ssop_tile_height_grows_with_t(T, R):
    # D 768 splits over 2 blocks: 32-row tiles once they still leave 256
    # blocks, else 16, else 8
    assert ssop_ops._tile_plan(T, 768, 8, torch.float32, True)[1] == R


@pytest.mark.parametrize("D,C", [(8, 1), (16, 1), (64, 2), (2048, 2),
                                 (2056, 3), (4096, 4), (8192, 8), (16384, 8),
                                 (32768, None)])
def test_ssop_cluster_size_follows_d(D, C):
    # slices of at most 1024 columns over at least 2 blocks, none empty, or
    # over up to 8 where a slice does not fit (D 16384: 8 slices of 2048);
    # at D 32768 a slice of 4096 does not fit (the rows route takes it)
    plan = ssop_ops._tile_plan(512, D, 16, torch.bfloat16, True)
    assert (plan and plan[0]) == C


def test_ssop_shared_memory_mirror_at_the_paths_shapes():
    """The layout of ``tile_layout`` added up by hand at the plans the
    paths take (PATHS): U^T and the tile of H in rows of Ds + 16 / el
    elements, U as it lies (+ 16), the partial sums of 16-row P from 8
    warps (bf16) or 256 / blocks-of-P threads (f32), padded by one, the
    cluster's partials, P, (P W)^T, W and two mbarriers."""
    # olmo-1b: cluster 2, R 8, Ds 1024, r 16, bf16
    bf16 = (16 * 1032 * 2 + 1024 * 16 * 2 + 16 + 16 * 1032 * 2
            + 16 * 16 * 9 * 4 + 2 * 8 * 16 * 4 + 2 * 8 * 16 * 4 + 16 * 16 * 4
            + 16)
    assert ssop_ops._tile_smem(1024, 8, 16, 2, 2) == bf16
    # the federation: cluster 2, R 16, Ds 384, r 8, f32
    f32 = (8 * 388 * 4 + 384 * 8 * 4 + 16 + 16 * 388 * 4 + 16 * 8 * 33 * 4
           + 2 * 16 * 8 * 4 + 2 * 16 * 8 * 4 + 8 * 8 * 4 + 16)
    assert ssop_ops._tile_smem(384, 16, 8, 4, 2) == f32
    assert [p[7] for p in PATHS] == [(2, 8, 1024), (2, 16, 384)]


def test_scatter_shared_memory_mirror():
    """``scatter_layout`` by hand: the mbarrier (16), ptr, order and sidx,
    x's rows and in the median backward u's rows (each + 16 for its shift),
    the first stage's rows x Y x D floats and the rows of the output."""
    T, D, Y, Z = 512, 2048, 3, 325
    ptr = -(-(Y * Z + 1) * 4 // 16) * 16 + 16
    order = -(-Y * Z * 4 // 16) * 16 + 16
    sidx = Y * D * 4 + 16
    xs = 2 * D * 2 + 16
    us = -(-2 * Y * Z * 2 // 16) * 16 + 16
    ob = -(-2 * Y * Z * 2 // 16) * 16
    assert cs_ops._scatter_smem(2, D, Y, Z, False, 2) == \
        16 + ptr + order + sidx + xs + ob
    assert cs_ops._scatter_smem(2, D, Y, Z, True, 2) == \
        16 + ptr + order + sidx + xs + us + 2 * Y * D * 4 + ob


@pytest.mark.parametrize("median_bwd", [False, True], ids=["compress",
                                                           "median_bwd"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_no_scatter_shape_the_rows_kernel_took_is_refused(median_bwd, dtype):
    """Every (D, Y, Z) whose 4 rows of D (+ Y Z) floats fit a block (what
    the wrapper accepted before the tile route) has a route now; larger D
    takes fewer rows a block, then the rows route."""
    el = torch.empty((), dtype=dtype).element_size()
    for D in (8, 50, 768, 2048, 6000, 9000, 14000, 14500, 20000, 60000):
        for Y in (1, 3, 8):
            Z = max(4, int(D / (2.1 * Y)))
            old = 4 * (D + (Y * Z if median_bwd else 0)) * 4 <= \
                cs_ops.MAX_SHARED_BYTES
            rows = cs_ops._scatter_plan(512, D, Y, Z, median_bwd, dtype)
            if old:
                assert rows is not None, (D, Y, Z)
            if rows:
                assert cs_ops._scatter_smem(rows, D, Y, Z, median_bwd, el) \
                    <= cs_ops.MAX_SHARED_BYTES
                bigger = rows * 2
                assert bigger > cs_ops._SCATTER_MAX_ROWS[median_bwd] or \
                    -(-512 // bigger) < cs_ops._SCATTER_TARGET_BLOCKS or \
                    cs_ops._scatter_smem(bigger, D, Y, Z, median_bwd, el) > \
                    cs_ops.MAX_SHARED_BYTES


@pytest.mark.parametrize("T,rows", [(1, 1), (255, 2), (256, 2), (512, 4),
                                    (1024, 8), (2048, 8), (65536, 8)])
def test_scatter_rows_a_block_grow_with_t(T, rows):
    # compress aims at 128 blocks
    assert cs_ops._scatter_plan(T, 768, 3, 121, False, torch.float32) == rows


@pytest.mark.parametrize("T,rows", [(255, 2), (512, 4), (1024, 4), (2048, 4),
                                    (65536, 4)])
def test_median_backward_takes_at_most_4_rows_a_block(T, rows):
    # 128 blocks, at most 4 rows: at the federation's T 2048, 8 rows a block
    # leave 256 blocks but take 130 KB each, one an SM, and are slower (the
    # sweep of chip_smoke.py phase 3b)
    assert cs_ops._scatter_plan(T, 768, 3, 121, True, torch.float32) == rows


@pytest.mark.parametrize("d,y,z,seed", [(256, 3, 40, 0), (2048, 3, 325, 42),
                                        (768, 3, 121, 7), (100, 8, 7, 5)])
def test_order_takes_every_list_once_longest_first(d, y, z, seed):
    plan = sketch.make_plan(d, y, z, seed, device="cpu")
    order, ptr = plan.order.numpy(), plan.ptr.numpy()
    assert plan.order.dtype == torch.int32
    assert sorted(order) == list(range(y * z))
    lengths = np.diff(ptr)[order]
    assert np.all(np.diff(lengths) <= 0)
    # ties keep (y, b) ascending
    same = np.diff(lengths) == 0
    assert np.all(np.diff(order)[same] > 0)


@pytest.mark.parametrize("d,y,z,seed", [(256, 3, 40, 0), (2048, 3, 325, 42),
                                        (768, 3, 121, 7), (100, 8, 7, 5)])
def test_signed_index_holds_the_jax_plans_buckets_and_signs(d, y, z, seed):
    """``sidx`` holds each inverse-index entry d as d (sign +1) or ~d (sign
    -1): decoded, each list (y, b) is ascending, the d of a list are those
    whose bucket is b, and their signs are the JAX plan's (made by the same
    numpy calls)."""
    plan = sketch.make_plan(d, y, z, seed, device="cpu")
    jplan = jsketch.make_plan(d, y, z, seed)
    sidx, ptr = plan.sidx.numpy(), plan.ptr.numpy()
    assert plan.sidx.dtype == torch.int32 and sidx.shape == (y * d,)
    dec = np.where(sidx < 0, ~sidx, sidx)
    bucket, sign = np.asarray(jplan.bucket), np.asarray(jplan.sign)
    for yy in range(y):
        for b in range(z):
            ks = np.arange(ptr[yy * z + b], ptr[yy * z + b + 1])
            assert np.all(np.diff(dec[ks]) > 0)
            assert ks.size == np.sum(bucket[yy] == b)
            np.testing.assert_array_equal(bucket[yy, dec[ks]], b)
            np.testing.assert_array_equal(
                sign[yy, dec[ks]], np.where(sidx[ks] < 0, -1.0, 1.0))


# the gather's tile (rows a block, columns a slice) at each path's shape
GATHER_TILES = {"olmo-1b": (8, 512), "bert-base": (8, 384)}


@pytest.mark.parametrize("d,y,z,seed", [(256, 3, 40, 0), (2048, 3, 325, 42),
                                        (768, 3, 121, 7), (100, 8, 7, 5)])
def test_packed_index_holds_the_jax_plans_buckets_and_signs(d, y, z, seed):
    """``gidx`` holds bucket[y, d] where the sign is +1 and ~bucket[y, d]
    where it is -1: decoded, the JAX plan's buckets and signs (made by the
    same numpy calls), bit for bit."""
    plan = sketch.make_plan(d, y, z, seed, device="cpu")
    jplan = jsketch.make_plan(d, y, z, seed)
    g = plan.gidx.numpy()
    assert plan.gidx.dtype == torch.int32 and g.shape == (y, d)
    assert plan.gidx.is_contiguous()
    np.testing.assert_array_equal(np.where(g < 0, ~g, g),
                                  np.asarray(jplan.bucket))
    np.testing.assert_array_equal(np.where(g < 0, -1.0, 1.0).astype(
        np.float32), np.asarray(jplan.sign))


@pytest.mark.parametrize("path", PATHS, ids=[p[0] for p in PATHS])
def test_each_path_takes_its_gather_tile(path):
    """olmo-1b: D 2048 in 4 slices of 512, 8 rows a block (256 blocks of
    64 runs x 4 row groups); the federation: D 768 in 2 slices of 384, 8
    rows a block (512 blocks of 96 runs x 2 row groups).  Both fill the
    132 SMs with more than the first gather's 8 warps each."""
    name, dtype, T, D, r, Y, Z = path[:7]
    rows, cols = GATHER_TILES[name]
    assert cs_ops._gather_plan(T, D, Y, Z, dtype) == (rows, cols)
    blocks = -(-T // rows) * -(-D // cols)
    runs = cols // (16 // torch.empty((), dtype=dtype).element_size())
    groups = {"olmo-1b": 4, "bert-base": 2}[name]
    assert (blocks, runs) == {"olmo-1b": (256, 64),
                              "bert-base": (512, 96)}[name]
    assert runs * groups <= cs_ops._GATHER_THREADS and groups <= rows
    assert blocks * runs * groups / 32 / 132 > 8


def test_gather_shared_memory_mirror_at_the_paths_tiles():
    """``gather_smem`` by hand: an mbarrier a row (rounded to 16 bytes) and
    the rows of u in their own type (+ 16 for the shift)."""
    # olmo-1b: 8 rows of Y Z = 975 bf16 (15600 bytes)
    assert cs_ops._gather_smem(8, 3, 325, 2) == 64 + 15600 + 16
    # the federation: 8 rows of Y Z = 363 f32 (11616 bytes)
    assert cs_ops._gather_smem(8, 3, 121, 4) == 64 + 11616 + 16
    # rows whose bytes are not a 16-byte multiple round up
    assert cs_ops._gather_smem(3, 3, 325, 2) == 32 + 5856 + 16
    assert [GATHER_TILES[p[0]] for p in PATHS] == [(8, 512), (8, 384)]


@pytest.mark.parametrize("Y", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_no_gather_shape_the_first_kernel_took_is_refused(Y, dtype):
    """Every (D, Y, Z) whose 4 rows of Y Z floats fit a block (what the
    wrapper accepted for the first gather) has a tile now, at every T, and
    its shared memory fits; the tile's columns are whole 16-byte runs, and
    a larger tile of the rule's would not fit or leave too few blocks."""
    el = torch.empty((), dtype=dtype).element_size()
    run = 16 // el
    z_max = cs_ops.MAX_SHARED_BYTES // (4 * Y * 4)
    for D in (1, 7, 50, 768, 2048, 6000, 60000):
        slices = -(-D // cs_ops._GATHER_MAX_COLS)
        for Z in (1, 37, z_max // 2, z_max):
            for T in (1, 5, 512, 2048, 65536):
                plan = cs_ops._gather_plan(T, D, Y, Z, dtype)
                assert plan is not None, (T, D, Y, Z)
                rows, cols = plan
                assert cs_ops._gather_smem(rows, Y, Z, el) <= \
                    cs_ops.MAX_SHARED_BYTES
                assert cols % run == 0 and run <= cols <= max(
                    cs_ops._GATHER_MAX_COLS, run)
                assert -(-D // cols) == slices
                assert 1 <= rows <= cs_ops._GATHER_RULE_ROWS
                bigger = rows * 2
                assert bigger > cs_ops._GATHER_RULE_ROWS or \
                    -(-T // bigger) * slices < \
                    cs_ops._GATHER_TARGET_BLOCKS or \
                    cs_ops._gather_smem(bigger, Y, Z, el) > \
                    cs_ops.MAX_SHARED_BYTES


@pytest.mark.parametrize("T,rows", [(1, 1), (128, 1), (255, 2), (256, 2),
                                    (512, 4), (1024, 8), (2048, 8),
                                    (65536, 8)])
def test_gather_rows_a_block_grow_with_t(T, rows):
    # the federation's D 768 in two slices: the most rows, up to 8, that
    # leave 256 blocks
    assert cs_ops._gather_plan(T, 768, 3, 121, torch.float32) == (rows, 384)


@pytest.mark.parametrize("D,cols", [(1, 8), (50, 56), (512, 512),
                                    (513, 264), (2048, 512), (2056, 416),
                                    (60000, 512)])
def test_gather_slices_split_d_evenly(D, cols):
    # the fewest slices of at most 512 columns, rounded up to 8 bf16
    # columns (a 16-byte run): D 2056 in 5 slices of 412, so 416
    assert cs_ops._gather_plan(512, D, 3, 37, torch.bfloat16)[1] == cols


@pytest.mark.parametrize("rows,cols", [(8, None), (None, 384)])
def test_a_forced_gather_tile_needs_rows_and_cols(rows, cols):
    """Forcing half a tile is refused before anything is launched."""
    plan = sketch.make_plan(768, 3, 121, 0, device="cpu")
    with pytest.raises(ValueError, match="rows and cols"):
        cs_ops._launch("gather", torch.zeros(4, 3, 121), None, plan,
                       torch.empty(4, 768), 4, rows=rows, cols=cols)
