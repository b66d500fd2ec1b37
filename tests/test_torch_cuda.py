"""The hand-written CUDA kernels (the LoRA projection, SS-OP, the count
sketch and flash attention, forward and backward) against their plain
versions, on the card.

Marked ``cuda``: each test skips, with its reason, where there is no CUDA
device.  On a machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.core.sketch import SketchPlan, make_plan
from repro_torch.kernels.count_sketch import ops as cs_ops
from repro_torch.kernels.count_sketch import ref as cs_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.lora import ops
from repro_torch.kernels.lora.ref import lora_matmul_ref
from repro_torch.kernels.ssop import ops as ssop_ops
from repro_torch.kernels.ssop.ref import ssop_apply_ref

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
# large T, the tile kernels: the paths' shapes (olmo-1b's step, a federation
# client step's q/v and its adapter-free k/o), the cut straddled,
# ragged T, K and O, ranks that are not a multiple of 8 (the decode kernels
# take those) and one that is, and an unaligned O that keeps the decode
# kernels at large T
_CUT = ops._TILE_MIN_ROWS
TILE_SHAPES = [(512, 2048, 2048, 16), (2048, 768, 768, 8), (2048, 768, 768, 0),
               *[(t, 1024, 512, 16) for t in (_CUT - 1, _CUT, _CUT + 1)],
               (1000, 4000, 1000, 16), (200, 776, 392, 3), (129, 512, 136, 64),
               (300, 300, 77, 3)]
# the tile widths csrc/lora_matmul.cu instantiates for each type
TILE_WIDTHS = {torch.bfloat16: (128, 64), torch.float32: (128, 96, 64)}


def _lora_inputs(cuda, T, K, O, r, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(T, K, generator=g, device=cuda).to(dtype)
    w = (torch.randn(K, O, generator=g, device=cuda) / K ** 0.5).to(dtype)
    a = (torch.randn(K, r, generator=g, device=cuda) / K ** 0.5).to(dtype)
    b = (torch.randn(r, O, generator=g, device=cuda) * 0.1).to(dtype)
    return x, w, a, b


def _lora_err(y, x, w, a, b, dtype):
    """max |y - plain| against its tolerance: both accumulate in fp32 and
    round once, so f32 differs by summation order only (1e-5 of the
    output's scale) and bf16 by at most one rounding of the output (2^-7)."""
    want = lora_matmul_ref(x, w, a, b, 2.0).float()
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    return (y.float() - want).abs().max().item(), tol * want.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES + TILE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_lora_kernel_matches_plain(cuda, shape, dtype):
    x, w, a, b = _lora_inputs(cuda, *shape, dtype)
    before = ops.lora_matmul.launches
    y = ops.lora_matmul(x, w, a, b, 2.0)
    torch.cuda.synchronize()
    assert ops.lora_matmul.launches == before + 1
    err, tol = _lora_err(y, x, w, a, b, dtype)
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("seed", [2, 3, 4])
@pytest.mark.parametrize("shape", TILE_SHAPES[:3],
                         ids=lambda s: "x".join(map(str, s)))
def test_lora_bf16_tiles_hold_under_other_seeds(cuda, shape, seed):
    """The paths' large-T shapes in bf16 (x W and x A on wgmma) again on
    other inputs, to the same 2^-7 of the output's scale."""
    x, w, a, b = _lora_inputs(cuda, *shape, torch.bfloat16, seed=seed)
    y = ops.lora_matmul(x, w, a, b, 2.0)
    torch.cuda.synchronize()
    err, tol = _lora_err(y, x, w, a, b, torch.bfloat16)
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(200, 776, 392, 3), (129, 512, 136, 64),
                                   (300, 1024, 520, 33), (16, 2048, 256, 16),
                                   (200, 776, 392, 8), (129, 512, 136, 24)],
                         ids=lambda s: "x".join(map(str, s)))
def test_lora_every_route_and_width_matches_plain(cuda, shape, dtype):
    """Each tile width the library has (the waves pick one per shape) and
    the decode kernels, forced through the private route argument, one
    launch each; the tiles refuse a rank that is not a multiple of 8."""
    x, w, a, b = _lora_inputs(cuda, *shape, dtype)
    for route in ("decode", "tile", *TILE_WIDTHS[dtype]):
        before = ops.lora_matmul.launches
        if route != "decode" and shape[3] % 8:
            with pytest.raises(RuntimeError, match="launch failed"):
                ops._launch(x, w, a, b, 2.0, route=route)
            assert ops.lora_matmul.launches == before
            continue
        y = ops._launch(x, w, a, b, 2.0, route=route)
        torch.cuda.synchronize()
        assert ops.lora_matmul.launches == before + 1
        err, tol = _lora_err(y, x, w, a, b, dtype)
        assert err <= tol, (route, err, tol)


def test_lora_route_rule_matches_its_python_twin(cuda):
    """The C library's choice of kernel against ``_uses_tiles``, over the
    shapes above and the cut sweep's; a tile kernel's plan has 128 rows, a
    width the library instantiates and the grid that covers T x O."""
    shapes = SHAPES + TILE_SHAPES + [(t, k, k, 16) for t in (16, 32, 64, 128,
                                                             256)
                                     for k in (2048, 4096)]
    for T, K, O, r in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            n = 16 // torch.empty((), dtype=dtype).element_size()
            for aligned in {K % n == 0 and O % n == 0, False}:
                got = ops._plan(T, K, O, r, dtype, aligned)
                if not ops._uses_tiles(T, K, O, r, dtype, aligned):
                    assert got is None, (T, K, O, r, dtype)
                    continue
                bo = got[1]
                assert bo in TILE_WIDTHS[dtype], (T, K, O, r, dtype, got)
                assert got[:4] == (128, bo, -(-O // bo), -(-T // 128)), \
                    (T, K, O, r, dtype, got)
                assert 1 <= got[4] <= 8, got


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


def test_lora_kernel_backward_matches_plain(cuda):
    """Forward through the kernel, backward by the Function's products,
    against autograd through the plain version (f32: 1e-5 of the scale)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(64, 256, generator=g, device=cuda)
    w = torch.randn(256, 128, generator=g, device=cuda) / 16
    a = torch.randn(256, 8, generator=g, device=cuda) / 16
    b = torch.randn(8, 128, generator=g, device=cuda)
    gy = torch.randn(64, 128, generator=g, device=cuda)
    got, want = [], []
    for fn, out in ((ops.lora_matmul, got), (lora_matmul_ref, want)):
        xs, as_, bs = (t.clone().requires_grad_(True) for t in (x, a, b))
        fn(xs, w, as_, bs, 2.0).backward(gy)
        out += [xs.grad, as_.grad, bs.grad]
    for p, q in zip(got, want):
        assert (p - q).abs().max() <= 1e-5 * q.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_lora_kernel_backward_at_the_training_shape(cuda, dtype):
    """olmo-1b's projection (T 512, K = O = 2048, r 16) through the tile
    kernel, backward by the Function's products, against autograd through
    the plain version: f32 to 1e-5 of each gradient's scale, bf16 to 2^-7
    (the Function's products round in bf16, the plain side's in fp32)."""
    x, w, a, b = _lora_inputs(cuda, 512, 2048, 2048, 16, dtype, seed=1)
    g = torch.Generator(device=cuda).manual_seed(5)
    gy = torch.randn(512, 2048, generator=g, device=cuda).to(dtype)
    got, want = [], []
    for fn, out in ((ops.lora_matmul, got), (lora_matmul_ref, want)):
        xs, as_, bs = (t.clone().requires_grad_(True) for t in (x, a, b))
        fn(xs, w, as_, bs, 2.0).backward(gy)
        out += [xs.grad, as_.grad, bs.grad]
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    for p, q in zip(got, want):
        assert (p.float() - q.float()).abs().max() <= \
            tol * q.float().abs().max()


# ---------------------------------------------------------------------------
# SS-OP and count sketch
# ---------------------------------------------------------------------------

# kernel and plain version both sum in fp32 and round once: f32 differs by
# summation order (1e-5 of the output's scale), bf16 by at most one
# rounding of an output (held to 2^-7 of the scale)
_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}


def _close(got, want, dtype):
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _TOL[dtype] * want.float().abs().max().item(), err


# (T, D, r): the training shape, ragged T and D, r = 64, r not a multiple
# of the 16-column strip
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(512, 2048, 16), (5, 2000, 16),
                                   (3, 64, 64), (7, 300, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_ssop_kernel_and_backward_match_plain(cuda, shape, dtype):
    T, D, r = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    h = torch.randn(T, D, generator=g, device=cuda).to(dtype)
    u = torch.linalg.qr(torch.randn(D, r, generator=g, device=cuda))[0]
    v = torch.linalg.qr(torch.randn(r, r, generator=g, device=cuda))[0]
    w = (v.T - torch.eye(r, device=cuda)).to(dtype)
    u = u.to(dtype).contiguous()
    before = ssop_ops.ssop_apply_td.launches
    y = ssop_ops.ssop_apply_td(h, u, w)
    torch.cuda.synchronize()
    assert ssop_ops.ssop_apply_td.launches == before + 1
    _close(y, ssop_apply_ref(h, u, w), dtype)
    gy = torch.randn(T, D, generator=g, device=cuda).to(dtype)
    hs = h.clone().requires_grad_(True)
    ssop_ops.SSOPFunction.apply(hs, u, w).backward(gy)
    assert ssop_ops.ssop_apply_td.launches == before + 3
    _close(hs.grad, ssop_apply_ref(gy, u, w.T), dtype)


# (T, D, Y, Z): the training shape, ragged D and Z with an even and an odd
# Y, Y = 8, 1 and 2
SKETCH_SHAPES = [(512, 2048, 3, 325), (5, 2000, 4, 37), (5, 2000, 5, 37),
                 (9, 50, 8, 7), (3, 64, 1, 9), (4, 130, 2, 11)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SKETCH_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_sketch_kernels_match_plain(cuda, shape, dtype):
    """compress, decompress (equality: it only gathers and compares), and
    both backwards, with a quarter of the buckets zeroed so the median
    meets ties."""
    T, D, Y, Z = shape
    plan = make_plan(D, Y, Z, seed=1, device=cuda)
    b, s = plan.bucket, plan.sign
    g = torch.Generator(device=cuda).manual_seed(0)
    h = torch.randn(T, D, generator=g, device=cuda).to(dtype)
    n0 = (cs_ops.sketch_scatter.launches, cs_ops.sketch_gather.launches)
    _close(cs_ops.sketch_scatter(h, plan), cs_ref.compress_ref(h, b, s, Z),
           dtype)
    u = torch.randn(T, Y, Z, generator=g, device=cuda).to(dtype)
    u[:, :, :max(1, Z // 4)] = 0
    got = cs_ops.sketch_gather(u, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, cs_ref.decompress_ref(u, b, s))
    _close(cs_ops.sketch_gather(u, plan, median=False),
           cs_ref.gather_sum_ref(u, b, s), dtype)
    gy = torch.randn(T, D, generator=g, device=cuda).to(dtype)
    _close(cs_ops.sketch_scatter(gy, plan, u=u),
           cs_ref.median_backward_ref(gy, u, b, s), dtype)
    torch.cuda.synchronize()
    assert (cs_ops.sketch_scatter.launches, cs_ops.sketch_gather.launches) \
        == (n0[0] + 2, n0[1] + 2)


def test_sketch_autograd_launches_kernels_both_ways(cuda):
    plan = make_plan(256, 3, 40, device=cuda)
    h = torch.randn(2, 3, 256, device=cuda, requires_grad=True)
    n0 = (cs_ops.sketch_scatter.launches, cs_ops.sketch_gather.launches)
    out = cs_ops.sketch_decompress(cs_ops.sketch_compress(h, plan), plan)
    out.backward(torch.ones_like(out))
    assert (cs_ops.sketch_scatter.launches, cs_ops.sketch_gather.launches) \
        == (n0[0] + 2, n0[1] + 2)
    hp = h.detach().clone().requires_grad_(True)
    sk = cs_ref.compress_ref(hp, plan.bucket, plan.sign, 40)
    cs_ref.decompress_ref(sk, plan.bucket, plan.sign).backward(
        torch.ones_like(out))
    assert (h.grad - hp.grad).abs().max() <= 1e-5 * hp.grad.abs().max()


def test_sketch_kernels_reject_what_they_do_not_take(cuda):
    plan = make_plan(64, 9, 8, device=cuda)
    with pytest.raises(ValueError, match="Y"):
        cs_ops.sketch_scatter(torch.randn(2, 64, device=cuda), plan)
    plan = make_plan(64, 3, 8, device=cuda)
    with pytest.raises(TypeError):
        cs_ops.sketch_gather(torch.randn(2, 3, 8, device=cuda).half(), plan)
    cpu_plan = SketchPlan(plan.bucket.cpu(), plan.sign.cpu(), 8)
    with pytest.raises(TypeError, match="plan"):
        cs_ops.sketch_scatter(torch.randn(2, 64, device=cuda), cpu_plan)
    big = make_plan(60000, 3, 8, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        cs_ops.sketch_scatter(torch.randn(1, 60000, device=cuda), big)
    with pytest.raises(ValueError, match="r <="):
        ssop_ops.ssop_apply_td(torch.randn(2, 128, device=cuda),
                               torch.randn(128, 65, device=cuda),
                               torch.randn(65, 65, device=cuda))


# The edges of SS-OP's routes: the federation's shape (T 2048, D 768, r 8),
# T 1, T off the tile's rows (and T a tile plus one), rows of H that take no
# 16-byte copies in bf16 (D 1004: the rows route; the tile route in f32), a
# D that splits unevenly over the cluster (2056) and r 1, 8 and 64
SSOP_EDGES = [(2048, 768, 8), (1, 2048, 16), (37, 2048, 16), (17, 768, 8),
              (9, 1004, 5), (33, 2056, 16), (40, 512, 1), (24, 1024, 64),
              (300, 2048, 8)]


def _ssop_inputs(cuda, T, D, r, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    h = torch.randn(T, D, generator=g, device=cuda).to(dtype)
    u = torch.linalg.qr(torch.randn(D, r, generator=g, device=cuda))[0]
    v = torch.linalg.qr(torch.randn(r, r, generator=g, device=cuda))[0]
    w = (v.T - torch.eye(r, device=cuda)).to(dtype)
    return h, u.to(dtype).contiguous(), w


def _unaligned(t):
    """A contiguous copy of t whose data pointer is one element past 16-byte
    alignment."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 and out.is_contiguous()
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SSOP_EDGES,
                         ids=lambda s: "x".join(map(str, s)))
def test_ssop_kernel_edges_on_each_route(cuda, shape, dtype):
    """Each edge through the rule's route, the tile route forced where it
    takes the shape and the rows route forced, against the plain version;
    the library's route is its Python twin's."""
    T, D, r = shape
    h, u, w = _ssop_inputs(cuda, T, D, r, dtype)
    want = ssop_apply_ref(h, u, w)
    plan = ssop_ops._plan(T, D, r, dtype, True)
    twin = ssop_ops._tile_plan(T, D, r, dtype, True)
    assert (plan is None) == (twin is None)
    if plan is not None:
        assert plan[:2] == twin[:2] and plan[3] == twin[2]
    before = ssop_ops.ssop_apply_td.launches
    _close(ssop_ops.ssop_apply_td(h, u, w), want, dtype)
    assert ssop_ops.ssop_apply_td.launches == before + 1
    routes = ["rows"] + (["tile"] if twin is not None else [])
    for route in routes:
        _close(ssop_ops._launch(h, u, w, route=route), want, dtype)
    # an unaligned h takes the rows route and gives the same
    assert ssop_ops._tile_plan(T, D, r, dtype, False) is None
    _close(ssop_ops.ssop_apply_td(_unaligned(h), u, w), want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cluster,rows", [(1, 8), (2, 16), (4, 32), (8, 8),
                                          (4, 16)])
def test_ssop_tile_route_sweep_configurations(cuda, cluster, rows, dtype):
    """Every cluster size and tile height phase 3b sweeps, at olmo-1b's and
    the federation's widths and at a T off every tile height, against the
    plain version; a configuration whose shared memory (the mirror's) does
    not fit is refused."""
    el = torch.empty((), dtype=dtype).element_size()
    for T, D, r in ((512, 2048, 16), (2048, 768, 8), (77, 2048, 16)):
        h, u, w = _ssop_inputs(cuda, T, D, r, dtype, seed=cluster + rows)
        want = ssop_apply_ref(h, u, w)
        Ds = ssop_ops._round_up(-(-D // cluster), 16)
        fits = ssop_ops._tile_smem(Ds, rows, r, el, cluster) <= \
            ssop_ops._MAX_SMEM

        def run():
            return ssop_ops._launch(h, u, w, route="tile", cluster=cluster,
                                    rows=rows)
        if fits:
            _close(run(), want, dtype)
        else:
            with pytest.raises(RuntimeError, match="launch failed"):
                run()


def test_ssop_tile_route_is_deterministic(cuda):
    """The cluster sums its partials in rank order: the same inputs give
    the same bits, launch after launch."""
    h, u, w = _ssop_inputs(cuda, 2048, 768, 8, torch.float32, seed=3)
    first = ssop_ops.ssop_apply_td(h, u, w)
    for _ in range(5):
        assert torch.equal(ssop_ops.ssop_apply_td(h, u, w), first)


# The edges of the scatter's routes: the federation's shape (T 2048, D 768,
# Y 3, Z 121), T 1, T off every tile height, rows of x and u that are not
# 16-byte multiples (D 50, Y Z 35), Y 1 to 8 with ties, and a D whose first
# stage does not fit for 8 rows (D 6000, Y 8: fewer rows a block)
SCATTER_EDGES = [(2048, 768, 3, 121), (1, 2048, 3, 325), (13, 768, 3, 121),
                 (7, 50, 5, 7), (9, 130, 1, 11), (6, 64, 2, 9),
                 (11, 300, 4, 21), (5, 333, 6, 13), (10, 96, 7, 5),
                 (300, 6000, 8, 40)]


def _sketch_inputs(cuda, T, D, Y, Z, dtype, seed=0):
    plan = make_plan(D, Y, Z, seed=1, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(seed)
    h = torch.randn(T, D, generator=g, device=cuda).to(dtype)
    u = torch.randn(T, Y, Z, generator=g, device=cuda).to(dtype)
    u[:, :, :max(1, Z // 4)] = 0
    gy = torch.randn(T, D, generator=g, device=cuda).to(dtype)
    return plan, h, u, gy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SCATTER_EDGES,
                         ids=lambda s: "x".join(map(str, s)))
def test_sketch_scatter_edges_on_each_route(cuda, shape, dtype):
    """Compress and the median backward through the rule's route, through
    every tile height that fits and through the rows route, on aligned and
    on offset (unaligned) rows, against the plain versions; the library's
    route is its Python twin's, and its shared memory the mirror's."""
    T, D, Y, Z = shape
    plan, h, u, gy = _sketch_inputs(cuda, T, D, Y, Z, dtype)
    b, s = plan.bucket, plan.sign
    # the plan's signed index, built on the card: each entry of list (y, z)
    # decodes to a d with bucket[y, d] = z, negative where sign[y, d] = -1
    lists = torch.repeat_interleave(torch.arange(Y * Z, device=cuda),
                                    torch.diff(plan.ptr.long()))
    d = torch.where(plan.sidx < 0, ~plan.sidx, plan.sidx).long()
    assert torch.equal(b[lists // Z, d].long(), lists % Z)
    assert torch.equal(s[lists // Z, d] < 0, plan.sidx < 0)
    el = h.element_size()
    for median_bwd in (False, True):
        want = (cs_ref.median_backward_ref(gy, u, b, s) if median_bwd
                else cs_ref.compress_ref(h, b, s, Z))
        x = gy if median_bwd else h
        uu = u if median_bwd else None
        got_plan = cs_ops._plan_scatter(T, D, Y, Z, median_bwd, dtype)
        rows = cs_ops._scatter_plan(T, D, Y, Z, median_bwd, dtype)
        assert got_plan[0] == rows
        if rows:
            assert got_plan[2] == cs_ops._scatter_smem(rows, D, Y, Z,
                                                       median_bwd, el)
        before = cs_ops.sketch_scatter.launches
        _close(cs_ops.sketch_scatter(x, plan, u=uu), want, dtype)
        assert cs_ops.sketch_scatter.launches == before + 1
        forced = ["rows"] + [
            r for r in (1, 2, 4, 8) if cs_ops._scatter_smem(
                r, D, Y, Z, median_bwd, el) <= cs_ops.MAX_SHARED_BYTES]
        for route in forced:
            out = torch.empty_like(want)
            assert cs_ops._launch("scatter", x, uu, plan, out, T, rows=route)
            _close(out, want, dtype)
        xo = _unaligned(x)
        uo = _unaligned(uu) if median_bwd else None
        _close(cs_ops.sketch_scatter(xo, plan, u=uo), want, dtype)


def test_sketch_scatter_is_deterministic(cuda):
    """A fixed order for every output, no atomics: the same bits, launch
    after launch, in both modes."""
    plan, h, u, gy = _sketch_inputs(cuda, 2048, 768, 3, 121, torch.float32)
    first = (cs_ops.sketch_scatter(h, plan),
             cs_ops.sketch_scatter(gy, plan, u=u))
    for _ in range(5):
        assert torch.equal(cs_ops.sketch_scatter(h, plan), first[0])
        assert torch.equal(cs_ops.sketch_scatter(gy, plan, u=u), first[1])


# The edges of the gather's tiles: the paths' shapes (olmo-1b's D 2048 in
# four slices, the federation's D 768 in two), T 1, ragged D and Z with an
# even and an odd Y, rows of u and of the output that are not 16-byte
# multiples (D 50, Y Z 56; D 333), Y 1 to 8, and a D whose last slice is
# ragged (2056: four slices of 416 and one of 392)
GATHER_EDGES = [(512, 2048, 3, 325), (2048, 768, 3, 121), (1, 2048, 3, 325),
                (5, 2000, 4, 37), (9, 50, 8, 7), (3, 64, 1, 9),
                (13, 130, 2, 11), (7, 333, 5, 13), (10, 96, 6, 5),
                (17, 300, 7, 21), (6, 2056, 3, 40)]


def _gather_tiles(T, D, Y, Z, dtype):
    """Every forced tile phase 3b's sweep could take at this shape: rows 1
    to 32 by D in 1, 2, 4 and 8 slices and the narrowest slice (one run),
    where its shared memory fits."""
    el = torch.empty((), dtype=dtype).element_size()
    run = 16 // el
    cols = {-(-(-(-D // n)) // run) * run for n in (1, 2, 4, 8)} | {run}
    return [(R, Dc) for R in (1, 2, 4, 8, 16, 32) for Dc in sorted(cols)
            if Dc // run <= cs_ops._GATHER_THREADS
            and cs_ops._gather_smem(R, Y, Z, el)
            <= cs_ops.MAX_SHARED_BYTES]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", GATHER_EDGES,
                         ids=lambda s: "x".join(map(str, s)))
def test_sketch_gather_edges_on_each_route(cuda, shape, dtype):
    """Decompress (held by equality: it only gathers, negates and compares)
    and compress backward, with a quarter of the buckets zeroed so the
    median meets ties, through the rule's tile and every forced tile that
    fits, on aligned and on offset (unaligned) rows of u and of the output;
    the library's tile is its Python twin's, and its shared memory the
    mirror's."""
    T, D, Y, Z = shape
    plan, _, u, _ = _sketch_inputs(cuda, T, D, Y, Z, dtype)
    b, s = plan.bucket, plan.sign
    assert torch.equal(torch.where(plan.gidx < 0, ~plan.gidx, plan.gidx), b)
    assert torch.equal(plan.gidx < 0, s < 0)
    el = u.element_size()
    twin = cs_ops._gather_plan(T, D, Y, Z, dtype)
    R, Dc, blocks, smem, threads = cs_ops._plan_gather(T, D, Y, Z, dtype)
    assert (R, Dc) == twin and smem == cs_ops._gather_smem(R, Y, Z, el)
    assert blocks == -(-T // R) * -(-D // Dc)
    runs = Dc * el // 16
    assert threads % runs == 0 and threads // runs <= R
    assert threads <= max(runs, cs_ops._GATHER_THREADS)
    assert cs_ops._plan_gather(T, D, Y, Z, dtype, R, Dc) == (
        R, Dc, blocks, smem, threads)
    for median in (True, False):
        want = (cs_ref.decompress_ref(u, b, s) if median
                else cs_ref.gather_sum_ref(u, b, s))

        def held(got):
            torch.cuda.synchronize()
            if median:
                assert got.dtype == want.dtype and torch.equal(got, want)
            else:
                _close(got, want, dtype)
        before = cs_ops.sketch_gather.launches
        held(cs_ops.sketch_gather(u, plan, median=median))
        assert cs_ops.sketch_gather.launches == before + 1
        held(cs_ops.sketch_gather(_unaligned(u), plan, median=median))
        for R, Dc in _gather_tiles(T, D, Y, Z, dtype):
            for uu, out in ((u, torch.empty_like(want)),
                            (_unaligned(u), _unaligned(want))):
                out.fill_(float("nan"))     # every output must be written
                assert cs_ops._launch("gather", uu, None, plan, out, T,
                                      mode=0 if median else 1, rows=R,
                                      cols=Dc)
                held(out)


def test_sketch_gather_refuses_a_tile_that_does_not_fit(cuda):
    plan, _, u, _ = _sketch_inputs(cuda, 8, 768, 3, 121, torch.float32)
    out = torch.empty(8, 768, device=cuda)
    for R, Dc in ((33, 768), (8, 766), (8, 2048), (0, 768)):
        with pytest.raises(RuntimeError, match="launch failed"):
            cs_ops._launch("gather", u, None, plan, out, 8, rows=R, cols=Dc)


def test_sketch_gather_is_deterministic(cuda):
    """No atomics, a fixed order over y: the same bits, launch after
    launch, in both modes."""
    plan, _, u, _ = _sketch_inputs(cuda, 2048, 768, 3, 121, torch.float32)
    first = (cs_ops.sketch_gather(u, plan),
             cs_ops.sketch_gather(u, plan, median=False))
    for _ in range(5):
        assert torch.equal(cs_ops.sketch_gather(u, plan), first[0])
        assert torch.equal(cs_ops.sketch_gather(u, plan, median=False),
                           first[1])


# (B, S, H, KV, Dh, dtype, causal, window): BERT (non-causal, f32), olmo-1b
# (causal, Dh 128, bf16), ragged lengths, GQA at llama3-8b's ratio, windows
# with and without causality, and a long causal sequence; phase 3c of
# chip_smoke.py runs the same cases at full size.  Then the edges of the
# kernel's 64-row tiles (and of the 16-row mma fragments inside them): S 1,
# 15, 17, 63, 65 and 129 in bf16 at both head dims, causal and full; a
# window of 70 and GQA with G 4 in bf16; f32 at S 129.
FLASH_CASES = [
    (2, 128, 12, 12, 64, torch.float32, False, 0),
    (2, 64, 16, 16, 128, torch.bfloat16, True, 0),
    (2, 24, 4, 4, 64, torch.float32, False, 0),
    (1, 100, 4, 2, 64, torch.bfloat16, True, 0),
    (1, 1000, 2, 2, 128, torch.float32, True, 0),
    (1, 512, 32, 8, 128, torch.bfloat16, True, 0),
    (1, 1000, 4, 4, 64, torch.float32, True, 128),
    (1, 300, 2, 1, 64, torch.float32, False, 70),
    (1, 2048, 2, 2, 128, torch.bfloat16, True, 0),
] + [
    (2, S, 4, 2, Dh, torch.bfloat16, causal, 0)
    for S in (1, 15, 17, 63, 65, 129) for Dh in (64, 128)
    for causal in (True, False)
] + [
    (1, 300, 4, 2, 128, torch.bfloat16, False, 70),
    (2, 200, 8, 2, 64, torch.bfloat16, True, 0),
    (2, 129, 4, 4, 64, torch.float32, True, 0),
]


def _flash_inputs(cuda, B, S, H, KV, Dh, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(B, S, n, Dh, generator=g, device=cuda).to(dtype)
            for n in (H, KV, KV)]


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "-".join(str(x).removeprefix("torch.")
                                                for x in c))
def test_flash_kernel_and_gradient_match_plain(cuda, case):
    """The forward against the plain version: both take fp32 scores and
    sums and round o once, so f32 is held to 1e-5 and bf16 to 2^-7 of
    max|o| (summation order; one bf16 rounding); m and l to 1e-5.  The
    gradient of the Function (the recomputing backward) against autograd
    through the plain version: f32 to 1e-4 and bf16 to 2^-6 of the
    gradient's largest value (the Function takes Σ dO·O from the rounded o,
    autograd from the unrounded one; each gradient is rounded once)."""
    B, S, H, KV, Dh, dtype, causal, window = case
    q, k, v = _flash_inputs(cuda, B, S, H, KV, Dh, dtype)
    n0 = fa_ops.flash_attention_fwd.launches
    o, m, l = fa_ops.flash_attention_fwd(q, k, v, causal=causal,
                                         window=window, scale=Dh ** -0.5)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention_fwd.launches == n0 + 1
    ro, rm, rl = attention_ref(q, k, v, causal=causal, window=window)
    assert o.shape == ro.shape and o.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    assert (o.float() - ro.float()).abs().max() <= tol * ro.float().abs().max()
    assert (m - rm).abs().max() <= 1e-5 * rm.abs().max()
    assert (l - rl).abs().max() <= 1e-5 * rl.abs().max()

    g = torch.Generator(device=cuda).manual_seed(1)
    do = torch.randn(o.shape, generator=g, device=cuda).to(dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(fa_ops.flash_attention(
        *leaves, causal=causal, window=window), leaves, do)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(
        *plain, causal=causal, window=window)[0], plain, do)
    gtol = 1e-4 if dtype == torch.float32 else 2 ** -6
    for a, b in zip(got, want):
        assert a.dtype == dtype
        err = (a.float() - b.float()).abs().max()
        assert err <= gtol * b.float().abs().max(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_kernel_takes_more_queries_than_keys(cuda, dtype, causal):
    """Sq 200 against Sk 130 with a window of 80: the last query rows see
    only the window's first keys (rows >= 130 attend to none of their
    own).  The forward and the gradient against the plain version, with
    the tolerances of the cases above; a window that leaves a row with no
    key at all (Sq >= Sk + window) is refused."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(1, 200, 4, 64, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(1, 130, 2, 64, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    o, m, l = fa_ops.flash_attention_fwd(q, k, v, causal=causal, window=80,
                                         scale=0.125)
    ro, rm, rl = attention_ref(q, k, v, causal=causal, window=80)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    assert (o.float() - ro.float()).abs().max() <= tol * ro.float().abs().max()
    assert (m - rm).abs().max() <= 1e-5 * rm.abs().max()
    assert (l - rl).abs().max() <= 1e-5 * rl.abs().max()
    do = torch.randn(o.shape, generator=g, device=cuda).to(dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(fa_ops.flash_attention(
        *leaves, causal=causal, window=80), leaves, do)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(
        *plain, causal=causal, window=80)[0], plain, do)
    gtol = 1e-4 if dtype == torch.float32 else 2 ** -6
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert (a.float() - b.float()).abs().max() <= \
            gtol * b.float().abs().max()
    with pytest.raises(ValueError, match="attend to no key"):
        fa_ops.flash_attention_fwd(q, k[:, :120], v[:, :120], causal=causal,
                                   window=80, scale=0.125)


@pytest.mark.parametrize("seed", [2, 3, 4])
@pytest.mark.parametrize("case", [c for c in FLASH_CASES
                                  if c[4] == 128 and c[5] == torch.bfloat16],
                         ids=lambda c: "-".join(str(x).removeprefix("torch.")
                                                for x in c))
def test_flash_bf16_d128_holds_under_other_seeds(cuda, case, seed):
    """The bf16 Dh 128 cases (both products on wgmma) again on other
    inputs: o against the plain version to 2^-7 of max|o|, m and l to
    1e-5, as above."""
    B, S, H, KV, Dh, dtype, causal, window = case
    q, k, v = _flash_inputs(cuda, B, S, H, KV, Dh, dtype, seed=seed)
    o, m, l = fa_ops.flash_attention_fwd(q, k, v, causal=causal,
                                         window=window, scale=Dh ** -0.5)
    ro, rm, rl = attention_ref(q, k, v, causal=causal, window=window)
    assert (o.float() - ro.float()).abs().max() <= \
        2 ** -7 * ro.float().abs().max()
    assert (m - rm).abs().max() <= 1e-5 * rm.abs().max()
    assert (l - rl).abs().max() <= 1e-5 * rl.abs().max()


@pytest.mark.parametrize("S", [64, 100])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_flash_kernel_takes_mla_head_dims(cuda, dtype, S):
    """Multi-head latent attention's expanded form (deepseek-v2): q and k
    of head dim 192, v of 128, read at its own width.  The forward and the
    gradient against the plain version at the tolerances of the cases
    above; a pair the kernel has no instantiation for is refused."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k = (torch.randn(2, S, 8, 192, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    v = torch.randn(2, S, 8, 128, generator=g, device=cuda).to(dtype)
    n0 = fa_ops.flash_attention_fwd.launches
    o, m, l = fa_ops.flash_attention_fwd(q, k, v, causal=True, window=0,
                                         scale=192 ** -0.5)
    assert fa_ops.flash_attention_fwd.launches == n0 + 1
    ro, rm, rl = attention_ref(q, k, v, causal=True, window=0)
    assert o.shape == (2, S, 8, 128) and o.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    assert (o.float() - ro.float()).abs().max() <= tol * ro.float().abs().max()
    assert (m - rm).abs().max() <= 1e-5 * rm.abs().max()
    assert (l - rl).abs().max() <= 1e-5 * rl.abs().max()
    do = torch.randn(o.shape, generator=g, device=cuda).to(dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(fa_ops.flash_attention(*leaves, causal=True),
                              leaves, do)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*plain, causal=True)[0], plain,
                               do)
    gtol = 1e-4 if dtype == torch.float32 else 2 ** -6
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert (a.float() - b.float()).abs().max() <= \
            gtol * b.float().abs().max()
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention_fwd(q, k, v[..., :64].contiguous(),
                                   causal=True, window=0, scale=1.0)


def test_flash_kernel_reads_strided_heads(cuda):
    """q, k and v sliced out of larger tensors (every other head, as a
    view): the kernel reads them in place with their strides."""
    big = _flash_inputs(cuda, 2, 77, 8, 8, 64, torch.float32, seed=3)
    q, k, v = (t[:, :, ::2] for t in big)
    assert not q.is_contiguous()
    o, _, _ = fa_ops.flash_attention_fwd(q, k, v, causal=True, window=0,
                                         scale=0.125)
    want = attention_ref(q.contiguous(), k.contiguous(), v.contiguous(),
                         causal=True, window=0)[0]
    assert (o - want).abs().max() <= 1e-5 * want.abs().max()


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _flash_inputs(cuda, 1, 16, 2, 2, 64, torch.float32)
    with pytest.raises(TypeError):
        fa_ops.flash_attention_fwd(q.double(), k.double(), v.double(),
                                   causal=True, window=0, scale=1.0)
    with pytest.raises(TypeError):
        fa_ops.flash_attention_fwd(q, k.bfloat16(), v, causal=True,
                                   window=0, scale=1.0)
    q32, k32, v32 = _flash_inputs(cuda, 1, 16, 2, 2, 32, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention_fwd(q32, k32, v32, causal=True, window=0,
                                   scale=1.0)
    wide = torch.randn(1, 16, 2, 128, device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention_fwd(wide, k, v, causal=True, window=0,
                                   scale=1.0)
    with pytest.raises(ValueError, match="multiple"):
        fa_ops.flash_attention_fwd(q[:, :, :1].expand(1, 16, 3, 64), k, v,
                                   causal=True, window=0, scale=1.0)
    # the kernel copies 16-byte pieces: a bf16 q whose base pointer is 2
    # bytes off is refused
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    buf = torch.empty(qb.numel() + 1, dtype=qb.dtype, device=cuda)
    off = buf.view(-1)[1:].view(qb.shape)
    off.copy_(qb)
    assert off.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="aligned"):
        fa_ops.flash_attention_fwd(off, kb, vb, causal=True, window=0,
                                   scale=1.0)
