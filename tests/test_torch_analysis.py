"""The port's analysis and dry-run layer (``analysis/{roofline,op_cost,
breakdown}.py``, ``launch/dryrun.py``, ``models/params.py::abstract_tree``,
``models/zoo.py::input_specs`` and the kernel wrappers' declared work and
``meta`` route) against the JAX package's pure-Python functions, on the
CPU: parameter and model-flop counts, roofline terms, skip reasons and the
trees' shapes and bytes for every ported config; one step counted the same
on the CPU and on ``meta``; a hand count; each kernel's bound; the
microbatch extrapolation; the tracked peak; and the dry run's records.

Nothing here compiles JAX: its functions are called on spec trees and
``jax.eval_shape``.  The JAX ``launch/dryrun.py`` sets ``XLA_FLAGS`` when
imported, so it is imported inside a test with the variable restored.
"""
import gzip
import importlib
import json
import os

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.analysis import roofline as jax_roofline
from repro.configs import get_config as jax_get_config
from repro.configs.base import INPUT_SHAPES as JAX_SHAPES
from repro.models import zoo as jax_zoo
from repro.models.params import abstract_tree as jax_abstract_tree
from repro.optim import AdamW as JaxAdamW
from repro_torch.analysis import breakdown, op_cost, roofline
from repro_torch.configs import ASSIGNED, REGISTRY, get_config
from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.core.sketch import SketchPlan, make_plan
from repro_torch.kernels.count_sketch import ops as cs_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.lora import ops as lora_ops
from repro_torch.kernels.ssop import ops as ssop_ops
from repro_torch.launch import dryrun
from repro_torch.models import zoo
from repro_torch.models.params import abstract_tree
from repro_torch.optim import AdamW

ARCHS = sorted(REGISTRY)
SHAPES = sorted(INPUT_SHAPES)


@pytest.fixture(scope="module")
def jax_dryrun():
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def _reduced_olmo(layers=4):
    return get_config("olmo-1b").reduced().with_(num_layers=layers)


@pytest.fixture
def reduced(monkeypatch):
    """``reduced(layers)``: the dry run's olmo-1b becomes the reduced
    config at ``layers`` layers; returns that config."""
    def use(layers=4):
        cfg = _reduced_olmo(layers)
        monkeypatch.setattr(dryrun, "get_config", lambda arch: cfg
                            if arch == "olmo-1b" else get_config(arch))
        return cfg
    return use


# ---------------------------------------------------------------------------
# counts, terms and skips against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_jax(arch, shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    np.testing.assert_allclose(roofline.active_params(cfg),
                               jax_roofline.active_params(jcfg), rtol=1e-12)
    np.testing.assert_allclose(
        roofline.model_flops(cfg, INPUT_SHAPES[shape]),
        jax_roofline.model_flops(jcfg, JAX_SHAPES[shape]), rtol=1e-12)


@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_terms_equal_jax(arch, monkeypatch):
    """The same parsed numbers give the same terms, with the JAX module's
    v5e constants set to the port's H100 peaks."""
    dtype = str(get_config(arch).dtype()).removeprefix("torch.")
    monkeypatch.setattr(jax_roofline, "PEAK_FLOPS",
                        roofline.PEAK_FLOPS[dtype])
    monkeypatch.setattr(jax_roofline, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(jax_roofline, "ICI_BW", roofline.NVLINK_BW)
    for i, shape in enumerate(SHAPES):
        cost = {"flops": 3.1e15 * (i + 1), "bytes": 2.7e13 / (i + 1),
                "collective_bytes": {"all-reduce": 1e9 * i}}
        rec = {"status": "ok", "arch": arch, "shape": shape, "chips": 1,
               "dtype": dtype, "parsed": roofline.parsed(cost)}
        assert roofline.roofline_terms(rec) == \
            jax_roofline.roofline_terms(rec)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_skip_reason_equals_jax(arch, shape, jax_dryrun):
    assert dryrun.skip_reason(arch, shape) == \
        jax_dryrun.skip_reason(arch, shape)


# ---------------------------------------------------------------------------
# the trees
# ---------------------------------------------------------------------------

def _port_leaves(tree, path=()):
    """(path without layer indices, shape, dtype) of each tensor leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _port_leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for v in tree:
            yield from _port_leaves(v, path)
    elif isinstance(tree, torch.Tensor):
        yield path, tuple(tree.shape), str(tree.dtype).removeprefix("torch.")


def _jax_leaves(tree, path=(), stacked=False):
    """The same of a JAX abstract tree, each stacked ``blocks`` leaf as its
    layers (the port's list)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jax_leaves(tree[k], path + (k,),
                                   stacked or k == "blocks")
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _jax_leaves(v, path, stacked)
    else:
        shape, dt = tuple(tree.shape), str(tree.dtype)
        if stacked:
            yield from ((path, shape[1:], dt) for _ in range(shape[0]))
        else:
            yield path, shape, dt


def _bytes(leaves):
    return sum(int(np.prod(s)) * np.dtype(jax.numpy.dtype(d)).itemsize
               for _, s, d in leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_trees_equal_jax(arch):
    """``abstract_tree`` and ``input_specs`` give JAX's leaf shapes and
    dtypes, and the frozen, LoRA, AdamW-state and cache trees JAX's bytes.
    Tokens are int64 in the port (twice JAX's int32 bytes); the decode
    cache's cursor ``len`` is a host int in the port (JAX: an int32 scalar
    a layer, left out of its bytes here)."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    specs = zoo.get_model(cfg).specs(cfg)
    jspecs = jax_zoo.get_model(jcfg).specs(jcfg)
    for part in ("frozen", "lora"):
        port = abstract_tree(specs[part], cfg.dtype())
        assert all(t.device.type == "meta"
                   for t in op_cost._tensors(port))
        jtree = jax_abstract_tree(jspecs[part], jcfg.dtype())
        pl, jl = list(_port_leaves(port)), list(_jax_leaves(jtree))
        assert sorted(pl) == sorted(jl)
        assert dryrun.tree_bytes(port) == _bytes(jl)
    lora = abstract_tree(specs["lora"], cfg.dtype())
    jopt = jax.eval_shape(JaxAdamW(lr=1e-4).init,
                          jax_abstract_tree(jspecs["lora"], jcfg.dtype()))
    assert dryrun.tree_bytes(AdamW(lr=1e-4).init(lora)) == \
        _bytes(_jax_leaves(jopt))
    for name, shape in INPUT_SHAPES.items():
        if cfg.family == "encoder" and shape.kind == "decode":
            continue
        ins = zoo.input_specs(cfg, shape)
        jins = jax_zoo.input_specs(jcfg, JAX_SHAPES[name])
        assert {k: tuple(v.shape) for k, v in ins.items()} == \
            {k: tuple(v.shape) for k, v in jins.items()}
        assert dryrun.tree_bytes(ins) == 2 * _bytes(_jax_leaves(jins))
        if shape.kind != "decode":
            continue
        cache = abstract_tree(zoo.get_model(cfg).cache_specs(
            cfg, shape.global_batch, shape.seq_len), cfg.dtype())
        jcache = jax_abstract_tree(jax_zoo.get_model(jcfg).cache_specs(
            jcfg, shape.global_batch, shape.seq_len), jcfg.dtype())
        jl = [x for x in _jax_leaves(jcache) if x[0][-1] != "len"]
        assert sorted(_port_leaves(cache)) == sorted(jl)
        assert dryrun.tree_bytes(cache) == _bytes(jl)


def test_input_specs_raise_for_unported_families():
    for family in ("vlm", "audio"):
        with pytest.raises(NotImplementedError, match="item 10"):
            zoo.input_specs(get_config("olmo-1b").with_(family=family),
                            INPUT_SHAPES["train_4k"])


def test_meta_plan_is_the_cpu_plan_moved():
    cpu = make_plan(64, 3, 9, seed=4, device="cpu")
    meta = make_plan(64, 3, 9, seed=4, device="meta")
    for name in ("bucket", "sign", "ptr", "sidx", "order", "gidx"):
        a, b = getattr(cpu, name), getattr(meta, name)
        assert b.device.type == "meta"
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    with pytest.raises(ValueError, match="CPU"):
        SketchPlan(meta.bucket, meta.sign, 9)


# ---------------------------------------------------------------------------
# the count
# ---------------------------------------------------------------------------

def _step(cfg, device, batch=4, seq=32, nm=1):
    """A reduced ``--elsa`` training step and its arguments on ``device``:
    real weights on the CPU, empty stand-ins on ``meta`` (the dry run's)."""
    if device == "meta":
        fn, args, _ = dryrun.build("olmo-1b", InputShape("t", seq, batch,
                                                         "train"),
                                   elsa=True, microbatches=nm)
        return fn, args
    from repro_torch.launch import train
    from repro_torch.models.params import init_tree
    tree = init_tree(zoo.get_model(cfg).specs(cfg),
                     torch.Generator().manual_seed(0), cfg.dtype(), "cpu")
    opt = AdamW(lr=1e-4)
    _, z = train.elsa_channel_specs(cfg)
    ch = train.channel_params(cfg, z, "cpu")
    ch["plan"] = SketchPlan(ch["bucket"], ch["sign"], z)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq)))
    step = train.make_train_step(cfg, optimizer=opt, elsa_z=z,
                                 num_microbatches=nm)
    return step, (tree["frozen"], tree["lora"], opt.init(tree["lora"]),
                  {"tokens": toks, "_channel": ch})


def test_step_counts_the_same_on_cpu_and_meta(reduced):
    """A reduced olmo-1b ``--elsa`` step: the CPU (plain versions inside the
    kernels' wrappers) and ``meta`` (nothing computed) count the same
    flops, bytes, kernel calls and per-op rows."""
    cfg = reduced()
    (fn, args), (mfn, margs) = _step(cfg, "cpu"), _step(cfg, "meta")
    cpu, _ = op_cost.count(fn, *args)
    meta, _ = op_cost.count(mfn, *margs)
    assert (cpu.cost.flops, cpu.cost.bytes) == (meta.cost.flops,
                                                meta.cost.bytes)
    assert cpu.kernels == meta.kernels
    assert cpu.rows == meta.rows
    # the launches a step implies (chip_smoke.py's _per_step, remat)
    assert {k: v[0] for k, v in meta.kernels.items()} == {
        "ssop_apply": 8, "sketch_scatter": 4, "sketch_gather": 4,
        "lora_matmul": 2 * 4 * cfg.num_layers,
        "flash_attention": 2 * cfg.num_layers}


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_one_layer_count_is_the_hand_count(kind, reduced):
    """A one-layer dense model on ``meta``: its flops are the LoRA
    projections' (their declared work), the attention's (prefill: the flash
    forward's declared work; decode, under inference mode: q·k and p·v
    over the cache as plain products), the MLP's three products and the LM
    head's."""
    cfg = reduced(layers=1)
    B, S = 2, 48
    fn, args, _ = dryrun.build("olmo-1b", InputShape("p", S, B, kind))
    c, _ = op_cost.count(fn, *args)
    T = B * S if kind == "prefill" else B
    D, F, r = cfg.d_model, cfg.d_ff, cfg.lora.rank
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = cfg.dtype()
    lora = sum(lora_ops.work(T, K, O, r, dt)[0] for K, O in (
        (D, H * hd), (D, KV * hd), (D, KV * hd), (H * hd, D)))
    kernels = {"lora_matmul": 4}
    if kind == "prefill":
        attn = fa_ops.work(B, S, S, H, KV, hd, hd, dt, True, 0)[0]
        assert attn == 2 * 2 * hd * B * H * S * (S + 1) // 2
        kernels["flash_attention"] = 1
    else:
        attn = 2 * 2 * B * H * S * hd
    hand = lora + attn + 3 * 2 * T * D * F + 2 * T * D * cfg.padded_vocab
    assert c.cost.flops == hand
    assert {k: v[0] for k, v in c.kernels.items()} == kernels


@pytest.mark.parametrize("case,args,want_us", [
    ("decode q", (lora_ops.work, 8, 4096, 4096, 16, torch.bfloat16), 10.13),
    ("ssop olmo-1b", (ssop_ops.work, 512, 2048, 16, torch.bfloat16), 1.27),
    ("compress olmo-1b", (cs_ops.work, "compress", 512, 2048, 3, 325,
                          torch.bfloat16), 0.94),
    ("flash bert-base", (fa_ops.work, 16, 128, 128, 12, 12, 64, 64,
                         torch.float32, False, 0), 12.02),
])
def test_kernel_work_gives_the_recorded_bounds(case, args, want_us):
    """Each kernel's declared work at a shape of PERF.md's kernel table
    gives the bound printed there (µs, two decimals)."""
    work, *shape = args
    dtype = next(a for a in shape if isinstance(a, torch.dtype))
    ms, _ = roofline.bound_ms(*work(*shape), dtype)
    assert round(ms * 1e3, 2) == want_us


def test_microbatch_extrapolation_equals_the_direct_count(reduced):
    """4 microbatches extrapolated from the counts at 2 and 3 equal the
    count of the 4-microbatch step, row by row."""
    cfg = reduced()
    shape = InputShape("t", 16, 8, "train")
    line, summary = dryrun.count("olmo-1b", shape, elsa=True,
                                 microbatches=4)
    assert summary["counted"] == [2, 3] and summary["extrapolated"]
    fn, args = _step(cfg, "meta", batch=8, seq=16, nm=4)
    direct, _ = op_cost.count(fn, *args)
    assert (line.cost.flops, line.cost.bytes) == (direct.cost.flops,
                                                  direct.cost.bytes)
    assert line.kernels == direct.kernels
    assert {k: v for k, v in line.rows.items() if v[0]} == direct.rows
    assert line.peak_bytes == direct.peak_bytes


def _toy_fresh(a):
    b = a * 2                       # 4000
    c = b.exp()                     # 4000
    del b
    d = torch.cat([c, c])           # 8000: a, c, d live
    return d.sum()                  # 4


def _toy_view(a):
    b = a * 2
    v = b[:1]                       # keeps b's storage
    del b
    c = torch.cat([a, a, a])        # 12000: a, b, c live
    return c.sum() + v.sum()        # two sums and theirs, 4 bytes each


def _toy_saved(a):
    x = a.detach().requires_grad_(True)
    y = x.sin()
    z = y.cos().sum()               # the graph saves y
    del y
    w = torch.cat([x.detach(), x.detach()])   # a, y, z, w live
    return z, w


@pytest.mark.parametrize("fn,peak", [(_toy_fresh, 4000 + 4000 + 8000 + 4),
                                     (_toy_view, 4000 + 4000 + 12000 + 12),
                                     (_toy_saved, 4000 + 4000 + 4 + 8000)])
def test_tracked_peak_of_toy_graphs(fn, peak):
    a = torch.empty(1000, device="meta")
    c, _ = op_cost.count(fn, a)
    assert c.peak_bytes == peak


# ---------------------------------------------------------------------------
# the wrappers on meta
# ---------------------------------------------------------------------------

def _calls(device, plan):
    """Each wrapper's call on small inputs on ``device`` with ``plan``, and
    its launch counter: ``{case: (call, counter owner)}``."""
    g = torch.Generator().manual_seed(0)

    def t(*s, dtype=torch.float32):
        if device == "xpu":             # a fake tensor's placement
            return torch.empty(s, dtype=dtype, device=device)
        return torch.randn(*s, generator=g).to(dtype).to(device)
    x, w, a, b = t(5, 64), t(64, 32), t(64, 4), t(4, 32)
    h, u, ww = t(6, 64), t(64, 4), t(4, 4)
    sk = t(6, 3, 9)
    q, k, v = t(2, 24, 4, 64), t(2, 24, 2, 64), t(2, 24, 2, 64)
    return {
        "lora": (lambda: lora_ops.lora_matmul(x, w, a, b, 2.0),
                 lora_ops.lora_matmul),
        "ssop": (lambda: ssop_ops.ssop_apply_td(h, u, ww),
                 ssop_ops.ssop_apply_td),
        "compress": (lambda: cs_ops.sketch_scatter(h, plan),
                     cs_ops.sketch_scatter),
        "median backward": (lambda: cs_ops.sketch_scatter(h, plan, u=sk),
                            cs_ops.sketch_scatter),
        "decompress": (lambda: cs_ops.sketch_gather(sk, plan),
                       cs_ops.sketch_gather),
        "compress backward": (lambda: cs_ops.sketch_gather(
            sk, plan, median=False), cs_ops.sketch_gather),
        "flash": (lambda: fa_ops.flash_attention_fwd(
            q, k, v, causal=True, window=0, scale=0.125),
            fa_ops.flash_attention_fwd),
    }


def _shapes(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(o.shape), o.dtype) for o in outs]


@pytest.mark.parametrize("case", ["lora", "ssop", "compress",
                                  "median backward", "decompress",
                                  "compress backward", "flash"])
def test_wrapper_on_meta_gives_the_cpu_shapes_and_launches_nothing(case):
    plan = make_plan(64, 3, 9, seed=1, device="cpu")
    call, owner = _calls("cpu", plan)[case]
    want = _shapes(call())
    call, owner = _calls("meta", plan.to("meta"))[case]
    before = owner.launches
    got = call()
    assert all(o.device.type == "meta" for o in
               (got if isinstance(got, tuple) else (got,)))
    assert _shapes(got) == want
    assert owner.launches == before
    with FakeTensorMode():              # a device with no kernel
        call, owner = _calls("xpu", plan)[case]
        with pytest.raises(ValueError, match="no kernel"):
            call()


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_run_one_writes_ok_records(shape, tmp_path, capsys, reduced):
    """Reduced olmo-1b (2 layers) in each kind at the full input shapes:
    an ``ok`` record with the trees' bytes, the peak, the count and the
    roofline terms; its op rows read back by ``breakdown``; the roofline
    table lists it."""
    reduced(layers=2)
    rec = dryrun.run_one("olmo-1b", shape, out_dir=str(tmp_path),
                         elsa=True)
    assert rec["status"] == "ok", rec.get("traceback")
    name = f"olmo-1b__{shape}__h100x1"
    on_disk = roofline.load_record(str(tmp_path / f"{name}.json"))
    assert on_disk["peak_bytes"] >= on_disk["trees"]["frozen"] > 0
    assert on_disk["fits"] is True
    assert on_disk["roofline"] == roofline.roofline_terms(on_disk)
    kind = INPUT_SHAPES[shape].kind
    assert on_disk["extrapolated"] == (kind == "train")
    assert ("opt_state" in on_disk["trees"]) == (kind == "train")
    assert ("cache" in on_disk["trees"]) == (kind == "decode")
    with gzip.open(tmp_path / f"{name}.ops.json.gz", "rt") as f:
        rows = json.load(f)
    assert sum(r["flops"] for r in rows) == pytest.approx(
        on_disk["cost"]["flops"], rel=1e-12)
    assert "| olmo-1b | " + shape + " | ok |" in roofline.make_table(
        [on_disk])
    capsys.readouterr()
    breakdown.main([str(tmp_path / name), "--by", "flops", "--top", "3"])
    out = capsys.readouterr().out
    assert out.startswith("total flops:") and "(top 3 = " in out


def test_failed_record_makes_main_exit_1(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no card for this")
    monkeypatch.setattr(dryrun, "count", boom)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "olmo-1b", "--shape", "decode_32k",
                     "--out-dir", str(tmp_path)])
    assert e.value.code == 1
    rec = json.loads((tmp_path / "olmo-1b__decode_32k__h100x1.json")
                     .read_text())
    assert rec["status"] == "error" and "no card" in rec["traceback"]


@pytest.mark.parametrize("flag", ["--multi-pod", "--per-pod-lora",
                                  "--expert-parallel", "--fsdp"])
def test_mesh_flags_raise_naming_item_8(flag):
    with pytest.raises(NotImplementedError, match="item 8"):
        dryrun.main(["--all", flag])


@pytest.mark.parametrize("argv,want", [
    (["--all"], [(a, s) for a in ASSIGNED for s in INPUT_SHAPES]),
    (["--arch", "grok-1-314b"], [("grok-1-314b", s) for s in INPUT_SHAPES]),
    (["--arch", "olmo-1b", "--shape", "decode_32k"],
     [("olmo-1b", "decode_32k")])])
def test_main_runs_its_combinations(argv, want, monkeypatch, tmp_path):
    seen = []
    monkeypatch.setattr(dryrun, "run_one", lambda a, s, **kw: seen.append(
        (a, s)) or {"status": "skipped"})
    dryrun.main(argv + ["--out-dir", str(tmp_path)])
    assert seen == want
