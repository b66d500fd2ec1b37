"""The port's MoE family (grok-1; deepseek-v2 with MLA and its dense first
layer) against the JAX package's, on the CPU at reduced width in f32, on
weights carried across with :mod:`repro_torch.bridge`: the configs, the
parameter counts of the full specs, ``moe_apply`` (output, aux, input
gradient and the routing itself, with ties and dropped tokens), MLA's
expanded and absorbed forms, ``lm_forward``, ``lm_decode_step`` against the
prefill, and one ``make_train_step`` step through ELSA's channel.

The JAX package's ``moe_apply`` does not return its routing; ``_jax_routing``
is its routing lines (``repro/models/moe.py:53-65``) with the live
``jax.lax.top_k``, whose tie order (lower index first) the port's stable
sort must reproduce.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.sketch import SketchPlan as JaxSketchPlan
from repro.core.split_training import Channel as JaxChannel
from repro.core.ssop import SSOP as JaxSSOP
from repro.launch import train as jax_train
from repro.models import mla as jax_mla
from repro.models import moe as jax_moe
from repro.models import transformer as jax_transformer
from repro.models import zoo as jax_zoo
from repro.models.params import count_params as jax_count_params
from repro.models.params import is_spec as jax_is_spec
from repro.optim import AdamW as JaxAdamW
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.models import mla, moe, transformer, zoo
from repro_torch.models.params import count_params, init_tree
from repro_torch.optim import AdamW

ARCHS = ["grok-1-314b", "deepseek-v2-236b"]
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch ops on one CPU thread (the suite runs several
    test processes at once; oversubscribed thread pools make these many
    small ops far slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    return (get_config(arch).reduced().with_(**kw),
            jax_get_config(arch).reduced().with_(**kw))


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _random_b(tree, rng, std=0.1):
    """Every LoRA ``*_b`` leaf drawn from numpy (the init leaves B at zero,
    which would hide the adapter)."""
    if isinstance(tree, dict):
        return {k: ((rng.normal(size=v.shape) * std).astype(np.float32)
                    if k.endswith("_b") else _random_b(v, rng, std))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_random_b(v, rng, std) for v in tree]
    return np.asarray(tree)


def _np_init(specs, seed):
    """A JAX spec tree drawn with numpy by the JAX init's law
    (``repro/models/params.py::_leaf_init``), f32 unless a leaf sets its
    dtype: the JAX init of a whole model costs seconds, numpy's draw
    milliseconds."""
    rng = np.random.default_rng(seed)

    def leaf(s):
        dtype = np.dtype(s.dtype or np.float32)
        if s.init == "zeros":
            return np.zeros(s.shape, dtype)
        if s.init == "ones":
            return np.ones(s.shape, dtype)
        if s.init == "const":
            return np.full(s.shape, s.scale, dtype)
        std = 0.02 if s.init == "embed" else s.scale * s.fan_in_scale()
        return (rng.normal(size=s.shape) * std).astype(dtype)

    return jax.tree_util.tree_map(leaf, specs, is_leaf=jax_is_spec)


@functools.lru_cache(maxsize=None)
def _jax_weights(arch, layers):
    jcfg = _cfgs(arch, num_layers=layers)[1]
    tree = _np_init(jax_zoo.get_model(jcfg).specs(jcfg), 0)
    return tree["frozen"], _random_b(tree["lora"], np.random.default_rng(1))


def _weights(arch, layers=2):
    """JAX-initialized frozen and LoRA trees as numpy (a fresh copy of
    each call's cached draw)."""
    return jax.tree_util.tree_map(np.array, _jax_weights(arch, layers))


def _soften(frozen):
    """wq/wk (grok) and the query up-projection (deepseek) scaled by 0.1:
    at the JAX init the attention is sharp enough (scores ~ 10^2) that
    either package's f32 round-off is amplified far above their agreement
    (``tests/test_torch_train.py`` holds olmo's logits at 1e-3 for that
    reason)."""
    for layer in frozen.get("prefix", []) + [frozen["blocks"]]:
        for k in ("wq", "wk", "w_uq"):
            if k in layer["attn"]:
                layer["attn"][k] = layer["attn"][k] * np.float32(0.1)
    return frozen


def _both(cfg, frozen, lora):
    port = bridge.params_from_jax_numpy(cfg, frozen, lora, device="cpu")
    jx = jax.tree_util.tree_map(jnp.asarray, (frozen, lora))
    return port, jx


# ---------------------------------------------------------------------------
# configs and specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch, reduced):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.padded_vocab == jcfg.padded_vocab
    assert zoo.get_model(cfg).specs is transformer.lm_specs


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_of_the_full_specs_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    specs = zoo.get_model(cfg).specs(cfg)
    jspecs = jax_zoo.get_model(jcfg).specs(jcfg)
    for part in ("frozen", "lora"):
        assert count_params(specs[part]) == jax_count_params(jspecs[part])
    n_prefix = 1 if arch.startswith("deepseek") else 0
    assert len(specs["frozen"]["blocks"]) == cfg.num_layers - n_prefix
    assert len(specs["frozen"].get("prefix", [])) == n_prefix


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_jax(arch):
    """MLA's latent cache (deepseek) or GQA's k/v (grok), a prefix layer's
    under ``"prefix"``; the cursor a host int."""
    cfg, jcfg = _cfgs(arch, num_layers=3)
    ours = zoo.get_model(cfg).cache_specs(cfg, 3, 24)
    theirs = jax_zoo.get_model(jcfg).cache_specs(jcfg, 3, 24)
    assert ours.keys() == theirs.keys()
    n_scan = len(ours["blocks"])
    pairs = [(layer, {k: s._replace(shape=s.shape[1:])
                      for k, s in theirs["blocks"].items()})
             for layer in ours["blocks"]]
    pairs += list(zip(ours.get("prefix", []), theirs.get("prefix", [])))
    for layer, want in pairs:
        assert layer["len"] == 0
        assert layer.keys() == want.keys()
        for k, s in layer.items():
            if k != "len":
                assert (s.shape, s.init) == (want[k].shape, want[k].init), k
    assert n_scan == 3 - ("prefix" in ours)
    assert ("c_kv" in ours["blocks"][0]) == arch.startswith("deepseek")


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

def _jax_routing(jcfg, router, xt):
    """``repro/models/moe.py:53-65``: (sel, keep) of the JAX package."""
    m = jcfg.moe
    C = jax_moe._capacity(m, xt.shape[0])
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ router, -1)
    _, sel = jax.lax.top_k(probs, m.experts_per_token)
    flat_e = sel.reshape(-1)
    oh = jax.nn.one_hot(flat_e, m.num_experts, dtype=jnp.int32)
    pos_in_e = ((jnp.cumsum(oh, axis=0) - oh) * oh).sum(-1)
    return np.asarray(sel), np.asarray(pos_in_e < C)


@pytest.mark.parametrize("router,capacity", [
    ("random", 1.25), ("zero", 1.25), ("random", 0.25)],
    ids=["random", "zero-router-ties", "tokens-dropped"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, router, capacity):
    """Output, aux and the input gradient to 1e-5 of their scale; the
    routing (``sel``, ``keep``) equal as integers.  A zero router makes
    every probability tie (both packages must then take experts 0..k-1,
    and the capacity then drops tokens); capacity 0.25 drops tokens of a
    random router."""
    cfg, jcfg = _cfgs(arch)
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe,
                                            capacity_factor=capacity))
    jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe,
                                              capacity_factor=capacity))
    p_np = _np_init(jax_moe.moe_specs(jcfg), 2)
    if router == "zero":
        p_np["router"] = np.zeros_like(p_np["router"])
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    c_aux = 3.0

    jp = jax.tree_util.tree_map(jnp.asarray, p_np)
    @jax.jit
    def jax_side(p, a, g):
        out, vjp = jax.vjp(lambda a: jax_moe.moe_apply(jcfg, p, a), a)
        return out, vjp((g, jnp.asarray(c_aux, jnp.float32)))[0]

    (want, want_aux), want_g = jax_side(jp, jnp.asarray(x), jnp.asarray(g))

    pt = bridge._tree_to_torch(p_np, "cpu", None)
    xt = torch.from_numpy(x).requires_grad_(True)
    got, aux = moe.moe_apply(cfg, pt, xt)
    (got_g,) = torch.autograd.grad((got * torch.from_numpy(g)).sum()
                                   + c_aux * aux, xt)
    assert aux.dtype == torch.float32
    assert _rel_err(got.detach(), want) <= 1e-5
    assert abs(float(aux.detach()) - float(want_aux)) <= \
        1e-5 * abs(float(want_aux))
    assert _rel_err(got_g, want_g) <= 1e-5

    _, _, sel, keep, _ = moe.route(cfg, pt["router"],
                                   torch.from_numpy(x).reshape(-1, cfg.d_model))
    jsel, jkeep = _jax_routing(jcfg, jp["router"],
                               jnp.asarray(x).reshape(-1, cfg.d_model))
    np.testing.assert_array_equal(sel.numpy(), jsel)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    if router == "zero":
        assert (jsel == np.arange(cfg.moe.experts_per_token)).all()
    if router == "zero" or capacity < 1:
        assert not jkeep.all()


def test_capacity_matches_jax():
    m = get_config("deepseek-v2-236b").moe
    jm = jax_get_config("deepseek-v2-236b").moe
    for n in (1, 5, 8, 100, 512, 4096):
        assert moe._capacity(m, n) == jax_moe._capacity(jm, n)
    assert moe._capacity(m, 8) == 8 and moe._capacity(m, 512) == 24


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla_weights():
    cfg, jcfg = _cfgs("deepseek-v2-236b")
    p_np = _np_init(jax_mla.mla_specs(jcfg), 4)
    l_np = _random_b(_np_init(jax_mla.mla_lora_specs(jcfg), 5),
                     np.random.default_rng(6))
    return (cfg, jcfg, p_np, l_np,
            bridge._tree_to_torch(p_np, "cpu", None),
            bridge._tree_to_torch(l_np, "cpu", None))


def test_mla_full_matches_jax():
    """The expanded form (attention at qk 48, v 32 on the port's flash
    path) and its input gradient to 1e-5 of their scale."""
    cfg, jcfg, p_np, l_np, pt, lt = _mla_weights()
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    jp, jl = (jax.tree_util.tree_map(jnp.asarray, t) for t in (p_np, l_np))
    @jax.jit
    def jax_side(p, lp, a, g):
        out, vjp = jax.vjp(lambda a: jax_mla.mla_full(
            jcfg, p, lp, a, positions=jnp.arange(S)), a)
        return out, vjp(g)[0]

    want, want_g = jax_side(jp, jl, jnp.asarray(x), jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = mla.mla_full(cfg, pt, lt, xt, positions=torch.arange(S))
    (got_g,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    assert _rel_err(got.detach(), want) <= 1e-5
    assert _rel_err(got_g, want_g) <= 1e-5


def test_mla_decode_matches_jax():
    """The absorbed form over the latent cache, 5 steps from an empty
    cache, to 1e-5; the port's cache is written in place, its cursor a
    host int."""
    cfg, jcfg, p_np, l_np, pt, lt = _mla_weights()
    a = cfg.mla
    jp, jl = (jax.tree_util.tree_map(jnp.asarray, t) for t in (p_np, l_np))
    jcache = {"c_kv": jnp.zeros((B, 8, a.kv_lora_rank)),
              "k_rope": jnp.zeros((B, 8, a.rope_head_dim)),
              "len": jnp.zeros((), jnp.int32)}
    cache = {"c_kv": torch.zeros(B, 8, a.kv_lora_rank),
             "k_rope": torch.zeros(B, 8, a.rope_head_dim), "len": 0}
    ck = cache["c_kv"]
    xs = np.random.default_rng(8).normal(size=(5, B, 1, cfg.d_model))
    jax_step = jax.jit(lambda p, lp, x, c: jax_mla.mla_decode(jcfg, p, lp, x,
                                                              c))
    for t, x in enumerate(xs.astype(np.float32)):
        want, jcache = jax_step(jp, jl, jnp.asarray(x), jcache)
        got, cache = mla.mla_decode(cfg, pt, lt, torch.from_numpy(x), cache)
        assert _rel_err(got, want) <= 1e-5, t
        assert cache["len"] == t + 1 and cache["c_kv"] is ck
        assert _rel_err(cache["c_kv"], jcache["c_kv"]) <= 1e-5


# ---------------------------------------------------------------------------
# the LM: forward, decode, one train step through the channel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_matches_jax(arch):
    """Logits and aux of the reduced model (deepseek: its dense prefix
    layer and one MoE block), with and without remat, to 1e-5 of their
    scale, with the attention softened (``_soften``)."""
    cfg, jcfg = _cfgs(arch)
    frozen, lora = _weights(arch)
    port, (jf, jl) = _both(cfg, _soften(frozen), lora)
    if arch.startswith("deepseek"):
        assert len(port["frozen"]["prefix"]) == 1
        assert len(port["frozen"]["blocks"]) == 1
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, S))
    want, want_aux = jax.jit(lambda f, lp, t: jax_transformer.lm_forward(
        jcfg, f, lp, t))(jf, jl, jnp.asarray(toks))
    for remat in (True, False):
        got, aux = transformer.lm_forward(cfg, port["frozen"], port["lora"],
                                          torch.from_numpy(toks),
                                          remat=remat)
        assert _rel_err(got, want) <= 1e-5
        assert abs(float(aux) - float(want_aux)) <= \
            1e-5 * abs(float(want_aux))
        assert float(aux) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """6 tokens decoded one at a time against the prefill's logits (the
    JAX package's ``lm_forward`` and the port's) and against the JAX
    package's ``lm_decode_step``, to 1e-5 of their scale.  Capacity 2.0,
    so that the prefill's 12 tokens drop none (a dropped token would make
    the two forms differ by design); the attention softened."""
    cfg, jcfg = _cfgs(arch)
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=2.0))
    jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe, capacity_factor=2.0))
    frozen, lora = _weights(arch)
    port, (jf, jl) = _both(cfg, _soften(frozen), lora)
    n = 6
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (B, n))
    prefill, _ = jax.jit(lambda f, lp, t: jax_transformer.lm_forward(
        jcfg, f, lp, t))(jf, jl, jnp.asarray(toks))
    jax_step = jax.jit(lambda f, lp, c, t: jax_transformer.lm_decode_step(
        jcfg, f, lp, c, t))
    port_prefill, _ = transformer.lm_forward(
        cfg, port["frozen"], port["lora"], torch.from_numpy(toks))
    assert _rel_err(port_prefill.detach(), prefill) <= 1e-5
    cache = init_tree(zoo.get_model(cfg).cache_specs(cfg, B, 8), None,
                      torch.float32, "cpu")
    jcache = jax.tree_util.tree_map(jnp.asarray, _np_init(
        jax_zoo.get_model(jcfg).cache_specs(jcfg, B, 8), 0))
    for t in range(n):
        got, cache = transformer.lm_decode_step(
            cfg, port["frozen"], port["lora"], cache,
            torch.from_numpy(toks[:, t:t + 1]))
        want, jcache = jax_step(jf, jl, jcache, jnp.asarray(toks[:, t:t + 1]))
        assert _rel_err(got[:, 0], prefill[:, t]) <= 1e-5, t
        assert _rel_err(got, want) <= 1e-5, t
    assert all(c["len"] == n for c in
               cache["blocks"] + cache.get("prefix", []))


def _orthonormal_u(d):
    """An orthonormal (d, 16) SS-OP basis given to both packages (the
    launchers' own draws are held equal in ``tests/test_torch_train.py``)."""
    rng = np.random.default_rng(42)
    return np.linalg.qr(rng.normal(size=(d, 16)))[0].astype(np.float32)


def test_train_step_through_the_channel_matches_jax():
    """One ``make_train_step`` step of deepseek-v2 through ELSA's channel
    at 5 layers, where ``elsa_boundaries`` gives two real cuts, (1, 1):
    its prefix layer, then MLA + MoE blocks 0 | 1 | 2-3.  The loss to 1e-5 relative and the
    AdamW first moment (0.1 x the LoRA gradient) at the channel's f32
    level, rtol 1e-5 with an absolute floor of 1e-5 of each leaf's largest
    value (they agree to about 2e-6 of it, as the port's own f32 and f64
    steps do).  The updated LoRA moves by about lr x sign(g) at step 1, so
    an entry whose gradient is near 0 may move either way in either
    package: it is held to 1e-3 x lr where |m| is above 1% of its leaf's
    largest value.  The attention is softened."""
    arch, layers = "deepseek-v2-236b", 5
    cfg, jcfg = _cfgs(arch, num_layers=layers)
    assert train.elsa_boundaries(cfg) == jax_train.elsa_boundaries(jcfg) \
        == (1, 1)
    frozen, lora = _weights(arch, layers)
    port, (jf, jl) = _both(cfg, _soften(frozen), lora)
    _, z = train.elsa_channel_specs(cfg)
    ch = {k: v.numpy() for k, v in
          train.channel_params(cfg, z, device="cpu").items()}
    ch["u"] = _orthonormal_u(cfg.d_model)
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, (B, S))

    opt, jopt = AdamW(lr=3e-3), JaxAdamW(lr=3e-3)
    step = train.make_train_step(cfg, optimizer=opt, elsa_z=z)
    jstep = jax.jit(jax_train.make_train_step(jcfg, optimizer=jopt,
                                              elsa_z=z))
    new, state, loss = step(
        port["frozen"], port["lora"], opt.init(port["lora"]),
        {"tokens": torch.from_numpy(toks),
         "_channel": bridge.channel_from_jax_numpy(ch, device="cpu")})
    jnew, jstate, jloss = jstep(
        jf, jl, jopt.init(jl),
        {"tokens": jnp.asarray(toks),
         "_channel": {k: jnp.asarray(v) for k, v in ch.items()}})
    assert np.isfinite(float(loss))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))

    def close(a, b):
        np.testing.assert_allclose(
            a, b, rtol=1e-5, atol=1e-5 * max(float(np.abs(b).max()), 1e-30))

    def firm_close(a, b, m):
        firm = np.abs(m) > 1e-2 * np.abs(m).max()
        assert firm.mean() > 0.5
        assert np.abs(a - b)[firm].max() <= 1e-3 * 3e-3

    got_m = bridge.opt_state_to_jax_numpy(state)["m"]
    want_m = jax.tree_util.tree_map(np.asarray, jstate["m"])
    jax.tree_util.tree_map(close, got_m, want_m)
    jax.tree_util.tree_map(
        firm_close, bridge.params_to_jax_numpy({"frozen": {}, "lora": new})[1],
        jax.tree_util.tree_map(np.asarray, jnew), want_m)
    assert not np.allclose(got_m["blocks"]["attn"]["q_a"], 0)


def test_bridge_carries_the_prefix_and_checks_its_depth():
    cfg, jcfg = _cfgs("deepseek-v2-236b", num_layers=5)
    frozen, lora = _weights("deepseek-v2-236b", 5)
    assert len(frozen["prefix"]) == 1
    port = bridge.params_from_jax_numpy(cfg, frozen, lora, device="cpu")
    assert isinstance(port["frozen"]["prefix"], list)
    assert len(port["frozen"]["blocks"]) == 4
    np.testing.assert_array_equal(
        port["frozen"]["prefix"][0]["mlp"]["w_up"].numpy(),
        frozen["prefix"][0]["mlp"]["w_up"])
    with pytest.raises(ValueError, match="layers"):
        bridge.params_from_jax_numpy(cfg.with_(num_layers=4), frozen, lora,
                                     device="cpu")
    # the leaf order is jax.tree_util.tree_leaves' (prefix before blocks)
    order = bridge.jax_leaf_order(port["lora"])
    want = jax.tree_util.tree_leaves(lora)
    flat = np.concatenate([t.numpy().ravel() for t in order])
    np.testing.assert_array_equal(
        flat, np.concatenate([np.asarray(a).ravel() for a in want]))
