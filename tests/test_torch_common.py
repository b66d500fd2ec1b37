"""The port's model primitives (``repro_torch.models.common``) against the
JAX package's ``repro.models.common`` on the same numpy inputs, at reduced
llama3-8b in f32, to 1e-5: rtol 1e-5 with an absolute floor of
1e-5 * max|y| (fp32 round-off of entries that cancel, in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import common as jc
from repro.models.params import init_tree as jax_init_tree
from repro_torch.configs import get_config
from repro_torch.models import common as tc

CFG = get_config("llama3-8b").reduced()
JCFG = jax_get_config("llama3-8b").reduced()
RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


def _attn_params(cfg, seed=0):
    """Frozen attention weights from the JAX init, LoRA A and B drawn with
    numpy (the JAX init leaves B at zero, which would hide the adapter)."""
    p = jax_init_tree(jc.attn_specs(cfg), jax.random.PRNGKey(seed))
    p = {k: np.asarray(v) for k, v in p.items()}
    rng = np.random.default_rng(seed)
    lp = {k: (rng.normal(size=s.shape) * 0.1).astype(np.float32)
          for k, s in jc.attn_lora_specs(cfg).items()}
    return p, lp


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, CFG.d_model)).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.normal(size=CFG.d_model)).astype(np.float32)}
    _close(tc.apply_norm("rmsnorm", {"scale": _t(p["scale"])}, _t(x)),
           jc.apply_norm("rmsnorm", p, x))


@pytest.mark.parametrize("offset", [0, 57])
def test_rope(offset):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 4, 3, CFG.resolved_head_dim)).astype(np.float32)
    pos = np.arange(offset, offset + 4)
    _close(tc.rope(_t(x), torch.from_numpy(pos), CFG.rope_theta),
           jc.rope(x, jnp.asarray(pos), JCFG.rope_theta))


@pytest.mark.parametrize("target", ["q", "k", "v"])
def test_project(target):
    p, lp = _attn_params(JCFG)
    x = np.random.default_rng(2).normal(size=(3, 1, CFG.d_model)).astype(np.float32)
    ls = CFG.lora.alpha / CFG.lora.rank
    got = tc.project({k: _t(v) for k, v in p.items()},
                     {k: _t(v) for k, v in lp.items()}, _t(x), target, ls)
    _close(got, jc.project(p, lp, x, target, ls))


def test_out_project():
    p, lp = _attn_params(JCFG)
    h, hd = CFG.num_heads, CFG.resolved_head_dim
    att = np.random.default_rng(3).normal(size=(3, 1, h, hd)).astype(np.float32)
    ls = CFG.lora.alpha / CFG.lora.rank
    got = tc.out_project({k: _t(v) for k, v in p.items()},
                         {k: _t(v) for k, v in lp.items()}, _t(att), None, ls)
    _close(got, jc.out_project(p, lp, att, None, ls))


@pytest.mark.parametrize("window,cache_len,steps", [(0, 16, 6), (8, 8, 13)],
                         ids=["plain", "ring"])
def test_attn_apply_with_cache(window, cache_len, steps):
    """Decode steps through attn_apply; the ring case wraps the 8-slot
    cache once the cursor passes the window."""
    cfg, jcfg = CFG.with_(sliding_window=window), JCFG.with_(sliding_window=window)
    p, lp = _attn_params(jcfg, seed=4)
    B, kv, hd = 2, cfg.num_kv_heads, cfg.resolved_head_dim
    jcache = {"k": jnp.zeros((B, cache_len, kv, hd)),
              "v": jnp.zeros((B, cache_len, kv, hd)),
              "len": jnp.zeros((), jnp.int32)}
    tcache = {"k": torch.zeros(B, cache_len, kv, hd),
              "v": torch.zeros(B, cache_len, kv, hd), "len": 0}
    if window:
        jcache["pos"] = jnp.full((cache_len,), -1e9, jnp.int32)
        tcache["pos"] = torch.full((cache_len,), -1e9, dtype=torch.int32)
    tp = {k: _t(v) for k, v in p.items()}
    tlp = {k: _t(v) for k, v in lp.items()}
    rng = np.random.default_rng(5)
    for step in range(steps):
        x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        jy, jcache = jc.attn_apply(jcfg, p, lp, x,
                                   positions=jcache["len"] + jnp.arange(1),
                                   cache=jcache, window=window)
        ty, tcache = tc.attn_apply(cfg, tp, tlp, _t(x),
                                   positions=step + torch.arange(1),
                                   cache=tcache, window=window)
        _close(ty, jy)
        assert tcache["len"] == int(jcache["len"]) == step + 1
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])
    if window:
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))


def _qkv(B, Sk, seed):
    rng = np.random.default_rng(seed)
    H, KV, Dh = CFG.num_heads, CFG.num_kv_heads, CFG.resolved_head_dim
    q = rng.normal(size=(B, 1, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, Dh)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, Dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("chunk", [64, 8], ids=["direct", "chunked"])
def test_gqa_attention_decode_kv_valid(chunk):
    q, k, v = _qkv(2, 32, 6)
    cur = 19
    got = tc.gqa_attention(_t(q), _t(k), _t(v), causal=True, q_offset=cur,
                           kv_valid=cur + 1, chunk=chunk)
    want = jc.gqa_attention(q, k, v, causal=True, q_offset=jnp.int32(cur),
                            kv_valid=jnp.int32(cur + 1), chunk=chunk)
    _close(got, want)


@pytest.mark.parametrize("chunk", [64, 8], ids=["direct", "chunked"])
def test_gqa_attention_decode_ring_positions(chunk):
    """A wrapped 32-slot ring: slots hold positions 40..71 out of order,
    two slots still empty (-1e9), window 24."""
    q, k, v = _qkv(2, 32, 7)
    pos = np.arange(40, 72).astype(np.int32)
    pos = np.roll(pos, 11)
    pos[[3, 17]] = -1_000_000_000
    cur = 71
    got = tc.gqa_attention(_t(q), _t(k), _t(v), causal=True, window=24,
                           q_offset=cur, k_positions=torch.from_numpy(pos),
                           chunk=chunk)
    want = jc.gqa_attention(q, k, v, causal=True, window=24,
                            q_offset=jnp.int32(cur),
                            k_positions=jnp.asarray(pos), chunk=chunk)
    _close(got, want)


def test_apply_mlp():
    p = {k: np.asarray(v) for k, v in jax_init_tree(
        jc.mlp_specs(JCFG), jax.random.PRNGKey(8)).items()}
    x = np.random.default_rng(9).normal(size=(3, 1, CFG.d_model)).astype(np.float32)
    _close(tc.apply_mlp(CFG, {k: _t(v) for k, v in p.items()}, _t(x)),
           jc.apply_mlp(JCFG, p, x))
