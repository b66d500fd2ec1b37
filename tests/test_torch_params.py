"""Configs, parameter specs and the weight bridge of the port against the
JAX package."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import zoo as jax_zoo
from repro.models.params import count_params as jax_count_params
from repro.models.params import init_tree as jax_init_tree
from repro_torch.bridge import params_from_jax_numpy, params_to_jax_numpy
from repro_torch.configs import get_config
from repro_torch.models import zoo
from repro_torch.models.params import Spec, count_params, init_tree

CFG = get_config("llama3-8b").reduced()
JCFG = jax_get_config("llama3-8b").reduced()


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_matches_jax_field_by_field(reduced):
    cfg, jcfg = get_config("llama3-8b"), jax_get_config("llama3-8b")
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.dtype() == getattr(torch, str(jcfg.dtype()))
    assert cfg.adtype() == getattr(torch, str(jcfg.adtype()))
    assert (cfg.resolved_head_dim, cfg.q_per_kv, cfg.padded_vocab) == (
        jcfg.resolved_head_dim, jcfg.q_per_kv, jcfg.padded_vocab)


def test_unported_arch_and_family_raise():
    with pytest.raises(KeyError, match="ROADMAP"):
        get_config("jamba-v0.1-52b")
    for family in ("hybrid", "ssm", "audio", "vlm"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            zoo.get_model(CFG.with_(family=family))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def test_init_tree_matches_specs_and_jax_count():
    specs = zoo.get_model(CFG).specs(CFG)
    params = init_tree(specs, torch.Generator().manual_seed(0), CFG.dtype(),
                       "cpu")
    spec_leaves = dict(_leaves(specs))
    param_leaves = dict(_leaves(params))
    assert spec_leaves.keys() == param_leaves.keys()
    for path, s in spec_leaves.items():
        t = param_leaves[path]
        assert tuple(t.shape) == s.shape, path
        assert t.dtype == (getattr(torch, s.dtype) if s.dtype else torch.float32)
        assert t.device.type == "cpu"
    assert count_params(specs) == jax_count_params(
        jax_zoo.get_model(JCFG).specs(JCFG))
    emb = params["frozen"]["embed"]
    assert abs(float(emb.std()) - 0.02) < 2e-3          # 'embed' init
    wq = params["frozen"]["blocks"][0]["attn"]["wq"]
    want = specs["frozen"]["blocks"][0]["attn"]["wq"].fan_in_scale()
    assert abs(float(wq.std()) / want - 1) < 0.02               # fan-in
    assert not params["lora"]["blocks"][1]["attn"]["q_b"].any()  # zeros
    again = init_tree(specs, torch.Generator().manual_seed(0), CFG.dtype(),
                      "cpu")
    assert torch.equal(again["frozen"]["embed"], emb)


def test_init_tree_keeps_non_spec_leaves():
    tree = {"k": Spec((2, 3), (None, None), "zeros"), "len": 0,
            "pos": Spec((4,), (None,), "const", -1e9, "int32")}
    out = init_tree(tree, torch.Generator(), torch.float32, "cpu")
    assert out["len"] == 0 and not out["k"].any()
    assert out["pos"].dtype == torch.int32 and int(out["pos"][0]) == -10**9


@pytest.mark.parametrize("seq_len", [32, 96], ids=["plain", "ring"])
def test_cache_specs_match_jax(seq_len):
    ours = zoo.get_model(CFG).cache_specs(CFG, 3, seq_len)["blocks"]
    theirs = jax_zoo.get_model(JCFG).cache_specs(JCFG, 3, seq_len)["blocks"]
    assert len(ours) == CFG.num_layers
    for layer in ours:
        assert layer["len"] == 0
        specs = {k: v for k, v in layer.items() if k != "len"}
        assert specs.keys() == theirs.keys() - {"len"}
        for k, s in specs.items():
            assert (CFG.num_layers,) + s.shape == theirs[k].shape
            assert (s.init, s.scale, s.dtype) == (
                theirs[k].init, theirs[k].scale, theirs[k].dtype)


def test_bridge_round_trips_a_jax_tree_bit_exactly():
    jp = jax_init_tree(jax_zoo.get_model(JCFG).specs(JCFG),
                       jax.random.PRNGKey(3), JCFG.dtype())
    frozen_np = jax.tree_util.tree_map(np.asarray, jp["frozen"])
    lora_np = jax.tree_util.tree_map(
        lambda a: np.random.default_rng(0).normal(size=a.shape).astype(
            np.float32), jp["lora"])
    params = params_from_jax_numpy(CFG, frozen_np, lora_np, device="cpu")
    assert len(params["frozen"]["blocks"]) == CFG.num_layers
    np.testing.assert_array_equal(
        params["frozen"]["blocks"][1]["attn"]["wq"].numpy(),
        frozen_np["blocks"]["attn"]["wq"][1])
    back_frozen, back_lora = params_to_jax_numpy(params)
    for want, got in ((frozen_np, back_frozen), (lora_np, back_lora)):
        w_leaves, w_def = jax.tree_util.tree_flatten(want)
        g_leaves, g_def = jax.tree_util.tree_flatten(got)
        assert w_def == g_def
        for a, b in zip(w_leaves, g_leaves):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_bridge_round_trips_a_tree_with_a_prefix_bit_exactly():
    """deepseek-v2 (reduced, 3 layers): its dense first layer is a list
    under ``"prefix"`` in both packages; JAX -> port -> JAX is bit-equal,
    frozen and LoRA, and ``"blocks"`` holds the other 2 layers."""
    cfg = get_config("deepseek-v2-236b").reduced().with_(num_layers=3)
    jcfg = jax_get_config("deepseek-v2-236b").reduced().with_(num_layers=3)
    jp = jax_init_tree(jax_zoo.get_model(jcfg).specs(jcfg),
                       jax.random.PRNGKey(6), jcfg.dtype())
    frozen_np = jax.tree_util.tree_map(np.asarray, jp["frozen"])
    lora_np = jax.tree_util.tree_map(
        lambda a: np.random.default_rng(1).normal(size=a.shape).astype(
            np.float32), jp["lora"])
    params = params_from_jax_numpy(cfg, frozen_np, lora_np, device="cpu")
    assert len(params["frozen"]["prefix"]) == 1
    assert len(params["frozen"]["blocks"]) == 2
    assert "mlp" in params["frozen"]["prefix"][0]
    assert "moe" in params["frozen"]["blocks"][1]
    back_frozen, back_lora = params_to_jax_numpy(params)
    for want, got in ((frozen_np, back_frozen), (lora_np, back_lora)):
        w_leaves, w_def = jax.tree_util.tree_flatten(want)
        g_leaves, g_def = jax.tree_util.tree_flatten(got)
        assert w_def == g_def
        for a, b in zip(w_leaves, g_leaves):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_bridge_carries_bf16_bit_patterns():
    jp = jax_init_tree(jax_zoo.get_model(JCFG).specs(JCFG),
                       jax.random.PRNGKey(4), jax.numpy.bfloat16)
    np_tree = jax.tree_util.tree_map(np.asarray, jp)
    params = params_from_jax_numpy(CFG, np_tree["frozen"], np_tree["lora"],
                                   device="cpu")
    t = params["frozen"]["embed"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        t.view(torch.int16).numpy(),
        np_tree["frozen"]["embed"].view(np.int16))


def test_bridge_rejects_wrong_depth():
    jp = jax_init_tree(jax_zoo.get_model(JCFG).specs(JCFG),
                       jax.random.PRNGKey(5), JCFG.dtype())
    np_tree = jax.tree_util.tree_map(np.asarray, jp)
    with pytest.raises(ValueError, match="layers"):
        params_from_jax_numpy(CFG.with_(num_layers=3), np_tree["frozen"],
                              np_tree["lora"], device="cpu")
