"""The port's causal-LM split model (``CausalLMSplitModel``, the federation
of the dense decoders) against the JAX package's, on bridged reduced
llama3-8b weights, and a reduced llama3-8b federation on both of the
port's backends against the JAX package's in x64.

Both packages compute rope's angles and their cos/sin in f32 whatever the
activations' dtype, and XLA's and PyTorch's f32 cos/sin differ by an ulp
on some angles (``tests/test_torch_serving.py``), so the f64 comparisons
run both packages' rope with f64 angles.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.federation.simulation import FedConfig as JaxFedConfig
from repro.federation.simulation import Federation as JaxFederation
from repro.models import common as jax_common
from repro.models.params import init_tree as jax_init_tree
from repro.models.split_api import CausalLMSplitModel as JaxCausalLM
from repro.models.split_api import get_split_model as jax_get_split_model
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.core.split_training import Channel
from repro_torch.core.ssop import SSOP
from repro_torch.federation import FedConfig, Federation
from repro_torch.models import common as torch_common
from repro_torch.models.split_api import (CausalLMSplitModel,
                                          get_split_model, split_model_for)

LAYERS, B, S = 4, 3, 20
# tests/test_split_api.py's causal-LM federation, in float64
CAUSAL_KW = dict(n_clients=4, n_edges=2, alpha=0.2, poisoned=(1,),
                 total_examples=400, probe_q=8, local_warmup_steps=2,
                 lr=5e-3, layers=4, t_rounds=1, batch_size=8, seed=0,
                 model="llama3-8b", dtype="float64")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch ops on one CPU thread.  The suite runs several
    test processes at once; torch's per-process thread pool, oversubscribed
    across them, makes these runs of many small ops tens of times slower
    than on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rope_f64_jax(x, positions, theta):
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (jnp.arange(half, dtype=x.dtype) / half))
    ang = positions[..., None].astype(x.dtype) * freqs
    cos, sin = jnp.cos(ang)[..., None, :], jnp.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return jnp.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _rope_f64_torch(x, positions, theta):
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=x.dtype) / half))
    ang = positions[..., None].to(x.dtype) * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


@pytest.fixture
def f64_rope(monkeypatch):
    monkeypatch.setattr(jax_common, "rope", _rope_f64_jax)
    monkeypatch.setattr(torch_common, "rope", _rope_f64_torch)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """Both packages' reduced llama3-8b split models (f64, 4 layers) on the
    JAX init, every LoRA ``*_b`` drawn from numpy at std 0.1 (the init
    leaves B at zero, which would hide the adapters)."""
    with jax.enable_x64(True):
        jm = jax_get_split_model("llama3-8b", num_layers=LAYERS,
                                 dtype="float64")
        tree = _np(jax_init_tree(jm.specs(), jax.random.PRNGKey(0),
                                 jnp.float64))
    rng = np.random.default_rng(1)
    attn = tree["lora"]["blocks"]["attn"]
    for k in attn:
        if k.endswith("_b"):
            attn[k] = rng.normal(size=attn[k].shape) * 0.1
    pm = get_split_model("llama3-8b", num_layers=LAYERS, dtype="float64")
    params = bridge.params_from_jax_numpy(pm.cfg, tree["frozen"],
                                          tree["lora"], device="cpu")
    toks = np.random.default_rng(2).integers(0, pm.cfg.vocab_size, (B, S))
    return jm, pm, tree, params, toks


def test_split_model_matches_jax_f64(models, f64_rope):
    """embed, run_blocks (a split's three parts, and with a validity
    mask), head, per_example_loss and accuracy, f64 to 1e-9."""
    jm, pm, tree, params, toks = models
    assert isinstance(pm, CausalLMSplitModel) and isinstance(jm, JaxCausalLM)
    assert pm.task == jm.task == "causal-lm"
    assert pm.num_blocks == jm.num_blocks == LAYERS
    assert pm.head_param_count() == jm.head_param_count()
    assert pm.block_param_count() == jm.block_param_count()
    assert pm.activation_shape(B, S) == jm.activation_shape(B, S)
    fz, lo = params["frozen"], params["lora"]
    t = torch.from_numpy(toks)
    mask = np.ones((B, S))
    mask[0, -5:] = 0.0

    def close(got, want, tol=1e-9):
        got, want = got.detach().numpy(), np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * max(np.abs(want).max(), 1.0))

    with jax.enable_x64(True):
        jx = jm.embed(tree["frozen"], jnp.asarray(toks))
        x = pm.embed(fz, t)
        close(x, jx)
        for lo_, hi_ in ((0, 1), (1, 3), (3, LAYERS)):
            jx = jm.run_blocks(tree["frozen"], tree["lora"], jx, lo_, hi_)
            x = pm.run_blocks(fz, lo, x, lo_, hi_)
            close(x, jx)
        close(pm.run_blocks(fz, lo, x, 0, 2, torch.from_numpy(mask)),
              jm.run_blocks(tree["frozen"], tree["lora"], jx, 0, 2,
                            jnp.asarray(mask)))
        jr, jl = jm.head(tree["frozen"], tree["lora"], jx)
        r, lg = pm.head(fz, lo, x)
        close(r, jr)
        close(lg, jl)
        batch = {"tokens": t}
        close(pm.per_example_loss(lg, batch),
              jm.per_example_loss(jl, {"tokens": jnp.asarray(toks)}))
        assert pm.accuracy(lg, toks, None) == jm.accuracy(jl, toks, None)
        # a padded vocab: the logits past vocab_size are masked out
        pv = dataclasses.replace(pm.cfg, vocab_size=1000)
        jv = dataclasses.replace(jm.cfg, vocab_size=1000)
        assert pv.padded_vocab > pv.vocab_size
        tv = toks % 1000
        close(CausalLMSplitModel(pv).per_example_loss(
                  lg, {"tokens": torch.from_numpy(tv)}),
              JaxCausalLM(jv).per_example_loss(
                  jl, {"tokens": jnp.asarray(tv)}))
        assert CausalLMSplitModel(pv).accuracy(lg, tv, None) == \
            JaxCausalLM(jv).accuracy(jl, tv, None)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen1.5-4b"])
def test_qwen_configs_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(jcfg.reduced())
    assert cfg.qkv_bias and cfg.family == "dense" and cfg.moe is None
    m = get_split_model(arch, num_layers=2)
    assert isinstance(m, CausalLMSplitModel)
    assert "bq" in m.specs()["frozen"]["blocks"][0]["attn"]


def test_adapter_rejects_moe_like_jax():
    moe = get_config("llama3-8b").reduced().with_(
        moe=MoEConfig(num_experts=4, experts_per_token=2))
    jmoe = jax_get_config("llama3-8b").reduced().with_(
        moe=jax_get_config("grok-1-314b").reduced().moe)
    with pytest.raises(ValueError, match="dense non-MoE"):
        split_model_for(moe)
    with pytest.raises(ValueError, match="dense non-MoE"):
        JaxCausalLM(jmoe)
    with pytest.raises(ValueError, match="dense non-MoE"):
        CausalLMSplitModel(get_config("bert-base"))


@pytest.fixture(scope="module")
def jax_causal_run():
    """The JAX package's batched causal-LM federation in x64, one round of
    2 local steps, with its per-client channels and weights."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_common, "rope", _rope_f64_jax)
    try:
        with jax.enable_x64(True):
            jf = JaxFederation(JaxFedConfig(**CAUSAL_KW), backend="batched")
            chans = {n: jf.channel_for(n, jf.lora0)
                     for n in range(jf.fed.n_clients)}
            chans = {n: (np.array(c.ssop.u), np.array(c.ssop.v))
                     for n, c in chans.items()}
            weights = (_np(jf.frozen), _np(jf.lora0))
            hist = jf.run("elsa", global_rounds=1, steps_per_round=2)
            theta = _np(jf.last_theta)
    finally:
        mp.undo()
    return chans, weights, hist, theta


@pytest.mark.parametrize("backend", ["batched", "reference"])
def test_causal_lm_federation_matches_jax_x64(jax_causal_run, backend,
                                              f64_rope):
    chans, (frozen, lora0), want, want_theta = jax_causal_run
    pf = Federation(FedConfig(**CAUSAL_KW), backend=backend, device="cpu")
    assert isinstance(pf.model, CausalLMSplitModel)
    params = bridge.params_from_jax_numpy(pf.cfg, frozen, lora0,
                                          device="cpu")
    pf.frozen, pf.lora0 = params["frozen"], params["lora"]
    for n, (u, v) in chans.items():
        pf._channels[n] = Channel(SSOP(u=torch.from_numpy(u),
                                       v=torch.from_numpy(v)), pf.plan)
    got = pf.run("elsa", global_rounds=1, steps_per_round=2)
    assert got["round"] == want["round"] == [0]
    assert got["accuracy"] == want["accuracy"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-8)
    np.testing.assert_allclose(got["delta"], want["delta"], rtol=1e-7)
    for n in range(pf.fed.n_clients):
        np.testing.assert_allclose(got["client_losses"][n],
                                   want["client_losses"][n], rtol=1e-8)
    _, theta = bridge.params_to_jax_numpy({"frozen": {},
                                           "lora": pf.last_theta})
    for a, b in zip(jax.tree_util.tree_leaves(theta),
                    jax.tree_util.tree_leaves(want_theta)):
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()
