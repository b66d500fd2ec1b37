"""The port's BERT encoder, its split model and split training against the
JAX package's, on bridged weights: bert-base at reduced width (d 256, 4
heads, LoRA rank 4 on q and v) with 4 layers, every LoRA B drawn nonzero.

The JAX init makes attention sharp (wq's fan-in is its head count, so
scores reach ~60), which amplifies float32 round-off: the JAX package's
own f32 outputs here differ from its f64 ones by up to ~1e-3 of their
scale.  So whole passes are held in float64 to 1e-10, and in float32 by
accuracy: the port's f32 error against the JAX package's f64 result must
be within 4x the JAX package's own f32 error (plus 1e-6 of the scale).
The split loss runs through the ELSA channel with the reference's SS-OP
(U, V) carried across and the sketch plan drawn by both packages from one
seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import split_training as jst
from repro.core.sketch import make_plan as jax_make_plan
from repro.core.ssop import make_ssop_from_basis
from repro.models import bert as jbert
from repro.models.params import init_tree as jax_init_tree
from repro.models.split_api import get_split_model as jax_get_split_model
from repro_torch import bridge
from repro_torch.core import split_training as st
from repro_torch.core.sketch import make_plan
from repro_torch.core.ssop import SSOP
from repro_torch.models import bert
from repro_torch.models.split_api import (BertSplitModel, get_split_model,
                                          register_split_model,
                                          split_model_for)

B, S, LAYERS, C = 3, 24, 4, 4
SPLIT = (1, 1, 2)


def _models(dtype, pooling=None):
    name = str(dtype).removeprefix("torch.")
    return (get_split_model("bert-base", num_layers=LAYERS, dtype=name,
                            pooling=pooling),
            jax_get_split_model("bert-base", num_layers=LAYERS, dtype=name,
                                pooling=pooling))


@pytest.fixture(scope="module")
def weights():
    _, jm = _models(torch.float32)
    with jax.enable_x64(True):
        jp = jax_init_tree(jm.specs(C), jax.random.PRNGKey(0), jnp.float64)
    frozen = jax.tree_util.tree_map(np.asarray, jp["frozen"])
    lora = jax.tree_util.tree_map(np.asarray, jp["lora"])
    rng = np.random.default_rng(1)
    for k, v in lora["blocks"]["attn"].items():
        if k.endswith("_b"):
            lora["blocks"]["attn"][k] = rng.normal(size=v.shape) * 0.1
    lora["head"]["b"] = rng.normal(size=lora["head"]["b"].shape) * 0.1
    toks = rng.integers(0, jm.cfg.vocab_size, (B, S))
    labels = rng.integers(0, C, (B,))
    d = jm.cfg.d_model
    u = np.linalg.qr(rng.normal(size=(d, 8)))[0].astype(np.float32)
    return frozen, lora, toks, labels, u


def _port(weights, dtype, pooling=None):
    frozen, lora, toks, labels, u = weights
    m, _ = _models(dtype, pooling)
    p = bridge.params_from_jax_numpy(m.cfg, frozen, lora, device="cpu",
                                     dtype=dtype)
    return m, p["frozen"], p["lora"], torch.from_numpy(toks), \
        torch.from_numpy(labels)


def _jax(weights, dtype, pooling=None):
    frozen, lora, toks, labels, u = weights
    _, jm = _models(dtype, pooling)
    jd = jnp.dtype(str(dtype).removeprefix("torch."))
    cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.asarray(a, jd), t)
    return jm, cast(frozen), cast(lora), jnp.asarray(toks), \
        jnp.asarray(labels)


def _channels(weights, d):
    """The reference's channel and the port's, on one (U, V) and one plan."""
    u = weights[4]
    jss = make_ssop_from_basis(jnp.asarray(u), "elsa-salt", 3)
    jch = jst.Channel(jss, jax_make_plan(d, 3, 40, seed=11))
    pch = st.Channel(SSOP(torch.from_numpy(u),
                          torch.from_numpy(np.array(jss.v))),
                     make_plan(d, 3, 40, seed=11, device="cpu"))
    return jch, pch


def _close(got, want, rtol, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max() if scale is None else scale
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * scale, \
        (np.abs(got - want).max(), scale)


def _as_accurate(got, want, truth):
    """f32: the port's error against the f64 ``truth`` is within 4x the
    JAX package's own f32 error (``want``), plus 1e-6 of the scale."""
    got, want, truth = (np.asarray(a, np.float64) for a in (got, want, truth))
    assert got.shape == want.shape == truth.shape
    err, floor = np.abs(got - truth).max(), np.abs(want - truth).max()
    assert err <= 4 * floor + 1e-6 * np.abs(truth).max(), (err, floor)


def _check(dtype, got, want, truth):
    if dtype == torch.float64:
        _close(got, want, 1e-10)
    else:
        _as_accurate(got, want, truth)


def _jax_forward(weights, dtype):
    with jax.enable_x64(True):
        jm, jf, jlp, jtoks, _ = _jax(weights, dtype)
        jx = jbert.embed(jm.cfg, jf, jtoks)
        jblk = jbert.block_apply(
            jm.cfg, jax.tree_util.tree_map(lambda a: a[1], jf["blocks"]),
            jax.tree_util.tree_map(lambda a: a[1], jlp["blocks"]), jx,
            mask_valid=jtoks % 3 > 0)
        jrun = jbert.run_blocks(jm.cfg, jf, jlp, jx, 1, 3)
        return [np.asarray(a) for a in (jx, jblk, jrun,
                                         *jbert.bert_forward(jm.cfg, jf, jlp,
                                                             jtoks))]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_embed_blocks_and_forward_match_jax(weights, dtype):
    m, f, lp, toks, _ = _port(weights, dtype)
    want = _jax_forward(weights, dtype)
    truth = _jax_forward(weights, torch.float64)
    x = bert.embed(m.cfg, f, toks)
    assert x.dtype == dtype
    got = [x, bert.block_apply(m.cfg, f["blocks"][1], lp["blocks"][1], x,
                               mask_valid=toks % 3 > 0),
           bert.run_blocks(m.cfg, f, lp, x, 1, 3),
           *bert.bert_forward(m.cfg, f, lp, toks)]
    for a, b, t in zip(got, want, truth):
        _check(dtype, a, b, t)


def _jax_head(weights, dtype, pooling):
    with jax.enable_x64(True):
        jm, jf, jlp, jtoks, jlabels = _jax(weights, dtype, pooling)
        jx = jm.run_blocks(jf, jlp, jm.embed(jf, jtoks), 0, LAYERS)
        jrepr, jlogits = jm.head(jf, jlp, jx)
        out = [np.asarray(a) for a in (
            jrepr, jlogits, jm.probe_repr(jf, jlp, jtoks),
            jm.per_example_loss(jlogits, {"labels": jlabels}))]
        return out, jm.accuracy(jlogits, jtoks, jlabels), jm


@pytest.mark.parametrize("pooling", ["cls", "mean"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_split_model_head_probe_and_loss_match_jax(weights, dtype, pooling):
    m, f, lp, toks, labels = _port(weights, dtype, pooling)
    want, jacc, jm = _jax_head(weights, dtype, pooling)
    truth, _, _ = _jax_head(weights, torch.float64, pooling)
    x = m.run_blocks(f, lp, m.embed(f, toks), 0, LAYERS)
    rep, logits = m.head(f, lp, x)
    got = [rep, logits, m.probe_repr(f, lp, toks),
           m.per_example_loss(logits, {"labels": labels})]
    for a, b, t in zip(got, want, truth):
        _check(dtype, a, b, t)
    assert m.accuracy(logits, toks, labels) == jacc
    specs = m.specs(C)["lora"]["head"]["w"]
    assert specs.init == ("zeros" if pooling == "mean" else "normal")
    assert (m.head_param_count(C), m.block_param_count(C),
            m.flops_per_token(st.Split(*SPLIT), C)) == \
        (jm.head_param_count(C), jm.block_param_count(C),
         jm.flops_per_token(jst.Split(*SPLIT), C))


W = np.array([1.0, 0.0, 2.0])


def _jax_split(weights, dtype, loss_name, d):
    with jax.enable_x64(True):
        jm, jf, jlp, jtoks, jlabels = _jax(weights, dtype)
        jch, _ = _channels(weights, d)
        jbatch = {"tokens": jtoks, "labels": jlabels,
                  "weights": jnp.asarray(W)}
        jloss, jg = jax.value_and_grad(
            lambda p: getattr(jst, loss_name)(jm, jf, p, jbatch,
                                              jst.Split(*SPLIT), jch))(jlp)
        _, jlogits, jup, jdown = jst.split_forward(jm, jf, jlp, jtoks,
                                                   jst.Split(*SPLIT), jch)
        return ([np.asarray(a) for a in (jlogits, jup, jdown, jloss)],
                jax.tree_util.tree_leaves(
                    jax.tree_util.tree_map(np.asarray, jg)))


@pytest.mark.parametrize("loss_name", ["split_loss", "weighted_split_loss"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_split_loss_and_gradient_match_jax(weights, dtype, loss_name):
    """Forward, loss and LoRA gradient through both cuts of the channel:
    f64 to 1e-10 of each value's scale, f32 by accuracy against the JAX
    package's f64 result (module docstring).  In f32 the gradient's own
    error reaches a few percent: a rounding that flips one of the median's
    compares sends a feature's gradient through another bucket (ROADMAP.md,
    queue 3 notes)."""
    m, f, lp, toks, labels = _port(weights, dtype)
    _, pch = _channels(weights, m.cfg.d_model)
    split = st.Split(*SPLIT)
    want, jg = _jax_split(weights, dtype, loss_name, m.cfg.d_model)
    truth, tg = _jax_split(weights, torch.float64, loss_name, m.cfg.d_model)
    batch = {"tokens": toks, "labels": labels,
             "weights": torch.from_numpy(W)}
    loss, g = st.loss_and_grad(
        lambda p: getattr(st, loss_name)(m, f, p, batch, split, pch), lp)
    _, logits, up, down = st.split_forward(m, f, lp, toks, split, pch)
    _, gn = bridge.params_to_jax_numpy({"frozen": {}, "lora": g})
    for a, b, t in zip([logits, up, down, loss] + jax.tree_util.tree_leaves(
            gn), want + jg, truth + tg):
        _check(dtype, a, b, t)


def test_split_train_step_and_zero_weights():
    """One eager ``split_train_step`` step moves the LoRA; an all-zero
    weight vector gives a zero loss and zero gradients."""
    from repro_torch.optim import SGD
    m = get_split_model("bert-base", num_layers=LAYERS, dtype="float64")
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models.params import init_tree
    p = init_tree(m.specs(C), gen, torch.float64, "cpu")
    toks = torch.randint(0, m.cfg.vocab_size, (2, 8), generator=gen)
    batch = {"tokens": toks, "labels": torch.tensor([0, 3])}
    step = st.split_train_step(m, st.Split(*SPLIT), st.IDENTITY_CHANNEL,
                               SGD(lr=0.1))
    new, state, loss = step(p["frozen"], p["lora"], SGD(lr=0.1).init(
        p["lora"]), batch)
    assert np.isfinite(float(loss)) and int(state["step"]) == 1
    assert not torch.equal(new["head"]["w"], p["lora"]["head"]["w"])
    loss0, g0 = st.loss_and_grad(
        lambda lp: st.weighted_split_loss(
            m, p["frozen"], lp, {**batch, "weights": torch.zeros(2)},
            st.Split(*SPLIT)), p["lora"])
    assert float(loss0) == 0.0
    assert all(float(t.abs().max()) == 0.0 for t in
               jax.tree_util.tree_leaves(g0))


def test_bridge_round_trips_bert_trees(weights):
    """The encoder's leaves outside the stack (pos, seg, ln_embed, pooler,
    head) cross as they are; the stacked blocks become a list of layers."""
    frozen, lora = weights[0], weights[1]
    m, _ = _models(torch.float64)
    p = bridge.params_from_jax_numpy(m.cfg, frozen, lora, device="cpu")
    assert len(p["frozen"]["blocks"]) == len(p["lora"]["blocks"]) == LAYERS
    assert p["frozen"]["pos"].shape == frozen["pos"].shape
    back = bridge.params_to_jax_numpy(p)
    for got, want in ((back[0], frozen), (back[1], lora)):
        jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)


def test_registry_takes_a_factory_and_rejects_what_is_not_ported():
    register_split_model(
        "bert-base-test", lambda num_layers=None, dtype=None: BertSplitModel(
            get_split_model("bert-base").cfg.with_(num_layers=num_layers)))
    assert get_split_model("bert-base-test", num_layers=5).num_blocks == 5
    assert get_split_model("bert-base", pooling="mean").pooling == "mean"
    with pytest.raises(KeyError, match="unknown split model"):
        get_split_model("bert-huge")
    assert get_split_model("olmo-1b").task == "causal-lm"
    with pytest.raises(NotImplementedError, match="no SplitModel adapter"):
        split_model_for(get_split_model("bert-base").cfg.with_(family="ssm"))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_full_width_gradient_growth_matches_jax(dtype):
    """bert-base at full width (d 768, 12 heads, vocab 30522), 3 layers,
    on the port's own init bridged to the JAX package, through a channel
    like the federation's (f32 rotation, Y 3, Z 325): each block's LoRA
    gradient norms (split_loss, split (1, 1, 1)) match the JAX package's,
    f64 to 1e-9, f32 to 1e-2 (the median's flips,
    ``test_split_loss_and_gradient_match_jax``).  Both packages show the
    same growth towards the input, which is what makes unclipped full-width
    steps diverge."""
    from repro_torch.models.params import init_tree
    name = str(dtype).removeprefix("torch.")
    layers = 3
    m = get_split_model("bert-base", reduced=False, num_layers=layers,
                        dtype=name)
    jm = jax_get_split_model("bert-base", reduced=False, num_layers=layers,
                             dtype=name)
    assert (m.cfg.d_model, m.cfg.num_heads, m.cfg.vocab_size) == \
        (768, 12, 30522)
    tree = init_tree(m.specs(C), torch.Generator().manual_seed(0), dtype,
                     "cpu")
    frozen, lora = bridge.params_to_jax_numpy(tree)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, m.cfg.vocab_size, (2, 16))
    labels = rng.integers(0, C, (2,))
    d = m.cfg.d_model
    u = np.linalg.qr(rng.normal(size=(d, 8)))[0].astype(name)
    split = (1, 1, 1)
    with jax.enable_x64(True):
        jss = make_ssop_from_basis(jnp.asarray(u), "elsa-salt", 3)
        jch = jst.Channel(jss, jax_make_plan(d, 3, 325, seed=11))
        jf, jl = (jax.tree_util.tree_map(jnp.asarray, t)
                  for t in (frozen, lora))
        jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
        jg = jax.grad(lambda p: jst.split_loss(
            jm, jf, p, jbatch, jst.Split(*split), jch))(jl)
        jg = jax.tree_util.tree_map(np.asarray, jg)
    pch = st.Channel(SSOP(torch.from_numpy(u),
                          torch.from_numpy(np.array(jss.v))),
                     make_plan(d, 3, 325, seed=11, device="cpu"))
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    _, g = st.loss_and_grad(lambda p: st.split_loss(
        m, tree["frozen"], p, batch, st.Split(*split), pch), tree["lora"])
    _, g = bridge.params_to_jax_numpy({"frozen": {}, "lora": g})
    rtol = 1e-9 if dtype == torch.float64 else 1e-2
    for k in ("q_b", "v_b"):
        norm = [np.linalg.norm(np.asarray(t[k], np.float64).reshape(
            layers, -1), axis=1) for t in (g["blocks"]["attn"],
                                           jg["blocks"]["attn"])]
        np.testing.assert_allclose(norm[0], norm[1], rtol=rtol)
        assert norm[1][0] > 5 * norm[1][-1], (k, norm[1])
