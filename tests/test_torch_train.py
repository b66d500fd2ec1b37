"""The port's training slice against the JAX package's, on bridged weights:
olmo-1b at reduced width with 4 layers (the least depth at which
``elsa_boundaries`` gives two real cuts, (1, 1)), LoRA fine-tuning through
ELSA's channel (SS-OP -> count-sketch -> median decode -> SS-OPᵀ) at both
cuts.  Held: the config, the launcher's draws, the channel, ``lm_forward``,
``run_block_range``, the losses, AdamW and one ``make_train_step`` step.

Parity of whole forward/backward passes is held in float64 with rope's and
the loss's float32 internals patched to float64 in both packages, as
``tests/test_torch_serving.py`` does for rope: the JAX init makes attention
scores large (~60 here), so float32 round-off in either package is
amplified far above the algorithm's own agreement.  Float32 runs are held
to the looser tolerances stated at each test.
"""
import dataclasses

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
from repro.models import common as jax_common
from repro.models import transformer as jax_transformer
from repro.models import zoo as jax_zoo
from repro.models.params import init_tree as jax_init_tree
from repro.optim import AdamW as JaxAdamW
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import global_norm as jax_global_norm
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.sketch import SketchPlan
from repro_torch.core.split_training import IDENTITY_CHANNEL, Channel, Split
from repro_torch.core.ssop import SSOP
from repro_torch.launch import train
from repro_torch.models import common as torch_common
from repro_torch.models import transformer, zoo
from repro_torch.optim import AdamW, clip_by_global_norm, global_norm
from repro_torch.optim.optimizers import tree_leaves

CFG = get_config("olmo-1b").reduced().with_(num_layers=4)
JCFG = jax_get_config("olmo-1b").reduced().with_(num_layers=4)
B, S = 2, 16
_, Z = train.elsa_channel_specs(CFG)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _jax_launcher_u(d):
    """``u`` as the JAX launcher draws it (``launch/train.py:235-240``)."""
    rngs = jax.random.split(jax.random.PRNGKey(42), 4)
    return np.asarray(jnp.linalg.qr(jax.random.normal(rngs[0], (d, 16)))[0])


@pytest.fixture(scope="module")
def weights():
    """JAX-initialized frozen and LoRA trees (every ``*_b`` leaf drawn from
    numpy at std 0.1: the init leaves B at zero, which would hide the
    adapter), the launcher's channel with the JAX launcher's ``u``, and a
    batch of tokens."""
    jp = jax_init_tree(jax_zoo.get_model(JCFG).specs(JCFG),
                       jax.random.PRNGKey(0), JCFG.dtype())
    frozen = jax.tree_util.tree_map(np.asarray, jp["frozen"])
    rng = np.random.default_rng(1)
    attn = {k: (rng.normal(size=v.shape) * 0.1).astype(np.float32)
            if k.endswith("_b") else np.asarray(v)
            for k, v in jp["lora"]["blocks"]["attn"].items()}
    ch = {k: v.numpy() for k, v in
          train.channel_params(CFG, Z, device="cpu").items()}
    ch["u"] = _jax_launcher_u(CFG.d_model)
    toks = rng.integers(0, CFG.vocab_size, (B, S))
    return frozen, {"blocks": {"attn": attn}}, ch, toks


def _cfgs(dtype):
    name = str(dtype).removeprefix("torch.")
    return (CFG.with_(param_dtype=name, activation_dtype=name),
            JCFG.with_(param_dtype=name, activation_dtype=name))


def _port(weights, dtype):
    frozen, lora, ch, toks = weights
    cfg, _ = _cfgs(dtype)
    params = bridge.params_from_jax_numpy(cfg, frozen, lora, device="cpu",
                                          dtype=dtype)
    chan = bridge.channel_from_jax_numpy(ch, device="cpu")
    chan = {k: (v.to(dtype) if v.is_floating_point() else v)
            for k, v in chan.items()}
    return cfg, params, chan, torch.from_numpy(toks)


def _jax(weights, dtype):
    frozen, lora, ch, toks = weights
    _, jcfg = _cfgs(dtype)
    jd = jcfg.dtype()
    f, lp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jd),
                                   (frozen, lora))
    chan = {k: jnp.asarray(v, jd if v.dtype.kind == "f" else v.dtype)
            for k, v in ch.items()}
    return jcfg, f, lp, chan, jnp.asarray(toks)


def _port_channel(chan):
    return Channel(SSOP(chan["u"], chan["v"]),
                   SketchPlan(chan["bucket"], chan["sign"], Z))


def _jax_channel(chan):
    return JaxChannel(JaxSSOP(chan["u"], chan["v"]),
                      JaxSketchPlan(chan["bucket"], chan["sign"], Z))


# f64 variants of the two places where both packages compute in float32
# whatever the input's dtype: rope's angles and the loss

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


def _loss_f64_jax(cfg, logits, tokens, aux=None):
    V, vp = cfg.vocab_size, logits.shape[-1]
    logits = logits[:, :-1, :]
    logits = logits + jnp.where(jnp.arange(vp) < V, 0.0, -1e30)
    gold = jnp.take_along_axis(logits, tokens[:, 1:, None], -1)[..., 0]
    return jnp.mean(jax.nn.logsumexp(logits, -1) - gold) + aux


def _loss_f64_torch(cfg, logits, tokens, aux=None):
    V, vp = cfg.vocab_size, logits.shape[-1]
    logits = logits[:, :-1, :]
    logits = logits + torch.where(torch.arange(vp) < V, 0.0, -1e30)
    gold = torch.gather(logits, -1, tokens[:, 1:, None].long())[..., 0]
    return torch.mean(torch.logsumexp(logits, -1) - gold) + aux


@pytest.fixture
def f64(monkeypatch):
    monkeypatch.setattr(jax_common, "rope", _rope_f64_jax)
    monkeypatch.setattr(torch_common, "rope", _rope_f64_torch)
    monkeypatch.setattr(jax_zoo, "loss_fn", _loss_f64_jax)
    monkeypatch.setattr(zoo, "loss_fn", _loss_f64_torch)
    with jax.enable_x64(True):
        yield


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


# ---------------------------------------------------------------------------
# config, launcher, channel
# ---------------------------------------------------------------------------

def test_olmo_config_matches_jax():
    for cfg, jcfg in ((get_config("olmo-1b"), jax_get_config("olmo-1b")),
                      (CFG, JCFG)):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.padded_vocab == jcfg.padded_vocab
    assert get_config("olmo-1b").padded_vocab == 50432


@pytest.mark.parametrize("arch,layers", [("olmo-1b", None), ("olmo-1b", 4),
                                         ("olmo-1b", 2), ("llama3-8b", None)])
def test_elsa_boundaries_and_channel_specs_match_jax(arch, layers):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    if layers:
        cfg, jcfg = (c.reduced().with_(num_layers=layers) for c in (cfg, jcfg))
    assert train.elsa_boundaries(cfg) == jax_train.elsa_boundaries(jcfg)
    specs, z = train.elsa_channel_specs(cfg)
    jspecs, jz = jax_train.elsa_channel_specs(jcfg)
    assert z == jz
    assert specs == {k: (tuple(v.shape), v.dtype.name)
                     for k, v in jspecs.items()}
    if arch == "olmo-1b" and layers is None:
        assert train.elsa_boundaries(cfg) == (4, 10) and z == 325


def test_launcher_numpy_draws_match_jax_launcher():
    """``v``, ``bucket``, ``sign`` and the batch stream, against the JAX
    launcher's own numpy calls (``launch/train.py:241-260``, copied)."""
    cfg = get_config("olmo-1b")
    _, z = train.elsa_channel_specs(cfg)
    rng = np.random.default_rng(42)
    q_, _ = np.linalg.qr(rng.standard_normal((16, 16)))
    want = {"v": np.asarray(jnp.asarray(q_, jnp.float32)),
            "bucket": np.asarray(jnp.asarray(rng.integers(
                0, z, (3, cfg.d_model)), jnp.int32)),
            "sign": np.asarray(jnp.asarray(rng.choice(
                [-1.0, 1.0], (3, cfg.d_model)), jnp.float32))}
    got = train.channel_params(cfg, z, device="cpu")
    for k, v in want.items():
        assert got[k].numpy().dtype == v.dtype
        np.testing.assert_array_equal(got[k].numpy(), v)
    u = got["u"]
    assert u.shape == (cfg.d_model, 16)
    torch.testing.assert_close(u.T @ u, torch.eye(16), atol=1e-5, rtol=0)

    rng = np.random.default_rng(0)
    base = rng.integers(0, cfg.vocab_size, size=(64,))
    stream = train.batch_stream(cfg, 8, 64, device="cpu")
    for _ in range(3):
        starts = rng.integers(0, 64, size=(8,))
        toks = np.stack([np.roll(base, -s)[:64] for s in starts])
        noise = rng.integers(0, cfg.vocab_size, toks.shape)
        mask = rng.random(toks.shape) < 0.1
        np.testing.assert_array_equal(next(stream)["tokens"].numpy(),
                                      np.where(mask, noise, toks))


def test_channel_matches_jax_channel_f32(weights):
    """The whole channel, forward and gradient, in f32 against the JAX
    ``Channel`` (jnp SS-OP and sketch): rtol 1e-5 with an absolute floor of
    1e-5 * max|y| (both accumulate in f32 in different orders; the median
    only selects)."""
    _, _, chan, _ = _port(weights, torch.float32)
    _, _, _, jchan, _ = _jax(weights, torch.float32)
    rng = np.random.default_rng(4)
    h = rng.normal(size=(B, S, CFG.d_model)).astype(np.float32)
    g = rng.normal(size=h.shape).astype(np.float32)
    want, vjp = jax.vjp(_jax_channel(jchan), jnp.asarray(h))
    (want_g,) = vjp(jnp.asarray(g))
    ht = torch.from_numpy(h).requires_grad_(True)
    got = _port_channel(chan)(ht)
    got.backward(torch.from_numpy(g))
    for a, b in ((got.detach(), want), (ht.grad, want_g)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(b).max()))
    assert IDENTITY_CHANNEL(ht) is ht and IDENTITY_CHANNEL.transmit(ht) is ht
    assert dataclasses.astuple(Split(4, 10, 2)) == (4, 10, 2)
    sk = _port_channel(chan).transmit(torch.from_numpy(h))
    assert sk.shape == (B, S, 3, Z)
    np.testing.assert_allclose(
        sk.numpy(), np.asarray(_jax_channel(jchan).transmit(jnp.asarray(h))),
        rtol=1e-5, atol=1e-5 * float(np.abs(sk.numpy()).max()))


def test_channel_matches_jax_channel_bf16(weights):
    """bf16.  The JAX ``Channel`` runs SS-OP in jnp with bf16 intermediates
    (H U and (H U) W are rounded to bf16), the port's kernel path
    accumulates in f32 and rounds once; so the rotated activations differ
    by a few bf16 ulps, the sketch by as much, and the median may then pick
    another row for a feature.  Held: the mean absolute difference within
    2^-6 of the mean magnitude, and 99% of entries within 2^-4 of the
    largest value."""
    _, _, chan, _ = _port(weights, torch.bfloat16)
    _, _, _, jchan, _ = _jax(weights, torch.bfloat16)
    h = np.random.default_rng(5).normal(size=(B, S, CFG.d_model))
    got = _port_channel(chan)(torch.from_numpy(h).bfloat16())
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = np.asarray(_jax_channel(jchan)(jnp.asarray(h, jnp.bfloat16)),
                      np.float32)
    diff = np.abs(got - want)
    assert diff.mean() <= 2 ** -6 * np.abs(want).mean(), diff.mean()
    assert np.quantile(diff, 0.99) <= 2 ** -4 * np.abs(want).max()


# ---------------------------------------------------------------------------
# forward and losses
# ---------------------------------------------------------------------------

def _port_loss_and_grads(cfg, params, chan, toks, channel=True):
    lp = jax.tree_util.tree_map(lambda a: a, params["lora"])
    leaves = [t.requires_grad_(True) for l in lp["blocks"]
              for t in l["attn"].values()]
    fwd = dict(remat=True)
    if channel:
        fwd.update(boundaries=train.elsa_boundaries(cfg),
                   channel=_port_channel(chan))
    logits, aux = transformer.lm_forward(cfg, params["frozen"], lp, toks,
                                         **fwd)
    loss = zoo.loss_fn(cfg, logits, toks, aux)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return logits.detach(), loss.detach(), grads


def _jax_loss_and_grads(jcfg, f, lp, jchan, toks, channel=True):
    fwd = dict(remat=True)
    if channel:
        fwd.update(boundaries=jax_train.elsa_boundaries(jcfg),
                   channel=_jax_channel(jchan))

    def loss_fn(lp):
        logits, aux = jax_transformer.lm_forward(jcfg, f, lp, toks, **fwd)
        return jax_zoo.loss_fn(jcfg, logits, toks, aux), logits

    (loss, logits), g = jax.value_and_grad(loss_fn, has_aux=True)(lp)
    attn = g["blocks"]["attn"]
    grads = [np.asarray(attn[k][i]) for i in range(jcfg.num_layers)
             for k in sorted(attn)]
    return np.asarray(logits), np.asarray(loss), grads


def _sorted_port_grads(params, grads):
    names = [k for l in params["lora"]["blocks"] for k in l["attn"]]
    n = len(params["lora"]["blocks"][0]["attn"])
    out = []
    for i in range(len(params["lora"]["blocks"])):
        layer = dict(zip(names[i * n:(i + 1) * n], grads[i * n:(i + 1) * n]))
        out += [layer[k].numpy() for k in sorted(layer)]
    return out


@pytest.mark.parametrize("channel", [True, False], ids=["elsa", "plain"])
def test_lm_forward_loss_and_lora_grads_match_jax_f64(weights, f64, channel):
    """f64: logits, loss and every LoRA gradient to 1e-9 of their scale."""
    cfg, params, chan, toks = _port(weights, torch.float64)
    jcfg, f, lp, jchan, jtoks = _jax(weights, torch.float64)
    logits, loss, grads = _port_loss_and_grads(cfg, params, chan, toks,
                                               channel)
    jlogits, jloss, jgrads = _jax_loss_and_grads(jcfg, f, lp, jchan, jtoks,
                                                 channel)
    assert logits.dtype == torch.float64
    assert _rel_err(logits.numpy(), jlogits) <= 1e-9
    assert abs(float(loss) - float(jloss)) <= 1e-9 * abs(float(jloss))
    got = _sorted_port_grads(params, grads)
    assert len(got) == len(jgrads) == 4 * cfg.num_layers * 2
    for a, b in zip(got, jgrads):
        assert a.shape == b.shape
        assert _rel_err(a, b) <= 1e-9


def test_lm_forward_with_channel_matches_jax_f32(weights):
    """f32, unpatched: logits within 1e-3 of max|logits| (the sharp
    attention of the JAX init amplifies f32 round-off; see the module
    docstring), the loss within 1e-4 relative."""
    cfg, params, chan, toks = _port(weights, torch.float32)
    jcfg, f, lp, jchan, jtoks = _jax(weights, torch.float32)
    logits, loss, _ = _port_loss_and_grads(cfg, params, chan, toks)
    jlogits, jloss, _ = _jax_loss_and_grads(jcfg, f, lp, jchan, jtoks)
    assert _rel_err(logits.numpy(), jlogits) <= 1e-3
    assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))


def test_run_block_range_matches_jax(weights, f64):
    cfg, params, _, _ = _port(weights, torch.float64)
    jcfg, f, lp, _, _ = _jax(weights, torch.float64)
    x = np.random.default_rng(6).normal(size=(B, S, cfg.d_model))
    for lo, hi in ((0, 1), (1, 3), (2, 2)):
        got = transformer.run_block_range(cfg, params["frozen"],
                                          params["lora"], torch.from_numpy(x),
                                          lo, hi, remat=True)
        want = jax_transformer.run_block_range(jcfg, f, lp, jnp.asarray(x),
                                               lo, hi)
        assert _rel_err(got.detach().numpy(), want) <= 1e-10


def test_loss_fn_masks_the_padded_vocab_like_jax():
    """vocab 1000 pads to 1024: the 24 padded columns carry large logits
    that the -1e30 mask must remove.  f32 on both sides: 1e-6 relative."""
    cfg = CFG.with_(vocab_size=1000)
    jcfg = JCFG.with_(vocab_size=1000)
    assert cfg.padded_vocab == 1024
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(2, 5, 1024)).astype(np.float32)
    logits[..., 1000:] += 50.0
    toks = rng.integers(0, 1000, (2, 5))
    lt = torch.from_numpy(logits).requires_grad_(True)
    aux = torch.tensor(0.25)
    got = zoo.loss_fn(cfg, lt, torch.from_numpy(toks), aux)
    got.backward()
    got = float(got.detach())
    want, g = jax.value_and_grad(lambda x: jax_zoo.loss_fn(
        jcfg, x, jnp.asarray(toks), jnp.asarray(0.25)))(jnp.asarray(logits))
    assert abs(got - float(want)) <= 1e-6 * abs(float(want))
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(g), rtol=1e-5,
                               atol=1e-8)
    assert float(lt.grad[..., 1000:].abs().max()) == 0.0


def test_per_example_ce_and_classification_loss_match_jax():
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(6, 10)) * 3
    labels = rng.integers(0, 10, 6)
    got = zoo.per_example_ce(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.dtype == torch.float64       # f64 stays f64
    with jax.enable_x64(True):
        want = jax_zoo.per_example_ce(jnp.asarray(logits), jnp.asarray(labels))
        wantc = jax_zoo.classification_loss(jnp.asarray(logits),
                                            jnp.asarray(labels))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    got = zoo.classification_loss(torch.from_numpy(logits.astype(np.float32)),
                                  torch.from_numpy(labels))
    assert abs(float(got) - float(wantc)) <= 1e-6 * abs(float(wantc))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _tree(rng, lora_np):
    return jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), lora_np)


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adamw_matches_jax_on_identical_gradients(weights, wd):
    """Three steps on the same gradients: both update in f32 (m and v are
    f32 state), held to rtol 1e-6 with an absolute floor of 1e-7."""
    _, lora_np, _, _ = weights
    rng = np.random.default_rng(9)
    opt, jopt = AdamW(lr=3e-3, weight_decay=wd), JaxAdamW(lr=3e-3,
                                                         weight_decay=wd)
    p = bridge.params_from_jax_numpy(CFG, {"blocks": lora_np["blocks"]},
                                     lora_np, device="cpu")["lora"]
    jp = jax.tree_util.tree_map(jnp.asarray, lora_np)
    state, jstate = opt.init(p), jopt.init(jp)
    for _ in range(3):
        g_np = _tree(rng, lora_np)
        g = bridge.params_from_jax_numpy(CFG, g_np, g_np,
                                         device="cpu")["lora"]
        p, state = opt.update(p, g, state)
        jp, jstate = jopt.update(jp, jax.tree_util.tree_map(jnp.asarray, g_np),
                                 jstate)
    got = bridge.opt_state_to_jax_numpy(state)
    want = jax.tree_util.tree_map(np.asarray, jstate)
    assert int(got["step"]) == int(want["step"]) == 3
    close = dict(rtol=1e-6, atol=1e-7)
    for k in ("m", "v"):
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, b, **close),
            got[k], want[k])
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, **close),
        bridge.params_to_jax_numpy({"frozen": {}, "lora": p})[1],
        jax.tree_util.tree_map(np.asarray, jp))


def test_global_norm_and_clipping_match_jax(weights):
    _, lora_np, _, _ = weights
    g_np = _tree(np.random.default_rng(10), lora_np)
    g = bridge.params_from_jax_numpy(CFG, g_np, g_np, device="cpu")["lora"]
    jg = jax.tree_util.tree_map(jnp.asarray, g_np)
    n = float(global_norm(g))
    assert abs(n - float(jax_global_norm(jg))) <= 1e-6 * n
    for cap in (n / 3, 10 * n):
        got = bridge.params_to_jax_numpy(
            {"frozen": {}, "lora": clip_by_global_norm(g, cap)})[1]
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6),
            got, jax.tree_util.tree_map(np.asarray, jax_clip(jg, cap)))
    zero = jax.tree_util.tree_map(torch.zeros_like, g)
    assert float(global_norm(clip_by_global_norm(zero, 1.0))) == 0.0


# ---------------------------------------------------------------------------
# the train step and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nm", [1, 2], ids=["one-batch", "two-microbatches"])
def test_train_step_matches_jax_f64(weights, f64, nm):
    """One ``make_train_step`` step through the channel in f64: the loss
    to 1e-9; the new LoRA, m and v, which AdamW computes in f32 in both
    packages, to rtol 1e-6 with an absolute floor of 1e-7 (m = 0.1 g, so
    this also holds the gradients)."""
    cfg, params, chan, toks = _port(weights, torch.float64)
    jcfg, f, lp, jchan, jtoks = _jax(weights, torch.float64)
    opt, jopt = AdamW(lr=3e-3), JaxAdamW(lr=3e-3)
    step = train.make_train_step(cfg, optimizer=opt, elsa_z=Z,
                                 num_microbatches=nm)
    jstep = jax_train.make_train_step(jcfg, optimizer=jopt, elsa_z=Z,
                                      num_microbatches=nm)
    new, state, loss = step(params["frozen"], params["lora"],
                            opt.init(params["lora"]),
                            {"tokens": toks, "_channel": chan})
    jnew, jstate, jloss = jstep(f, lp, jopt.init(lp),
                                {"tokens": jtoks, "_channel": jchan})
    assert abs(float(loss) - float(jloss)) <= 1e-9 * abs(float(jloss))
    close = dict(rtol=1e-6, atol=1e-7)
    got = bridge.opt_state_to_jax_numpy(state)
    want = jax.tree_util.tree_map(np.asarray, jstate)
    for k in ("m", "v"):
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, b, **close),
            got[k], want[k])
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, **close),
        bridge.params_to_jax_numpy({"frozen": {}, "lora": new})[1],
        jax.tree_util.tree_map(np.asarray, jnew))
    assert not np.allclose(got["m"]["blocks"]["attn"]["q_a"], 0)


def test_train_step_takes_a_prebuilt_sketch_plan(weights):
    """The launcher builds the sketch's plan once and passes it in the
    step's ``_channel``: that step is, bit for bit, the one that plans the
    sketch itself."""
    cfg, params, chan, toks = _port(weights, torch.float32)
    planned = {**chan, "plan": SketchPlan(chan["bucket"], chan["sign"], Z)}
    out = []
    for c in (chan, planned):
        opt = AdamW(lr=3e-3)
        step = train.make_train_step(cfg, optimizer=opt, elsa_z=Z)
        new, _, loss = step(params["frozen"], params["lora"],
                            opt.init(params["lora"]),
                            {"tokens": toks, "_channel": c})
        out.append((float(loss), tree_leaves(new)))
    assert np.isfinite(out[0][0]) and out[0][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_train_step_rejects_what_is_not_ported(weights):
    with pytest.raises(NotImplementedError, match="queue 8"):
        train.make_train_step(CFG, per_pod_lora=True)
    # use_flash is accepted, as the JAX package accepts it, and changes
    # nothing: the cache-free attention is flash attention either way
    cfg, params, chan, toks = _port(weights, torch.float32)
    losses = []
    for use_flash in (False, True):
        opt = AdamW(lr=3e-3)
        step = train.make_train_step(cfg, optimizer=opt, elsa_z=Z,
                                     use_flash=use_flash)
        losses.append(float(step(params["frozen"], params["lora"],
                                 opt.init(params["lora"]),
                                 {"tokens": toks, "_channel": chan})[2]))
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
    q, k, v = torch.randn(3, 1, 5, 2, 4, dtype=torch.float64)
    torch.testing.assert_close(
        torch_common.gqa_attention(q, k, v, use_flash=True),
        torch_common.gqa_attention(q, k, v), rtol=0, atol=0)


def test_main_trains_two_steps_on_cpu(capsys, tmp_path):
    out = train._main(["--device", "cpu", "--elsa", "--steps", "2",
                       "--log-every", "1", "--batch", "2", "--seq", "16"])
    losses = [l for _, l in out["losses"]]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "olmo-1b (reduced)" in capsys.readouterr().out
    # --ckpt writes the trained LoRA tree with save_state
    from repro_torch.checkpoint import restore_state, tree_equal
    path = str(tmp_path / "lora.msgpack")
    out = train._main(["--device", "cpu", "--steps", "1", "--batch", "2",
                       "--seq", "16", "--ckpt", path])
    state = restore_state(path)
    assert state["step"] == 1
    assert tree_equal(state["params"], {"lora": out["lora"]})
    assert f"saved LoRA checkpoint -> {path}" in capsys.readouterr().out


def test_train_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is exercised by "
                    "chip_smoke.py")
    with pytest.raises(RuntimeError):
        train._main(["--steps", "1"])


def test_bridge_round_trips_olmo_trees_channel_and_opt_state(weights):
    frozen, lora, ch, _ = weights
    params = bridge.params_from_jax_numpy(CFG, frozen, lora, device="cpu")
    assert "head" not in params["frozen"]                # tied embeddings
    assert params["frozen"]["blocks"][0]["ln1"] == {}    # non-parametric
    f2, l2 = bridge.params_to_jax_numpy(params)
    jax.tree_util.tree_map(np.testing.assert_array_equal, f2, frozen)
    jax.tree_util.tree_map(np.testing.assert_array_equal, l2, lora)
    chan = bridge.channel_from_jax_numpy(ch, device="cpu")
    assert chan["bucket"].dtype == torch.int32
    for k, v in ch.items():
        np.testing.assert_array_equal(chan[k].numpy(), v)
    jstate = jax.tree_util.tree_map(np.asarray, JaxAdamW().init(
        jax.tree_util.tree_map(jnp.asarray, lora)))
    state = bridge.opt_state_from_jax_numpy(jstate, device="cpu")
    assert state["m"]["blocks"][3]["attn"]["q_a"].dtype == torch.float32
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           bridge.opt_state_to_jax_numpy(state), jstate)
