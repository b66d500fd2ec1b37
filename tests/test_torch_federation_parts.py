"""The federation's parts in the port against the JAX package's, each on
the same inputs: the numpy draws (data, probes, batch streams, topology)
bit-equal, the split policy and clustering equal, the fingerprints,
divergences and trust scores and every aggregation function in float64 to
about 1e-10, the semantic basis up to column signs, and the optimizers of
the round loop."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import clustering as jclus
from repro.core import fingerprint as jfp
from repro.core import splitting as jsplit
from repro.core import trust as jtrust
from repro.core.screening import TrustLedger as JaxTrustLedger
from repro.core.ssop import semantic_subspace as jax_semantic_subspace
from repro.data import pipeline as jpipe
from repro.data import probe as jprobe
from repro.data import synthetic as jsyn
from repro.federation import topology as jtopo
from repro.federation.engine import is_client_map as jax_is_client_map
from repro import optim as joptim
from repro_torch import telemetry as tm
from repro_torch.core import aggregation as pagg
from repro_torch.core import clustering as pclus
from repro_torch.core import fingerprint as pfp
from repro_torch.core import splitting as psplit
from repro_torch.core import trust as ptrust
from repro_torch.core.screening import TrustLedger
from repro_torch.core.ssop import semantic_subspace
from repro_torch.data import pipeline as ppipe
from repro_torch.data import probe as pprobe
from repro_torch.data import synthetic as psyn
from repro_torch.federation import topology as ptopo
from repro_torch.federation.engine import is_client_map
from repro_torch import optim as poptim


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# numpy draws: bit-equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task_kind", ["classification", "causal-lm"])
def test_federation_data_probe_and_test_set_are_bit_equal(task_kind):
    kw = dict(vocab_size=300, num_classes=4, seq_len=24, cls_token=1)
    jt, pt = jsyn.SyntheticTaskConfig(**kw), psyn.SyntheticTaskConfig(**kw)
    jd = jsyn.make_federation_data(jt, 6, 400, 0.2, poisoned_clients=(2, 4),
                                   seed=3, task_kind=task_kind)
    pd = psyn.make_federation_data(pt, 6, 400, 0.2, poisoned_clients=(2, 4),
                                   seed=3, task_kind=task_kind)
    for n in range(6):
        np.testing.assert_array_equal(pd[n].tokens, jd[n].tokens)
        np.testing.assert_array_equal(pd[n].labels, jd[n].labels)
        assert pd[n].poisoned == jd[n].poisoned
    for a, b in zip(psyn.make_test_set(pt, 64, seed=7),
                    jsyn.make_test_set(jt, 64, seed=7)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pprobe.make_probe_set(pt, 16, seed=5),
                                  jprobe.make_probe_set(jt, 16, seed=5))


def test_batch_streams_are_bit_equal():
    rng = np.random.default_rng(0)
    toks, labs = rng.integers(0, 50, (37, 8)), rng.integers(0, 4, 37)
    jit = jpipe.CountingIterator(jpipe.infinite_batches(toks, labs, 16, 9))
    pit = ppipe.CountingIterator(ppipe.infinite_batches(toks, labs, 16, 9))
    for _ in range(7):       # over two epochs, ragged tails included
        for a, b in zip(next(pit), next(jit)):
            np.testing.assert_array_equal(a, b)
    assert pit.count == jit.count == 7
    pit.fast_forward(9)
    jit.fast_forward(9)
    for a, b in zip(next(pit), next(jit)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="rewind"):
        pit.fast_forward(3)


@pytest.mark.parametrize("frac", [0.0, 0.3])
def test_topology_and_splits_are_equal(frac):
    jt = jtopo.make_topology(9, 3, constrained_frac=frac, seed=4)
    pt = ptopo.make_topology(9, 3, constrained_frac=frac, seed=4)
    for f in ("client_xy", "edge_xy", "latency", "bandwidth", "capacity"):
        np.testing.assert_array_equal(getattr(pt, f), getattr(jt, f))
    for m in (6, 12):
        kw = dict(num_blocks=m, o_fix=2, p_min=1, p_max=min(5, m - 3))
        assert psplit.splits_for_population(
            pt.capacity, pt.bandwidth, psplit.SplitPolicy(**kw)) == \
            jsplit.splits_for_population(jt.capacity, jt.bandwidth,
                                         jsplit.SplitPolicy(**kw))
    with pytest.raises(ValueError, match="too shallow"):
        psplit.SplitPolicy(num_blocks=3, p_max=0)


# ---------------------------------------------------------------------------
# profiling: fingerprints, divergences, trust, clustering, the SS-OP basis
# ---------------------------------------------------------------------------

def _embeddings(n, q, d, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(q, d))
    return [base + rng.normal(scale=0.5 + 0.2 * i, size=(q, d)) + i
            for i in range(n)]


def test_fingerprints_divergences_and_trust_match_jax_f64():
    embs = _embeddings(5, 8, 64)
    with jax.enable_x64(True):
        jfps = [jfp.fingerprint(jnp.asarray(e)) for e in embs]
        jdiv = jfp.divergence_matrix(jfps)
        jkl = float(jfp.kl_gaussian(jfps[0], jfps[1]))
    pfps = [pfp.fingerprint(_t(e)) for e in embs]
    for a, b in zip(pfps, jfps):
        np.testing.assert_allclose(a.mu.numpy(), np.asarray(b.mu),
                                   rtol=1e-12)
        np.testing.assert_allclose(a.sigma.numpy(), np.asarray(b.sigma),
                                   rtol=1e-12, atol=1e-14)
    assert abs(float(pfp.kl_gaussian(pfps[0], pfps[1])) - jkl) <= \
        1e-10 * abs(jkl)
    pdiv = pfp.divergence_matrix(pfps)
    np.testing.assert_allclose(pdiv, jdiv, rtol=1e-10)
    norms = np.stack([np.linalg.norm(e, axis=-1) for e in embs])
    np.testing.assert_allclose(ptrust.trust_scores(pdiv, norms),
                               jtrust.trust_scores(jdiv, norms), rtol=1e-10)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cluster_clients_groups_are_equal(seed):
    embs = _embeddings(8, 8, 32, seed)
    fps = [pfp.fingerprint(_t(e)) for e in embs]
    div = pfp.divergence_matrix(fps)
    norms = np.stack([np.linalg.norm(e, axis=-1) for e in embs])
    trust = ptrust.trust_scores(div, norms)
    lat = jtopo.make_topology(8, 2, seed=seed).latency
    kw = dict(tau_max=200.0, gamma=1.0, w_min=0.25, seed=seed)
    got = pclus.cluster_clients(div, trust, lat, **kw)
    want = jclus.cluster_clients(div, trust, lat, **kw)
    assert got.groups == want.groups
    assert (got.escalated, got.excluded, got.assignment) == \
        (want.escalated, want.excluded, want.assignment)
    assert got.group_trust == want.group_trust


def test_semantic_subspace_matches_jax_up_to_column_signs():
    j = np.random.default_rng(3).normal(size=(16, 48)).astype(np.float32)
    got = semantic_subspace(_t(j), 8).numpy()
    want = np.asarray(jax_semantic_subspace(jnp.asarray(j), 8))
    assert got.shape == want.shape == (48, 8)
    signs = np.sign((got * want).sum(0))
    np.testing.assert_allclose(got * signs, want, atol=1e-5)
    np.testing.assert_allclose(got @ got.T, want @ want.T, atol=1e-5)


def test_trust_ledger_matches_jax():
    p, j = TrustLedger(4, beta=0.6), JaxTrustLedger(4, beta=0.6)
    seed = np.array([0.2, 1.5, 1e-9, 0.7])
    p.seed(seed)
    j.seed(seed)
    for c, ok in ((0, True), (2, False), (0, False), (3, True)):
        p.record(c, ok)
        j.record(c, ok)
    for k in ("scores", "passes", "fails"):
        np.testing.assert_array_equal(getattr(p, k), getattr(j, k))
    assert p.weight(0) == j.weight(0)
    with pytest.raises(ValueError, match="beta"):
        TrustLedger(2, beta=1.5)


# ---------------------------------------------------------------------------
# aggregation: float64 to ~1e-12 on the same trees
# ---------------------------------------------------------------------------

L, D, R, H, E = 2, 12, 3, 2, 4


def _lora_np(rng):
    """A LoRA tree in the JAX layout (layer-stacked ``blocks``), with the
    pooler/head leaves of the encoder."""
    def n(*s):
        return rng.normal(size=s)
    return {"blocks": {"attn": {"q_a": n(L, D, R), "q_b": n(L, R, H, E),
                                "v_a": n(L, D, R), "v_b": n(L, R, H, E)}},
            "pooler": {"w": n(D, D), "b": n(D)},
            "head": {"w": n(D, 4), "b": n(4)}}


def _to_port(tree):
    return {"blocks": [{"attn": {k: _t(v[i]) for k, v in
                                 tree["blocks"]["attn"].items()}}
                       for i in range(L)],
            **{k: {kk: _t(vv) for kk, vv in v.items()}
               for k, v in tree.items() if k != "blocks"}}


def _from_port(tree):
    out = {k: {kk: vv.numpy() for kk, vv in v.items()}
           for k, v in tree.items() if k != "blocks"}
    out["blocks"] = {"attn": {k: np.stack([b["attn"][k].numpy()
                                           for b in tree["blocks"]])
                              for k in tree["blocks"][0]["attn"]}}
    return out


def _assert_trees(got_port, want_jax, rtol=1e-12):
    got = _from_port(got_port)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=rtol,
                                                atol=1e-14),
        got, want_jax)


@pytest.fixture
def trees():
    rng = np.random.default_rng(0)
    base = _lora_np(rng)
    return [jax.tree_util.tree_map(
        lambda x: x + 0.1 * rng.normal(size=x.shape), base)
        for _ in range(3)]


@pytest.mark.parametrize("mode", ["factor", "product"])
def test_aggregate_adapters_matches_jax_f64(trees, mode):
    w = [14, 30, 7]
    with jax.enable_x64(True):
        want = jagg.aggregate_adapters(
            [jax.tree_util.tree_map(jnp.asarray, t) for t in trees], w,
            mode=mode)
        want1 = jagg.aggregate_adapters(
            [jax.tree_util.tree_map(jnp.asarray, trees[0])], [3], mode=mode)
    _assert_trees(pagg.aggregate_adapters([_to_port(t) for t in trees], w,
                                          mode=mode), want)
    _assert_trees(pagg.aggregate_adapters([_to_port(trees[0])], [3],
                                          mode=mode), want1)
    with pytest.raises(ValueError, match="mode"):
        pagg.aggregate_adapters([_to_port(trees[0])], [1], mode="median")


def test_pair_delta_and_refactor_match_jax_f64(trees):
    a, b = (trees[0]["blocks"]["attn"][k] for k in ("q_a", "q_b"))
    dw = _t(trees[1]["blocks"]["attn"]["q_a"][0]) @ _t(
        trees[1]["blocks"]["attn"]["q_b"][0]).reshape(R, -1)
    with jax.enable_x64(True):
        jdw = np.asarray(jagg.pair_delta(jnp.asarray(a), jnp.asarray(b)))
        _, jb = jagg.refactor_delta(jnp.asarray(dw.numpy()[None]),
                                    jnp.asarray(a[:1]), jnp.asarray(b[:1]))
    for i in range(L):
        np.testing.assert_allclose(
            pagg.pair_delta(_t(a[i]), _t(b[i])).numpy(), jdw[i], rtol=1e-12)
    pa, pb = pagg.refactor_delta(dw, _t(a[0]), _t(b[0]))
    np.testing.assert_array_equal(pa.numpy(), a[0])
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb)[0], rtol=1e-10)


def test_cloud_weights_and_delta_match_jax_f64(trees):
    div = np.abs(np.random.default_rng(5).normal(size=(6, 6))) * 50
    div = div + div.T
    np.fill_diagonal(div, 0)
    for members in ([0], [1, 4], [0, 2, 3, 5]):
        assert pagg.mean_pairwise_kld(div, members) == \
            jagg.mean_pairwise_kld(div, members)
    assert pagg.edge_weight(12.5, 0.8) == jagg.edge_weight(12.5, 0.8)
    edges = {2: trees[0], 0: trees[1], 5: trees[2]}
    alphas = {2: 0.3, 0: -0.1, 5: 0.9}
    for mode in ("factor", "product"):
        with jax.enable_x64(True):
            want = jagg.cloud_aggregate(
                {k: jax.tree_util.tree_map(jnp.asarray, t)
                 for k, t in edges.items()}, alphas, mode=mode)
            jdelta = jagg.global_delta(
                want, jax.tree_util.tree_map(jnp.asarray, trees[0]))
        got = pagg.cloud_aggregate({k: _to_port(t) for k, t in edges.items()},
                                   alphas, mode=mode)
        _assert_trees(got, want)
        assert abs(pagg.global_delta(got, _to_port(trees[0])) - jdelta) <= \
            1e-12 * jdelta


# ---------------------------------------------------------------------------
# the optimizers and helpers of the round loop
# ---------------------------------------------------------------------------

def test_server_optimizers_and_fedprox_match_jax(trees):
    params, grads, anchor = trees
    pp, pg, pa = (_to_port(t) for t in (params, grads, anchor))
    jp, jg, ja = (jax.tree_util.tree_map(jnp.asarray, t)
                  for t in (params, grads, anchor))
    with jax.enable_x64(True):
        jp, jg, ja = (jax.tree_util.tree_map(jnp.asarray, t)
                      for t in (params, grads, anchor))
        _assert_trees(poptim.fedprox_gradient(pg, pp, pa, 0.01),
                      joptim.fedprox_gradient(jg, jp, ja, 0.01))
        for mk in (lambda m: m.SGD(lr=0.1), lambda m: m.SGD(lr=0.1,
                                                            momentum=0.9),
                   lambda m: m.FedAdam(lr=0.03), lambda m: m.FedAMS(lr=1.0)):
            po, jo = mk(poptim), mk(joptim)
            ps, js = po.init(pp), jo.init(jp)
            p, j = pp, jp
            for _ in range(3):
                p, ps = po.update(p, pg, ps)
                j, js = jo.update(j, jg, js)
            # the server optimizers keep their moments in float32, as the
            # JAX package's do, so f64 parameters agree to f32 round-off
            rtol = 1e-12 if isinstance(po, poptim.SGD) else 1e-6
            _assert_trees(p, j, rtol=rtol)
            assert int(ps["step"]) == int(js["step"]) == 3
        fp = poptim.FedProx(lr=0.1, mu=0.01)
        fj = joptim.FedProx(lr=0.1, mu=0.01)
        p, _ = fp.update(pp, pg, fp.set_anchor(fp.init(pp), pa))
        j, _ = fj.update(jp, jg, fj.set_anchor(fj.init(jp), ja))
        _assert_trees(p, j)


def test_lr_tree_schedules_and_client_map_match_jax(trees):
    pl = poptim.adapter_head_lr_tree(_to_port(trees[0]), 0.1, 0.4)
    jl = joptim.adapter_head_lr_tree(trees[0], 0.1, 0.4)
    assert pl["blocks"][1]["attn"]["q_a"] == 0.1
    assert pl["head"] == jl["head"] and pl["pooler"] == jl["pooler"]
    assert poptim.adapter_head_lr_tree(_to_port(trees[0]), 0.1)["head"] == \
        {"w": 0.1, "b": 0.1}
    steps = np.arange(0, 40, 3)
    for mk in (lambda m: m.constant(), lambda m: m.cosine_decay(30),
               lambda m: m.warmup_cosine(5, 30)):
        got = [float(mk(poptim)(torch.tensor(s, dtype=torch.int32)))
               for s in steps]
        want = [float(mk(joptim)(jnp.int32(s))) for s in steps]
        np.testing.assert_allclose(got, want, rtol=1e-6)
    for theta in ({0: 1, 3: 2}, {np.int64(2): 0}, {"blocks": 1}, {}, {True: 1},
                  [1]):
        assert is_client_map(theta) == jax_is_client_map(theta)


def test_telemetry_span_and_end_round():
    with tm.span("local_steps", round=0, edge=1):
        pass                                  # disabled: a no-op
    tm.end_round(0)
    tel = tm.enable()
    try:
        with tm.span("eval", round=0):
            pass
        tm.end_round(0)
        assert [r["round"] for r in tel.rounds] == [0]
        assert tel.rounds[0]["spans"][0]["name"] == "eval"
        assert tm.summary()["spans"]["eval"]["count"] == 1
    finally:
        tm.disable()
