"""The port's update screening (``FedConfig(screen=True)``) against the JAX
package's: the delta statistics, the trimmed mean, the verdicts and
fallbacks on synthetic statistics (the cases of
``tests/test_fault_tolerance.py``), the trust ledger, and whole screened
federations in float64 on the plain round loop and the three runtime
policies.

As in ``tests/test_torch_runtime.py``, whole runs are held in float64 at
lr 1e-4 against the JAX package's sequential backend (the port runs its
default, batched one), with the JAX federation's weights and per-client
channels carried into the port.  Both packages compute the screening
statistics in float32 even in an x64 run, so their verdicts are judged on
the same f32 numbers up to summation order; the thresholds here lie far
from every statistic, so verdicts, kept sets and fallbacks must be equal,
and the trust ledgers (float64 EMAs of those verdicts) equal to 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jax_agg
from repro.core import screening as jax_screening
from repro.federation import engine as jax_engine
from repro.federation import topology as jax_topo
from repro.federation.simulation import FedConfig as JaxFedConfig
from repro.federation.simulation import Federation as JaxFederation
from repro.runtime import RuntimeConfig as JaxRuntimeConfig
from repro_torch import bridge
from repro_torch import telemetry as tm
from repro_torch.core import aggregation as agg
from repro_torch.core import screening
from repro_torch.core.screening import (FLIP, LOW_TRUST, NONFINITE, NORM, OK,
                                        ScreeningConfig, TrustLedger,
                                        screen_and_aggregate, screen_updates)
from repro_torch.core.split_training import Channel
from repro_torch.core.ssop import SSOP
from repro_torch.federation import FedConfig, Federation, topology
from repro_torch.federation.engine import screen_stats
from repro_torch.runtime import RuntimeConfig

# 4 clients on 2 edges at 4 layers, client 3 poisoned; lr 1e-4 in float64
# and one local step a round (the runtime tests' parity configuration: at
# two steps the chaotic map already amplifies the packages' round-off in
# the second round's delta to ~1e-6, with screening off as on), xi 0 so
# every run takes both rounds (at lr 1e-4 a round's delta can fall under
# the default 1e-4)
PARITY_KW = dict(n_clients=4, n_edges=2, alpha=0.2, poisoned=(3,),
                 total_examples=240, probe_q=8, local_warmup_steps=1,
                 lr=1e-4, layers=4, t_rounds=1, batch_size=16,
                 dtype="float64", seed=0, xi=0.0, screen=True)
SMALL_KW = dict(n_clients=4, n_edges=2, alpha=5.0, poisoned=(),
                total_examples=200, probe_q=8, local_warmup_steps=1,
                layers=4, t_rounds=1, batch_size=8, seed=0, seq_len=16,
                num_classes=4, clip_norm=1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch ops on one CPU thread (see
    ``tests/test_torch_federation.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


# ---------------------------------------------------------------------------
# screen_stats
# ---------------------------------------------------------------------------

def _cohort(case, dtype):
    """A base tree and a cohort of updates: honest ones, and the case's
    bad ones (a NaN leaf, an Inf leaf, a sign flip, a x10 scale)."""
    rng = np.random.default_rng(0)
    base = {"a": rng.standard_normal((2, 3)).astype(dtype),
            "b": np.zeros(4, dtype),
            "c": {"w": rng.standard_normal((3, 5)).astype(dtype)}}

    # honest updates share a direction (the task's gradient) plus noise
    common = jax.tree_util.tree_map(lambda v: rng.standard_normal(v.shape),
                                    base)

    def perturb(scale):
        return jax.tree_util.tree_map(
            lambda v, c: (v + scale * (c + 0.3 * rng.standard_normal(
                v.shape))).astype(dtype), base, common)
    trees = [perturb(0.1) for _ in range(3)]
    if case == "nan":
        bad = perturb(0.1)
        bad["a"][0, 0] = np.nan
        trees.append(bad)
    elif case == "inf":
        bad = perturb(0.1)
        bad["c"]["w"][1, 2] = -np.inf
        trees += [bad, perturb(0.1)]
    elif case == "signflip":
        trees.append(jax.tree_util.tree_map(lambda b, t: (2 * b - t).astype(
            dtype), base, trees[0]))
    elif case == "scale":
        trees.append(jax.tree_util.tree_map(
            lambda b, t: (b + 10.0 * (t - b)).astype(dtype), base, trees[1]))
    weights = [float(w) for w in rng.integers(5, 40, len(trees))]
    return base, trees, weights


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["honest", "nan", "inf", "signflip",
                                  "scale"])
def test_screen_stats_matches_jax(case, dtype):
    base, trees, weights = _cohort(case, dtype)
    with jax.enable_x64(True):
        want = jax_engine.screen_stats(
            jax.tree_util.tree_map(jnp.asarray, base),
            [jax.tree_util.tree_map(jnp.asarray, t) for t in trees],
            weights)
    got = screen_stats(_torch(base), [_torch(t) for t in trees], weights)
    fin, norms, cos = got
    assert fin.dtype == bool and norms.dtype == cos.dtype == np.float64
    np.testing.assert_array_equal(fin, want[0])
    assert fin.all() == (case not in ("nan", "inf"))
    np.testing.assert_allclose(norms[fin], want[1][fin], rtol=1e-6)
    np.testing.assert_allclose(cos[fin], want[2][fin], rtol=1e-6,
                               atol=1e-7)
    if case == "signflip":
        assert cos[-1] < -0.5 < cos[0]
        assert np.isclose(norms[-1], norms[0], rtol=1e-5)
    if case == "scale":
        assert norms[-1] > 4 * np.median(norms)


def test_screen_stats_casts_to_float32_as_jax():
    """A float64 tree's deltas are formed in float32, as the JAX package
    forms them: a difference below f32 resolution vanishes."""
    base = {"w": np.ones(3)}
    tiny = {"w": np.ones(3) + 1e-12}
    fin, norms, _ = screen_stats(_torch(base), [_torch(tiny)] * 2,
                                 [1.0, 1.0])
    assert fin.all() and (norms == 0.0).all()


# ---------------------------------------------------------------------------
# trimmed mean
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("trim_frac", [0.0, 0.25, 0.4])
def test_trimmed_mean_matches_jax(n, trim_frac):
    rng = np.random.default_rng(n)
    trees = [{"a": rng.standard_normal((3, 4)), "b": [rng.standard_normal(5)]}
             for _ in range(n)]
    for dtype, rtol in ((np.float64, 0.0), (np.float32, 1e-6)):
        ts = [jax.tree_util.tree_map(lambda x: x.astype(dtype), t)
              for t in trees]
        with jax.enable_x64(True):
            want = _np(jax_agg.trimmed_mean(
                [jax.tree_util.tree_map(jnp.asarray, t) for t in ts],
                trim_frac=trim_frac))
        got = agg.trimmed_mean([_torch(t) for t in ts], trim_frac=trim_frac)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            assert a.numpy().dtype == b.dtype == dtype
            np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=0)


def test_trimmed_mean_resists_outliers_and_validates():
    trees = [{"w": torch.full((2,), v)} for v in (1.0, 2.0, 3.0, 1000.0)]
    out = agg.trimmed_mean(trees, trim_frac=0.25)
    assert out["w"].tolist() == [2.5, 2.5]                # mean of {2, 3}
    assert agg.trimmed_mean(trees[:1])["w"].tolist() == [1.0, 1.0]
    for mod in (agg, jax_agg):
        with pytest.raises(ValueError, match="no trees"):
            mod.trimmed_mean([], trim_frac=0.25)
        with pytest.raises(ValueError, match=r"\[0, 0.5\)"):
            mod.trimmed_mean(trees, trim_frac=0.5)


# ---------------------------------------------------------------------------
# verdicts, fallbacks and the ledger on synthetic statistics
# ---------------------------------------------------------------------------

def _np_stats(base, trees, weights):
    """tests/test_fault_tolerance.py's numpy screen statistics, taking
    either package's trees."""
    deltas = [np.asarray(t["w"], np.float64) - np.asarray(base["w"],
                                                          np.float64)
              for t in trees]
    fin = np.array([np.isfinite(d).all() for d in deltas])
    norms = np.array([np.sqrt((d * d).sum()) if f else np.inf
                      for d, f in zip(deltas, fin)])
    w = np.asarray(weights, np.float64) * fin
    mean = sum(wi * np.where(np.isfinite(d), d, 0.0)
               for wi, d in zip(w, deltas)) / max(w.sum(), 1e-12)
    cos = np.array([
        (d * mean).sum() / max(norms[i] * np.sqrt((mean * mean).sum()),
                               1e-12)
        if fin[i] else 0.0 for i, d in enumerate(deltas)])
    return fin, norms, cos


def _vals(v):
    return np.full(8, v, np.float32)


# (name, base value, update values, weights, clients, ledger beta, scores
#  before, config, aggregate?)
CASES = {
    "every failure mode": (0.0, [1.0, 1.1, 0.9, np.nan, 50.0, -1.0],
                           [1.0] * 6, list(range(6)), 0.7, None,
                           ScreeningConfig(), True),
    "post-update low trust kept": (0.0, [1.0, 1.0], [1.0, 1.0], [0, 1], 0.5,
                                   [1.0, 0.2],
                                   ScreeningConfig(trust_floor=0.15), True),
    "post-update low trust dropped": (0.0, [1.0, 1.0], [1.0, 1.0], [0, 1],
                                      0.5, [1.0, 0.05],
                                      ScreeningConfig(trust_floor=0.6), True),
    "keep-base": (0.0, [np.nan, np.nan], [1.0, 1.0], [0, 1], 0.7, None,
                  ScreeningConfig(min_cohort=2), True),
    "trimmed": (0.0, [1.0, 1.2, np.nan, 60.0, -1.0], [1.0] * 5,
                [0, 1, 2, 3, 4], 0.7, None, ScreeningConfig(min_cohort=3),
                True),
    "healthy": (0.0, [1.0, 1.0, 1.0], [1.0] * 3, [0, 1, 2], 0.7, None,
                ScreeningConfig(min_cohort=2), True),
    "weighted, repeated client": (0.5, [1.0, 2.0, 1.5, -3.0], [3.0, 1.0, 2.0,
                                                                5.0],
                                  [2, 0, 2, 1], 0.6, [0.9, 0.3, 0.5],
                                  ScreeningConfig(), True),
    "screen only": (0.0, [1.0, 1.1, np.inf, -1.0], [2.0, 1.0, 1.0, 1.0],
                    [0, 1, 2, 3], 0.7, [1.0, 0.8, 0.6, 0.4],
                    ScreeningConfig(), False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_screening_decisions_match_jax(name):
    bval, vals, weights, clients, beta, scores, cfg, aggregate = CASES[name]
    n_ledger = max(clients) + 1
    jcfg = jax_screening.ScreeningConfig(**vars(cfg))
    jled, led = (jax_screening.TrustLedger(n_ledger, beta=beta),
                 TrustLedger(n_ledger, beta=beta))
    if scores is not None:
        jled.seed(np.array(scores))
        led.seed(np.array(scores))
    jbase, jtrees = {"w": jnp.asarray(_vals(bval))}, \
        [{"w": jnp.asarray(_vals(v))} for v in vals]
    base, trees = {"w": torch.from_numpy(_vals(bval))}, \
        [{"w": torch.from_numpy(_vals(v))} for v in vals]
    if aggregate:
        want_out, want = jax_screening.screen_and_aggregate(
            jbase, jtrees, weights, clients, jled, jcfg, mode="factor",
            stats_fn=_np_stats)
        got_out, got = screen_and_aggregate(
            base, trees, weights, clients, led, cfg, mode="factor",
            stats_fn=_np_stats)
        np.testing.assert_allclose(got_out["w"].numpy(),
                                   np.asarray(want_out["w"]), rtol=1e-6)
    else:
        want = jax_screening.screen_updates(jbase, jtrees, weights, clients,
                                            jled, jcfg, stats_fn=_np_stats)
        got = screen_updates(base, trees, weights, clients, led, cfg,
                             stats_fn=_np_stats)
    assert (got.clients, got.verdicts, got.kept, got.fallback) \
        == (want.clients, want.verdicts, want.kept, want.fallback)
    assert got.n_excluded == want.n_excluded
    assert (screening.OK, NONFINITE, NORM, FLIP, LOW_TRUST) == (
        jax_screening.OK, jax_screening.NONFINITE, jax_screening.NORM,
        jax_screening.FLIP, jax_screening.LOW_TRUST)
    np.testing.assert_array_equal(led.scores, jled.scores)
    np.testing.assert_array_equal(led.passes, jled.passes)
    np.testing.assert_array_equal(led.fails, jled.fails)
    if name == "every failure mode":
        assert got.verdicts == [OK, OK, OK, NONFINITE, NORM, FLIP]
    if name == "post-update low trust dropped":
        assert got.verdicts == [OK, LOW_TRUST] and got.kept == [0]
    if name in ("keep-base", "trimmed"):
        assert got.fallback == name


def test_trust_ledger_ema_and_state_roundtrip():
    led = TrustLedger(3, beta=0.5)
    led.seed(np.array([1.0, 0.5, 0.0]))      # 0.0 clipped to 1e-6
    assert led.scores[2] == pytest.approx(1e-6)
    led.record(0, False)
    assert led.scores[0] == pytest.approx(0.5)
    led.record(0, True)
    assert led.scores[0] == pytest.approx(0.75)
    assert led.passes[0] == 1 and led.fails[0] == 1
    led2 = TrustLedger(3)
    led2.load_state(led.state())
    assert led2.beta == 0.5
    for k in ("scores", "passes", "fails"):
        np.testing.assert_array_equal(getattr(led2, k), getattr(led, k))
    assert led2.scores is not led.scores
    jled = jax_screening.TrustLedger(3)
    jled.load_state(led.state())            # the same state dict
    np.testing.assert_array_equal(jled.scores, led.scores)
    with pytest.raises(ValueError):
        TrustLedger(3, beta=1.5)


def test_screening_telemetry_counts_verdicts_and_sets_gauges():
    led = TrustLedger(6)
    base = {"w": torch.zeros(8)}
    trees = [{"w": torch.from_numpy(_vals(v))}
             for v in (1.0, 1.1, 0.9, np.nan, 50.0, -1.0)]
    tel = tm.enable()
    try:
        screen_and_aggregate(base, trees, [1.0] * 6, list(range(6)), led,
                             ScreeningConfig(), mode="factor",
                             stats_fn=_np_stats)
        screen_and_aggregate(base, trees[3:4] * 2, [1.0] * 2, [3, 3], led,
                             ScreeningConfig(), mode="factor",
                             stats_fn=_np_stats)
    finally:
        tm.disable()
    assert tel.counter("screening.verdicts", verdict=OK) == 3
    assert tel.counter("screening.verdicts", verdict=NONFINITE) == 3
    assert tel.counter("screening.verdicts", verdict=NORM) == 1
    assert tel.counter("screening.verdicts", verdict=FLIP) == 1
    assert tel.counter("screening.fallbacks", kind="keep-base") == 1
    assert tel.gauge("screening.trust_mean") == float(led.scores.mean())
    assert tel.gauge("screening.trust_min") == float(led.scores.min())
    assert tel.gauge("screening.below_floor") == 0
    assert tm.summarize(tel)["gauges"]["screening.trust_min"] \
        == float(led.scores.min())


# ---------------------------------------------------------------------------
# screened federations in x64 against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def feds():
    """A screened JAX federation (sequential backend, x64) and the port's
    (default backend) on its weights and channels."""
    with jax.enable_x64(True):
        jf = JaxFederation(JaxFedConfig(**PARITY_KW), backend="reference")
        jchannels = {n: jf.channel_for(n, jf.lora0)
                     for n in range(jf.fed.n_clients)}
    pf = Federation(FedConfig(**PARITY_KW), device="cpu")
    params = bridge.params_from_jax_numpy(pf.cfg, _np(jf.frozen),
                                          _np(jf.lora0), device="cpu")
    pf.frozen, pf.lora0 = params["frozen"], params["lora"]
    for n, ch in jchannels.items():
        pf._channels[n] = Channel(
            SSOP(u=torch.from_numpy(np.array(ch.ssop.u)),
                 v=torch.from_numpy(np.array(ch.ssop.v))), pf.plan)
    _carry_assignment(jf, pf)
    return jf, pf


def _carry_assignment(jf, pf):
    """Run the port's profiling (warm-up, fingerprints, trust, clustering)
    as it is, hold its groups and trust against the JAX run's, then carry
    the JAX run's divergences and trust into the port, as the channels are
    carried: the divergences are ill-conditioned (the packages' trust
    agree to ~1e-7, ``tests/test_torch_federation.py``), and with
    screening on they seed the trust ledger, which weights every
    aggregation."""
    jax_assign, port_assign = jf._assign_groups, pf._assign_groups
    seen = []

    def jax_side(method, rng):
        seen.append(jax_assign(method, rng))
        return seen[-1]

    def port_side(method, rng):
        groups, _, trust = port_assign(method, rng)
        jgroups, jdiv, jtrust = seen.pop()
        assert groups == jgroups
        np.testing.assert_allclose(trust, jtrust, rtol=1e-6, atol=1e-12)
        pf.trust_ledger.seed(jtrust)
        return groups, np.array(jdiv), np.array(jtrust)
    jf._assign_groups, pf._assign_groups = jax_side, port_side


def _churn(n_clients):
    return dict(mean_on_s=40.0, mean_off_s=15.0, churn_frac=0.5, seed=2,
                n_clients=n_clients, horizon_s=10_000.0)


def _runtime(run, n, mod):
    """The run's runtime config, its traces from ``mod`` (either
    package's topology module)."""
    if run == "plain":
        return None
    if run == "sync with NaN updates":
        # tests/test_fault_tolerance.py's acceptance trace
        return dict(policy="sync", faults=mod.make_fault_trace(
            n, faulty_frac=0.25, corrupt_rate=1.0, corrupt_modes=("nan",),
            seed=11))
    return dict(policy=run.split()[0], churn=mod.make_churn_trace(
        **_churn(n)), faults=mod.make_fault_trace(
        n, faulty_frac=0.5, crash_rate=0.1, drop_rate=0.1, dup_rate=0.1,
        corrupt_rate=0.4, corrupt_modes=("signflip", "scale"), seed=3))


@pytest.mark.parametrize("run", [
    "plain", "sync with NaN updates", "deadline under churn and faults",
    "async under churn and faults"])
def test_screened_run_matches_jax_x64(feds, run):
    jf, pf = feds
    n = pf.fed.n_clients
    jlog, plog = len(jf.screen_log), len(pf.screen_log)
    jrt, prt = _runtime(run, n, jax_topo), _runtime(run, n, topology)
    with jax.enable_x64(True):
        want = jf.run("elsa", global_rounds=2, steps_per_round=1,
                      runtime=None if jrt is None
                      else JaxRuntimeConfig(**jrt))
    got = pf.run("elsa", global_rounds=2, steps_per_round=1,
                 runtime=None if prt is None else RuntimeConfig(**prt))
    assert set(got) == set(want)
    assert got["round"] == want["round"] == [0, 1]
    assert got["accuracy"] == want["accuracy"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-8)
    np.testing.assert_allclose(got["delta"], want["delta"], rtol=1e-7)
    for c in range(n):
        np.testing.assert_allclose(got["client_losses"][c],
                                   want["client_losses"][c], rtol=1e-8)
    if prt is not None:
        assert got["time"] == want["time"]
        assert got["trace"].records == want["trace"].records
    reports = [(r.clients, r.verdicts, r.kept, r.fallback)
               for r in pf.screen_log[plog:]]
    assert reports == [(list(map(int, r.clients)), r.verdicts, r.kept,
                        r.fallback) for r in jf.screen_log[jlog:]]
    pl, jl = pf.trust_ledger, jf.trust_ledger
    np.testing.assert_allclose(pl.scores, jl.scores, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(pl.passes, jl.passes)
    np.testing.assert_array_equal(pl.fails, jl.fails)
    verdicts = [v for r in reports for v in r[1]]
    if run == "async under churn and faults":
        assert not reports                 # screened one arrival at a time
        assert (pl.passes + pl.fails).sum() > 0
    else:
        assert verdicts
    if run == "sync with NaN updates":
        faulty = topology.make_fault_trace(
            n, faulty_frac=0.25, corrupt_rate=1.0, corrupt_modes=("nan",),
            seed=11).faulty
        judged = {c: v for r in reports for c, v in zip(r[0], r[1])}
        assert all(judged[c] == NONFINITE for c in faulty if c in judged)
        assert NONFINITE in verdicts
        assert all(np.isfinite(got["loss"]))
        for leaf in jax.tree_util.tree_leaves(pf.last_theta):
            assert torch.isfinite(leaf).all()


def test_screening_off_is_bit_inert():
    """``screen=False`` issues the unscreened aggregation: a default run's
    history and an explicit ``screen=False`` run's are equal bit for bit,
    and nothing is screened."""
    h1 = Federation(FedConfig(**SMALL_KW), device="cpu").run(
        "elsa", global_rounds=2, steps_per_round=2)
    f2 = Federation(FedConfig(**SMALL_KW, screen=False), device="cpu")
    h2 = f2.run("elsa", global_rounds=2, steps_per_round=2)
    for key in ("accuracy", "loss", "delta", "client_losses"):
        assert h1[key] == h2[key], key
    assert f2.screen_log == []
    assert (f2.trust_ledger.passes + f2.trust_ledger.fails).sum() == 0
