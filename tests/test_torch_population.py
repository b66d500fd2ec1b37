"""The port's registry-backed populations (``run(population=
PopulationConfig(...))``) against the JAX package's ``repro.population``.

Three layers:

1. Units against the JAX classes: the registry's columns, ``mix64`` data
   seeds, scatters that touch exactly their rows, lazy adapter shards and
   state round-trips; config validation; cohorts of every strategy and
   filter bit-equal to the JAX sampler's; ``AvailabilityCursors`` against
   a brute-force scan; per-id synthesized data bit-equal.
2. Bit-inertness on the port alone: an identity population
   (``registered == n_clients``) gives the history of a run without one,
   on the plain loop and on the sync policy.
3. Whole screened runs of 64 registered ids through 4 slots in float64
   against the JAX package's sequential backend, on the plain loop and
   the three runtime policies, with the JAX federation's weights, its
   clustering outputs (as in ``tests/test_torch_screening.py``) and its
   channels' shared basis U carried into the port (the SVD's column signs
   are LAPACK's choice; each identity's rotation V_n is numpy in both
   packages).  Cohorts, integer registry columns and verdict counts must
   be equal, trust and staleness to 1e-12, adapter rows, histories and
   theta to ``tests/test_torch_federation.py``'s tolerances; then
   population checkpoints, resumed bit-identically, and read across
   packages.
"""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as jax_restore
from repro.checkpoint import save as jax_save
from repro.checkpoint import federation as jax_fedckpt
from repro.federation import topology as jax_topo
from repro.federation.simulation import FedConfig as JaxFedConfig
from repro.federation.simulation import Federation as JaxFederation
from repro.population import AvailabilityCursors as JaxCursors
from repro.population import ClientRegistry as JaxRegistry
from repro.population import CohortSampler as JaxSampler
from repro.population import PopulationConfig as JaxPopulationConfig
from repro.population import PopulationRuntime as JaxPopulationRuntime
from repro.population.registry import mix64 as jax_mix64
from repro.runtime import RuntimeConfig as JaxRuntimeConfig
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointConfig, restore, save, tree_equal
from repro_torch.checkpoint import federation as fedckpt
from repro_torch.federation import FedConfig, Federation, topology
from repro_torch.population import (AvailabilityCursors, ClientRegistry,
                                    CohortSampler, PopulationConfig,
                                    PopulationRuntime)
from repro_torch.population.registry import SCALAR_COLUMNS, mix64
from repro_torch.runtime import RuntimeConfig

# screened, 4 slots on 2 edges at 4 layers, client 3 poisoned, float64 at
# lr 1e-4 and one local step a round (tests/test_torch_screening.py's
# parity configuration)
PARITY_KW = dict(n_clients=4, n_edges=2, alpha=0.2, poisoned=(3,),
                 total_examples=240, probe_q=8, local_warmup_steps=1,
                 lr=1e-4, layers=4, t_rounds=1, batch_size=16,
                 dtype="float64", seed=0, xi=0.0, screen=True)
TINY = dict(n_clients=4, n_edges=2, alpha=5.0, poisoned=(),
            total_examples=200, probe_q=8, local_warmup_steps=1,
            layers=4, t_rounds=1, batch_size=8, seed=0, seq_len=16,
            num_classes=4)
REGISTERED = 64
INT_COLUMNS = [n for n, dt, _ in SCALAR_COLUMNS if dt != np.float64]


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


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _filled(mod_registry, seed=9):
    rng = np.random.default_rng(1)
    reg = mod_registry(30, adapter_dim=5, shard_rows=8, seed=seed,
                       adapter_dtype="float16")
    reg.scatter(np.arange(10), trust=rng.random(10),
                participations=rng.integers(0, 9, 10),
                edge=rng.integers(-1, 3, 10))
    reg.scatter_adapters([3, 21], rng.random((2, 5)))
    return reg


def test_registry_defaults_and_data_seed_match_jax():
    reg, jreg = ClientRegistry(100, adapter_dim=6, shard_rows=16, seed=3), \
        JaxRegistry(100, adapter_dim=6, shard_rows=16, seed=3)
    assert list(reg.columns) == list(jreg.columns)
    for name, dt, fill in SCALAR_COLUMNS:
        col = getattr(reg, name)
        assert col.dtype == np.dtype(dt) and len(col) == 100
        np.testing.assert_array_equal(col, jreg.columns[name])
        assert col.dtype == jreg.columns[name].dtype
        if name != "data_seed":
            assert (col == fill).all()
    ids = np.arange(0, 10 ** 6, 997)
    for salt in (0, 3, 2 ** 40):
        np.testing.assert_array_equal(mix64(ids, salt=salt),
                                      jax_mix64(ids, salt=salt))
    assert len(np.unique(reg.data_seed)) == 100
    for mod in (ClientRegistry, JaxRegistry):
        with pytest.raises(ValueError):
            mod(0)
        with pytest.raises(ValueError):
            mod(8, shard_rows=0)
        with pytest.raises(AttributeError):
            mod(8).not_a_column


def test_registry_scatter_touches_exactly_its_rows():
    rng = np.random.default_rng(0)
    reg = ClientRegistry(50, adapter_dim=4, shard_rows=8)
    before = {k: v.copy() for k, v in reg.columns.items()}
    ids = rng.choice(50, 7, replace=False)
    reg.scatter(ids, trust=rng.random(7), last_round=np.arange(7))
    others = np.setdiff1d(np.arange(50), ids)
    for name in reg.columns:
        np.testing.assert_array_equal(reg.columns[name][others],
                                      before[name][others])
    got = reg.gather(ids, columns=("trust", "last_round"))
    assert set(got) == {"trust", "last_round"}
    np.testing.assert_array_equal(got["last_round"], np.arange(7))
    with pytest.raises(IndexError):
        reg.gather([50])
    with pytest.raises(IndexError):
        reg.scatter([-1], trust=[0.5])


def test_registry_adapter_shards_allocate_lazily():
    reg = ClientRegistry(40, adapter_dim=3, shard_rows=16)
    assert reg.n_shards == 3 and reg.allocated_shards == 0
    scalars = reg.nbytes
    assert scalars == JaxRegistry(40, adapter_dim=3, shard_rows=16).nbytes
    np.testing.assert_array_equal(reg.gather_adapters([0, 17, 39]),
                                  np.zeros((3, 3), np.float32))
    assert reg.allocated_shards == 0 and reg.nbytes == scalars
    reg.scatter_adapters([1, 39], np.arange(6, dtype=np.float32)
                         .reshape(2, 3))
    assert reg.allocated_shards == 2
    assert reg.has_adapter_shard(0) and reg.has_adapter_shard(2)
    assert not reg.has_adapter_shard(1)
    assert reg.nbytes == scalars + (16 + 8) * 3 * 4
    got = reg.gather_adapters([39, 1, 2])
    np.testing.assert_array_equal(got[0], [3.0, 4.0, 5.0])
    np.testing.assert_array_equal(got[1], [0.0, 1.0, 2.0])
    np.testing.assert_array_equal(got[2], np.zeros(3))
    with pytest.raises(ValueError):
        reg.scatter_adapters([1, 2], np.zeros((2, 4)))


def test_registry_state_roundtrips_across_packages(tmp_path):
    """A registry's state loads into either package's registry, and
    through either package's checkpoint files: the uint64 seeds, the
    int32 edge column and float16 adapter shards byte for byte, and the
    files themselves byte-equal."""
    reg = _filled(ClientRegistry)
    for mod in (ClientRegistry, JaxRegistry):
        other = mod(30, adapter_dim=5, shard_rows=8, seed=9,
                    adapter_dtype="float16")
        other.load_state(reg.state())
        for name in reg.columns:
            assert other.columns[name].tobytes() \
                == reg.columns[name].tobytes()
        assert other.allocated_shards == reg.allocated_shards == 2
        np.testing.assert_array_equal(other.gather_adapters(np.arange(30)),
                                      reg.gather_adapters(np.arange(30)))
    ours, theirs = str(tmp_path / "a"), str(tmp_path / "b")
    save(ours, reg.state())
    jax_save(theirs, _filled(JaxRegistry).state())
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    for state in (restore(theirs), jax_restore(ours)):
        assert state["columns"]["data_seed"].dtype == np.uint64
        assert state["columns"]["edge"].dtype == np.int32
        assert state["adapter_shards"][0][1].dtype == np.float16
        back = ClientRegistry(30, adapter_dim=5, shard_rows=8, seed=9,
                              adapter_dtype="float16")
        back.load_state(state)
        for name in reg.columns:
            assert back.columns[name].tobytes() \
                == reg.columns[name].tobytes()
        assert back.gather_adapters(np.arange(30)).tobytes() \
            == reg.gather_adapters(np.arange(30)).tobytes()
    for mod, match in ((ClientRegistry, "registered"),
                       (JaxRegistry, "registered")):
        with pytest.raises(ValueError, match=match):
            mod(31, adapter_dim=5, shard_rows=8).load_state(reg.state())
    with pytest.raises(ValueError, match="shard_rows"):
        ClientRegistry(30, adapter_dim=5, shard_rows=16).load_state(
            reg.state())


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------

def test_config_validation_matches_jax():
    bad = [dict(registered=8, strategy="lottery"), dict(registered=0),
           dict(registered=8, staleness_beta=1.5)]
    for kw in bad:
        with pytest.raises(ValueError):
            PopulationConfig(**kw)
        with pytest.raises(ValueError):
            JaxPopulationConfig(**kw)
    with pytest.raises(ValueError, match="strategy"):
        PopulationConfig(registered=8, strategy="lottery")
    with pytest.raises(ValueError, match="churn"):
        PopulationConfig(registered=8,
                         churn=topology.make_churn_trace(4, 100.0, seed=0))
    assert PopulationConfig(registered=8).shard_rows == \
        JaxPopulationConfig(registered=8).shard_rows


def _both_samplers(registered, trust=None, churn=None, **kw):
    """The port's and the JAX package's samplers on equal registries (and
    each package's own churn trace of the same parameters)."""
    out = []
    for reg_mod, cfg_mod, samp_mod, topo in (
            (ClientRegistry, PopulationConfig, CohortSampler, topology),
            (JaxRegistry, JaxPopulationConfig, JaxSampler, jax_topo)):
        reg = reg_mod(registered)
        if trust is not None:
            reg.trust[:] = trust
        tr = None if churn is None else topo.make_churn_trace(**churn)
        out.append(samp_mod(reg, cfg_mod(registered=registered, churn=tr,
                                         **kw)))
    return out


def _trusts(n):
    t = np.full(n, 0.1)
    t[[2, 5, 11, 17, 40, 41]] = 0.9
    t[3] = 0.4
    return t


@pytest.mark.parametrize("case", [
    "identity", "uniform", "round-robin", "min_trust exact",
    "min_trust top-up", "min_trust sampled", "churn", "churn round-robin"])
def test_cohorts_bit_equal_to_jax(case):
    churn = dict(n_clients=500, horizon_s=400.0, mean_on_s=30.0,
                 mean_off_s=30.0, seed=2)
    k, n, kw = 6, 500, dict(seed=11)
    if case == "identity":
        k = n = 6
    elif case == "round-robin":
        kw["strategy"] = "round-robin"
    elif case.startswith("min_trust"):
        kw["min_trust"] = 0.5
        kw["trust"] = _trusts(n)
        k = {"min_trust exact": 6, "min_trust top-up": 8,
             "min_trust sampled": 4}[case]
    else:
        kw["churn"] = churn
        if case == "churn round-robin":
            kw["strategy"] = "round-robin"
    ours, theirs = _both_samplers(n, **kw)
    for g, t in enumerate((0.0, 35.0, 90.0, 300.0, 120.0)):
        a = ours.sample(g, k, t=t)
        b = theirs.sample(g, k, t=t)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int64 and len(np.unique(a)) == k
        assert ours.last_eligible == theirs.last_eligible
    if case == "identity":
        np.testing.assert_array_equal(a, np.arange(6))
    if case == "min_trust exact":
        np.testing.assert_array_equal(ours.sample(0, 6),
                                      [2, 5, 11, 17, 40, 41])
    if case == "min_trust top-up":
        assert 3 in ours.sample(0, 8).tolist()
    with pytest.raises(ValueError, match="cohort"):
        ours.sample(0, n + 1)


def test_availability_cursors_match_brute_force_and_jax():
    trace = topology.make_churn_trace(30, 500.0, mean_on_s=20.0,
                                      mean_off_s=15.0, churn_frac=0.8,
                                      seed=4)
    cur, jcur = AvailabilityCursors(trace), JaxCursors(trace)

    def brute(t):
        return np.array([not any(s <= t < e for s, e in iv)
                         for iv in trace.offline])

    ts = np.sort(np.random.default_rng(0).uniform(0, 600, 40))
    for t in list(ts) + [10.0, 450.0]:     # monotone, then backwards
        got = cur.online_mask(t)
        np.testing.assert_array_equal(got, brute(t))
        np.testing.assert_array_equal(got, jcur.online_mask(t))
        np.testing.assert_array_equal(cur.cursor, jcur.cursor)


# ---------------------------------------------------------------------------
# identity populations are bit-inert (the port alone)
# ---------------------------------------------------------------------------

def _tiny_history(population, runtime=None, **run_kw):
    fed = Federation(FedConfig(**TINY), device="cpu")
    h = fed.run("elsa", global_rounds=2, steps_per_round=2,
                runtime=runtime, population=population, **run_kw)
    return fed, h


@pytest.mark.parametrize("policy", [None, "sync"])
def test_identity_population_is_bit_inert(policy):
    rt = None if policy is None else RuntimeConfig(policy=policy)
    fed0, h0 = _tiny_history(None, runtime=rt)
    fed1, h1 = _tiny_history(PopulationConfig(registered=TINY["n_clients"]),
                             runtime=rt)
    for key in ("accuracy", "loss", "delta", "client_losses") + (
            ("time",) if rt else ()):
        assert h0[key] == h1[key], key
    if rt is not None:
        assert h0["trace"].records == h1["trace"].records
    assert tree_equal(fed0.last_theta, fed1.last_theta)
    reg = fed1._population.registry
    assert (reg.participations == 2).all() and (reg.last_round == 1).all()
    assert fed0._channels and not fed1._channels   # identity LRU instead


def test_population_validation_against_federation():
    fed = Federation(FedConfig(**TINY), device="cpu")
    with pytest.raises(ValueError, match="registered"):
        fed.run("fedavg", global_rounds=1,
                population=PopulationConfig(registered=2))
    with pytest.raises(ValueError, match="cohort"):
        fed.run("fedavg", global_rounds=1,
                population=PopulationConfig(registered=8, cohort=6))
    other = Federation(FedConfig(**TINY), device="cpu")
    with pytest.raises(ValueError, match="different federation"):
        fed.run("fedavg", global_rounds=1, population=PopulationRuntime(
            other, PopulationConfig(registered=8)))


# ---------------------------------------------------------------------------
# whole runs against the JAX package (float64)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def feds():
    """The JAX federation (sequential backend, x64) and the port's
    (default backend) on its weights and its channels' shared basis."""
    with jax.enable_x64(True):
        jf = JaxFederation(JaxFedConfig(**PARITY_KW), backend="reference")
        ref = np.array(jf._reference_basis())
    pf = Federation(FedConfig(**PARITY_KW), device="cpu")
    params = bridge.params_from_jax_numpy(pf.cfg, _np(jf.frozen),
                                          _np(jf.lora0), device="cpu")
    pf.frozen, pf.lora0 = params["frozen"], params["lora"]
    pf._ref_basis = torch.from_numpy(ref)
    _carry_assignment(jf, pf)
    return jf, pf


def _carry_assignment(jf, pf):
    """Hold the port's groups and trust against the JAX run's, then carry
    the JAX run's divergences and trust into the port (see
    ``tests/test_torch_screening.py``)."""
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


def test_synthesized_data_and_streams_bit_equal_to_jax(feds):
    jf, pf = feds
    pop = PopulationRuntime(pf, PopulationConfig(registered=40,
                                                 data_cache=4))
    jpop = JaxPopulationRuntime(jf, JaxPopulationConfig(registered=40,
                                                        data_cache=4))
    assert pop.adapter_dim == jpop.adapter_dim
    assert pop.data_for(1) is pf.data[1]
    for cid in (20, 39):
        d, jd = pop.data_for(cid), jpop.data_for(cid)
        np.testing.assert_array_equal(d.tokens, jd.tokens)
        np.testing.assert_array_equal(d.labels, jd.labels)
        assert d.tokens.dtype == jd.tokens.dtype
    # streams survive LRU eviction bit-exactly, as the JAX package's do
    it = pop.iter_for(20)
    for _ in range(3):
        next(it)
    for cid in (21, 22, 23, 24, 25):
        next(pop.iter_for(cid))
    assert 20 not in pop._iters and pop.registry.draws[20] == 3
    jit_ = jpop.iter_for(20)
    for _ in range(3):
        next(jit_)
    got, want = next(pop.iter_for(20)), next(jit_)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert pop.slot_weight(0) == jpop.slot_weight(0)


def _pop_churn(mod):
    return mod.make_churn_trace(REGISTERED, 10_000.0, mean_on_s=40.0,
                                mean_off_s=15.0, churn_frac=0.5, seed=6)


def _runtime(run, mod):
    """The run's runtime config and population config from ``mod``
    (either package's topology module)."""
    n = PARITY_KW["n_clients"]
    churn = mod.make_churn_trace(n, 10_000.0, mean_on_s=40.0,
                                 mean_off_s=15.0, churn_frac=0.5, seed=2)
    faults = mod.make_fault_trace(
        n, faulty_frac=0.5, crash_rate=0.1, drop_rate=0.1, dup_rate=0.1,
        corrupt_rate=0.4, corrupt_modes=("signflip", "scale"), seed=3)
    pop = dict(registered=REGISTERED, seed=5)
    if run == "plain":
        return None, pop
    if run == "sync under population churn":
        return dict(policy="sync"), dict(pop, churn=_pop_churn(mod))
    return dict(policy=run.split()[0], churn=churn, faults=faults), pop


RUNS = ["plain", "sync under population churn",
        "deadline under churn and faults", "async under churn and faults"]


@pytest.fixture(scope="module")
def runs(feds, tmp_path_factory):
    """Every run of :data:`RUNS` in both packages; the plain runs write a
    checkpoint a round.  Cohorts are recorded as each round begins."""
    jf, pf = feds
    out = {}
    for run in RUNS:
        jrt, jpop = _runtime(run, jax_topo)
        prt, ppop = _runtime(run, topology)
        jck = pck = None
        if run == "plain":
            d = tmp_path_factory.mktemp("ckpt")
            jck = jax_fedckpt.CheckpointConfig(dir=str(d / "jax"), keep=9)
            pck = CheckpointConfig(dir=str(d / "port"), keep=9)
        jp = JaxPopulationRuntime(jf, JaxPopulationConfig(**jpop))
        pp = PopulationRuntime(pf, PopulationConfig(**ppop))
        cohorts = ([], [])
        for pop, seen in zip((jp, pp), cohorts):
            begin = pop.begin_round
            pop.begin_round = (lambda g, t=None, b=begin, s=seen:
                               s.append(b(g, t=t).tolist()) or s[-1])
        jlog, plog = len(jf.screen_log), len(pf.screen_log)
        with jax.enable_x64(True):
            want = jf.run("elsa", global_rounds=2, steps_per_round=1,
                          runtime=None if jrt is None
                          else JaxRuntimeConfig(**jrt),
                          population=jp, checkpoint=jck)
            want_theta = _np(jf.last_theta)
        got = pf.run("elsa", global_rounds=2, steps_per_round=1,
                     runtime=None if prt is None else RuntimeConfig(**prt),
                     population=pp, checkpoint=pck)
        out[run] = dict(want=want, got=got, jpop=jp, ppop=pp,
                        cohorts=cohorts, want_theta=want_theta,
                        got_theta=pf.last_theta,
                        jreports=jf.screen_log[jlog:],
                        preports=pf.screen_log[plog:], jck=jck, pck=pck)
    return out


def _same_history(got, want):
    assert got["round"] == want["round"] == [0, 1]
    assert got["accuracy"] == want["accuracy"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-8)
    np.testing.assert_allclose(got["delta"], want["delta"], rtol=1e-7)
    assert set(got["client_losses"]) == set(want["client_losses"])
    for c in want["client_losses"]:
        np.testing.assert_allclose(got["client_losses"][c],
                                   want["client_losses"][c], rtol=1e-8)


def _same_registry(reg, jreg):
    for name in INT_COLUMNS:
        np.testing.assert_array_equal(reg.columns[name], jreg.columns[name],
                                      err_msg=name)
    for name in ("trust", "staleness_ema"):
        np.testing.assert_allclose(reg.columns[name], jreg.columns[name],
                                   rtol=0, atol=1e-12, err_msg=name)
    assert reg.allocated_shards == jreg.allocated_shards
    ids = np.flatnonzero(jreg.participations)
    rows, jrows = reg.gather_adapters(ids), jreg.gather_adapters(ids)
    # (a row stays zero where every update of its id was lost)
    assert (np.abs(jrows).max(axis=1) > 0).any()
    # a row is a client's trained LoRA less its dispatch model: it carries
    # the gradients' round-off amplified by the chaotic map, as the final
    # theta does (~4e-7 of the row's scale here), and is held as
    # tests/test_torch_federation.py holds theta
    for r, j in zip(rows, jrows):
        assert np.abs(r - j).max() <= 1e-5 * np.abs(j).max()


@pytest.mark.parametrize("run", RUNS)
def test_population_run_matches_jax_x64(runs, run):
    r = runs[run]
    got, want = r["got"], r["want"]
    assert set(got) == set(want)
    _same_history(got, want)
    if run != "plain":
        assert got["time"] == want["time"]
        assert got["trace"].records == want["trace"].records
    jc, pc = r["cohorts"]
    assert pc == jc and len(pc) >= 2
    assert any(c != list(range(4)) for c in pc)      # identities stream
    if run.startswith("sync"):
        assert len({tuple(c) for c in pc}) == len(pc)
    reg, jreg = r["ppop"].registry, r["jpop"].registry
    _same_registry(reg, jreg)
    judged = reg.screen_passes + reg.screen_fails
    assert judged.sum() > 0
    np.testing.assert_array_equal(r["ppop"].slot_to_id, r["jpop"].slot_to_id)
    assert [(list(map(int, p.clients)), p.verdicts, p.kept, p.fallback)
            for p in r["preports"]] == \
        [(list(map(int, j.clients)), j.verdicts, j.kept, j.fallback)
         for j in r["jreports"]]
    # channels follow identities: the same ids cached in the same LRU
    # order, each with the JAX rotation V_n bit for bit
    assert list(r["ppop"]._channels) == list(r["jpop"]._channels)
    for cid, ch in r["ppop"]._channels.items():
        np.testing.assert_array_equal(
            ch.ssop.v.numpy(), np.asarray(r["jpop"]._channels[cid].ssop.v))
    _, theta = bridge.params_to_jax_numpy({"frozen": {},
                                           "lora": r["got_theta"]})
    for a, b in zip(jax.tree_util.tree_leaves(theta),
                    jax.tree_util.tree_leaves(r["want_theta"])):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


# ---------------------------------------------------------------------------
# population checkpoints
# ---------------------------------------------------------------------------

def _resume(feds, path, pop_kw):
    _, pf = feds
    pop = PopulationRuntime(pf, PopulationConfig(**pop_kw))
    hist = pf.run("elsa", global_rounds=2, steps_per_round=1,
                  population=pop, resume_from=path)
    return hist, pop, pf.last_theta


def test_population_resume_is_bit_identical(feds, runs):
    r = runs["plain"]
    hist, pop, theta = _resume(feds, fedckpt.round_path(r["pck"].dir, 0),
                               _runtime("plain", topology)[1])
    for key in ("round", "accuracy", "loss", "delta", "client_losses"):
        assert hist[key] == r["got"][key], key
    assert tree_equal(theta, r["got_theta"])
    ra, rb = r["ppop"].registry, pop.registry
    for name in ra.columns:
        assert ra.columns[name].tobytes() == rb.columns[name].tobytes()
    assert ra.gather_adapters(np.arange(REGISTERED)).tobytes() \
        == rb.gather_adapters(np.arange(REGISTERED)).tobytes()
    state = fedckpt.load_state(fedckpt.round_path(r["pck"].dir, 0))
    assert state["draws"] == [] and state["channels"] == []
    assert len(state["population"]["channels"]) > 4


def test_population_checkpoints_cross_packages(feds, runs):
    """The port resumes from the JAX package's round-0 file and the JAX
    package from the port's; each finishes as the uninterrupted runs."""
    jf, _ = feds
    r = runs["plain"]
    pop_kw = _runtime("plain", topology)[1]
    hist, pop, theta = _resume(feds, fedckpt.round_path(r["jck"].dir, 0),
                               pop_kw)
    _same_history(hist, r["want"])
    _same_registry(pop.registry, r["jpop"].registry)
    with jax.enable_x64(True):
        jpop = JaxPopulationRuntime(jf, JaxPopulationConfig(**pop_kw))
        jhist = jf.run("elsa", global_rounds=2, steps_per_round=1,
                       population=jpop,
                       resume_from=fedckpt.round_path(r["pck"].dir, 0))
    _same_history(r["got"], jhist)
    _same_registry(r["ppop"].registry, jpop.registry)


def test_population_checkpoint_presence_mismatch(tmp_path):
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    _tiny_history(None, checkpoint=CheckpointConfig(dir=d1, keep=9))
    with pytest.raises(ValueError, match="population"):
        _tiny_history(PopulationConfig(registered=12),
                      resume_from=fedckpt.round_path(d1, 0))
    _tiny_history(PopulationConfig(registered=12, seed=3),
                  checkpoint=CheckpointConfig(dir=d2, keep=9))
    with pytest.raises(ValueError, match="population"):
        _tiny_history(None, resume_from=fedckpt.round_path(d2, 0))
    with pytest.raises(ValueError, match="registered"):
        _tiny_history(PopulationConfig(registered=13, seed=3),
                      resume_from=fedckpt.round_path(d2, 0))
    with pytest.raises(ValueError, match="seed"):
        _tiny_history(PopulationConfig(registered=12, seed=4),
                      resume_from=fedckpt.round_path(d2, 0))
