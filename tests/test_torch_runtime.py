"""The port's event-driven edge runtime (``Federation.run(...,
runtime=RuntimeConfig(policy=...))``) against the JAX package's, and its
own behaviour (the counterparts of ``tests/test_runtime.py``).

The churn and fault traces, ``corrupt_update``, the Eq. 22–24 constants
and the round costs are numpy and float arithmetic in both packages, so
they must come out bit-equal.  Whole runs are held in float64 at lr 1e-4,
as ``tests/test_torch_federation.py`` holds the round loop (the split
model's gradient map is chaotic, so only x64 and a small lr keep two
implementations' round-off from growing over a run): the simulated clock
and the event trace exactly, accuracy exactly, losses to 1e-8 and deltas
to 1e-7.  The JAX side runs its sequential backend inside
``jax.enable_x64(True)``; the port runs its default, batched backend.  As
there, the JAX federation's weights and per-client channels (their SVD
column signs are LAPACK's choice) are carried into the port.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import comm_model as jax_comm
from repro.federation import topology as jax_topo
from repro.federation.simulation import FedConfig as JaxFedConfig
from repro.federation.simulation import Federation as JaxFederation
from repro.runtime import RuntimeConfig as JaxRuntimeConfig
from repro.runtime.cost import ClientCostModel as JaxCostModel
from repro_torch import bridge
from repro_torch import telemetry as tm
from repro_torch.core import comm_model
from repro_torch.core.split_training import Channel
from repro_torch.core.ssop import SSOP
from repro_torch.federation import FedConfig, Federation, topology
from repro_torch.federation.topology import (always_on, make_churn_trace,
                                             make_fault_trace)
from repro_torch.runtime import EdgeRuntime, RuntimeConfig
from repro_torch.runtime.cost import ClientCostModel
from repro_torch.runtime.events import Event, EventQueue

ROOT = Path(__file__).resolve().parents[1]
# the round loop's parity configuration (tests/test_torch_federation.py)
PARITY_KW = dict(n_clients=5, n_edges=2, alpha=0.2, poisoned=(3,),
                 total_examples=300, probe_q=8, local_warmup_steps=2,
                 lr=1e-4, layers=4, t_rounds=1, batch_size=16,
                 dtype="float64", seed=0)
# tests/test_runtime.py's configuration, for the port's own behaviour
SMALL_KW = dict(n_clients=6, n_edges=2, alpha=0.2, poisoned=(4,),
                total_examples=600, probe_q=8, local_warmup_steps=2,
                lr=2e-2, layers=4, t_rounds=1, batch_size=16, seed=0)


def _churn(n_clients):
    """tests/test_runtime.py's ``_churny_config`` trace."""
    return dict(mean_on_s=40.0, mean_off_s=15.0, churn_frac=0.5, seed=2,
                n_clients=n_clients, horizon_s=10_000.0)


FAULTS = dict(faulty_frac=0.5, crash_rate=0.1, drop_rate=0.1, dup_rate=0.1,
              corrupt_rate=0.1, corrupt_modes=("signflip", "scale"), seed=3)


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


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# churn and fault traces, corrupt_update: bit-equal to the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("kw", [
    dict(n_clients=8, horizon_s=10_000.0, mean_on_s=40.0, mean_off_s=15.0,
         churn_frac=0.5, seed=2),
    dict(n_clients=6, horizon_s=2000.0, mean_on_s=20.0, mean_off_s=10.0,
         churn_frac=1.0, seed=2),
    dict(n_clients=6, horizon_s=500.0, churn_frac=0.0, seed=2),
    dict(n_clients=20, horizon_s=3000.0, mean_on_s=5.0, mean_off_s=50.0,
         churn_frac=0.3, seed=11)])
def test_churn_trace_is_bit_equal(kw, version):
    kw = dict(kw)
    n, horizon = kw.pop("n_clients"), kw.pop("horizon_s")
    got = make_churn_trace(n, horizon, version=version, **kw)
    want = jax_topo.make_churn_trace(n, horizon, version=version, **kw)
    assert got.horizon_s == want.horizon_s
    assert len(got.offline) == len(want.offline) == n
    for a, b in zip(got.offline, want.offline):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # the queries, over times inside, between and at the intervals' ends
    ts = sorted({0.0, horizon, 2 * horizon} | {
        float(x) for iv in want.offline for x in iv.ravel()[:40]}
        | set(np.linspace(0.0, 1.2 * horizon, 37).tolist()))
    for c in range(n):
        for t in ts:
            assert got.is_online(c, t) == want.is_online(c, t)
            assert got.next_online(c, t) == want.next_online(c, t)
            for work in (0.0, 3.5, 120.0):
                assert got.finish_time(c, t, work) \
                    == want.finish_time(c, t, work)


def test_churn_queries_at_the_boundaries():
    """tests/test_runtime.py's half-open and beyond-the-horizon cases, on
    both packages' traces."""
    for mod in (topology, jax_topo):
        tr = mod.ChurnTrace([np.array([[5.0, 8.0], [20.0, 25.0]])], 100.0)
        assert tr.is_online(0, 4.9) and not tr.is_online(0, 5.0)
        assert tr.next_online(0, 6.0) == 8.0
        assert tr.finish_time(0, 3.0, 4.0) == pytest.approx(10.0)
        assert tr.finish_time(0, 6.0, 1.0) == pytest.approx(9.0)
        assert tr.finish_time(0, 3.0, 20.0) == pytest.approx(31.0)
        # [start, end): the start inclusive, the end (== horizon) exclusive
        tr = mod.ChurnTrace([np.array([[5.0, 10.0]])], horizon_s=10.0)
        assert tr.is_online(0, 4.999999) and not tr.is_online(0, 5.0)
        assert not tr.is_online(0, 9.999999) and tr.is_online(0, 10.0)
        assert tr.next_online(0, 5.0) == 10.0
        assert tr.next_online(0, 10.0) == 10.0
        assert tr.finish_time(0, 5.0, 1.0) == pytest.approx(11.0)
        # an outage straddling the horizon keeps pausing work past it
        tr = mod.ChurnTrace([np.array([[8.0, 15.0]])], horizon_s=10.0)
        assert not tr.is_online(0, 12.0) and tr.next_online(0, 12.0) == 15.0
        assert tr.finish_time(0, 7.0, 2.0) == pytest.approx(16.0)
        # every interval exhausted: always on
        tr = mod.ChurnTrace([np.array([[0.0, 30.0]]),
                             np.array([[0.0, 40.0]])], horizon_s=30.0)
        assert not tr.is_online(0, 10.0) and not tr.is_online(1, 10.0)
        assert tr.next_online(0, 10.0) == 30.0
        assert tr.next_online(1, 35.0) == 40.0
        assert tr.is_online(0, 50.0) and tr.is_online(1, 50.0)
        assert tr.finish_time(0, 50.0, 3.0) == pytest.approx(53.0)
        assert tr.finish_time(1, 0.0, 2.0) == pytest.approx(42.0)
    on = always_on(8)
    assert on.is_online(3, 1e9) and on.finish_time(3, 2.0, 5.0) == 7.0


@pytest.mark.parametrize("kw", [
    dict(n_clients=8, **FAULTS),
    dict(n_clients=12, faulty_frac=1.0, crash_rate=0.25, drop_rate=0.05,
         dup_rate=0.2, corrupt_rate=0.4, seed=9),
    dict(n_clients=5, faulty_frac=0.4,
         corrupt_rate=1.0, corrupt_modes=("nan", "inf", "signflip", "scale"),
         corrupt_scale=3.0, seed=0)])
def test_fault_trace_is_bit_equal(kw):
    kw = dict(kw)
    n = kw.pop("n_clients")
    got = make_fault_trace(n, **kw)
    want = jax_topo.make_fault_trace(n, **kw)
    assert got.faulty == want.faulty
    assert topology.CORRUPT_MODES == jax_topo.CORRUPT_MODES
    assert topology.FAULT_KINDS == jax_topo.FAULT_KINDS
    kinds = set()
    for c in range(n):
        for i in range(60):
            a, b = got.sample(c, i), want.sample(c, i)
            assert (a is None) == (b is None), (c, i)
            if a is not None:
                assert dataclasses.astuple(a) == dataclasses.astuple(b)
                kinds.add(a.kind)
    assert kinds
    with pytest.raises(ValueError, match="sum <= 1"):
        topology.FaultTrace(4, crash_rate=0.7, drop_rate=0.7)
    with pytest.raises(ValueError, match="unknown corrupt modes"):
        topology.FaultTrace(4, corrupt_modes=("zero",))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mode", ["nan", "inf", "signflip", "scale"])
def test_corrupt_update_is_bit_equal(mode, dtype):
    rng = np.random.default_rng(4)
    shapes = {"blocks": {"q_a": (3, 12, 4), "q_b": (3, 4, 12)},
              "head": {"b": (5,), "w": (12, 5)}}
    base, upd = ({k: {kk: rng.normal(size=s).astype(dtype)
                      for kk, s in v.items()} for k, v in shapes.items()}
                 for _ in range(2))
    fault = topology.Fault("corrupt", mode=mode, scale=7.5)
    got = topology.corrupt_update(
        jax.tree_util.tree_map(torch.from_numpy, base),
        jax.tree_util.tree_map(torch.from_numpy, upd), fault)
    with jax.enable_x64(True):
        want = _np(jax_topo.corrupt_update(
            jax.tree_util.tree_map(jnp.asarray, base),
            jax.tree_util.tree_map(jnp.asarray, upd),
            jax_topo.Fault("corrupt", mode=mode, scale=7.5)))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert a.numpy().dtype == b.dtype == dtype
        np.testing.assert_array_equal(a.numpy(), b)
    with pytest.raises(ValueError, match="not a corrupt fault"):
        topology.corrupt_update(base, upd, topology.Fault("crash"))


@pytest.mark.parametrize("mode", ["factor", "product"])
def test_mix_adapters_matches_jax_x64(mode):
    """The async fold ``(1-w)·θ + w·update`` on a bert LoRA tree and a
    perturbed copy, against the JAX package's, to round-off."""
    from repro.core import aggregation as jax_agg
    from repro.models.params import init_tree as jax_init_tree
    from repro.models.split_api import get_split_model as jax_split_model
    from repro_torch.core import aggregation as agg
    with jax.enable_x64(True):
        model = jax_split_model("bert-base", num_layers=4, dtype="float64")
        tree = jax_init_tree(model.specs(4), jax.random.PRNGKey(1),
                             jnp.float64)
        frozen, lora = _np(tree["frozen"]), tree["lora"]
        rng = np.random.default_rng(2)
        theta = jax.tree_util.tree_map(
            lambda x: x + 0.01 * rng.normal(size=x.shape), lora)
        update = jax.tree_util.tree_map(
            lambda x: x + 0.05 * rng.normal(size=x.shape), theta)
        want = [_np(jax_agg.mix_adapters(theta, update, w, mode=mode))
                for w in (0.6, 0.1 / 3)]
    port = [bridge.params_from_jax_numpy(model.cfg, frozen, _np(t),
                                         device="cpu")["lora"]
            for t in (theta, update)]
    for w, wt in zip((0.6, 0.1 / 3), want):
        got = bridge.params_to_jax_numpy(
            {"frozen": {}, "lora": agg.mix_adapters(*port, w, mode=mode)})[1]
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(wt)):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-14 * np.abs(b).max())


# ---------------------------------------------------------------------------
# the event queue and the client states
# ---------------------------------------------------------------------------

def test_event_queue_deterministic_fifo_ties():
    q = EventQueue()
    q.push(Event(2.0, "b", client=1))
    q.push(Event(1.0, "a", client=2))
    q.push(Event(1.0, "a", client=3))     # same time: FIFO, not client order
    assert q.peek().client == 2 and len(q) == 3
    assert [e.client for e in q.drain_until(1.0)] == [2, 3]
    assert q.pop().client == 1
    assert not q


def test_client_state_transitions_are_asserted():
    from repro_torch.runtime.client import ClientRuntimeState
    s = ClientRuntimeState(3)
    s.dispatch(1.0, 4.0, version=2, round_idx=0)
    with pytest.raises(AssertionError, match="dispatch while training"):
        s.dispatch(2.0, 5.0, 2, 0)
    s.crash()
    assert s.idle and s.dispatches == 1 and s.rounds_run == 0
    s.dispatch(5.0, 9.0, 3, 1)
    with pytest.raises(AssertionError, match="collect while training"):
        s.collect()
    s.complete(("lora", 0.5))
    assert s.collect() == ("lora", 0.5) and s.idle
    assert s.staleness(7) == 4 and s.staleness(1) == 0
    assert (s.dispatches, s.rounds_run) == (2, 1)


# ---------------------------------------------------------------------------
# the federations: the Eq. 22-24 constants and the round costs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def feds():
    """A JAX federation (sequential backend, x64) and the port's on its
    weights and channels."""
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
    return jf, pf


def test_comm_config_and_volumes_are_equal(feds):
    jf, pf = feds
    assert np.array_equal(pf.topo.bandwidth, jf.topo.bandwidth)
    with jax.enable_x64(True):
        for plan_j, plan_p, lora_j, lora_p in (
                (jf.plan, pf.plan, jf.lora0, pf.lora0),
                (None, None, None, None)):      # Spec leaves, no sketch
            want = jax_comm.comm_config_from(jf.cfg, jf.fed, plan_j,
                                             lora=lora_j)
            got = comm_model.comm_config_from(pf.cfg, pf.fed, plan_p,
                                              lora=lora_p)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
            for seq_len, num_classes in ((64, None), (None, 7)):
                assert dataclasses.astuple(comm_model.comm_config_from(
                    pf.cfg, pf.fed, plan_p, seq_len=seq_len,
                    num_classes=num_classes)) == dataclasses.astuple(
                    jax_comm.comm_config_from(
                        jf.cfg, jf.fed, plan_j, seq_len=seq_len,
                        num_classes=num_classes))
            per_edge = {0: [16.0, 8.0, 16.0], 1: [16.0, 3.0]}
            assert comm_model.round_volume_bytes(got, per_edge, 2) \
                == jax_comm.round_volume_bytes(want, per_edge, 2)
            bws = list(pf.topo.bandwidth)
            for b, bw in zip((16.0, 3.0, 64.0, 1.0, 16.0), bws):
                assert comm_model.client_comm_time(got, b, bw) \
                    == jax_comm.client_comm_time(want, b, bw)
            assert comm_model.total_comm_time(got, [16.0] * 5, bws, 3) \
                == jax_comm.total_comm_time(want, [16.0] * 5, bws, 3)
    assert got.rho == 1.0 and want.lora_bytes > 0


@pytest.mark.parametrize("jitter", [0.0, 0.3])
def test_round_costs_are_equal(feds, jitter):
    """``ClientCostModel.round_cost`` for every client on every split the
    federation assigns (and the default split), at each edge and the
    nearest, and ``estimate_population``: the same floats."""
    jf, pf = feds
    with jax.enable_x64(True):
        cj = jax_comm.comm_config_from(jf.cfg, jf.fed, jf.plan,
                                       lora=jf.lora0)
        want = JaxCostModel(jf.cfg, jf.topo, cj, batch_size=16,
                            num_classes=4, jitter_sigma=jitter, seed=5)
    cp = comm_model.comm_config_from(pf.cfg, pf.fed, pf.plan, lora=pf.lora0)
    got = ClientCostModel(pf.cfg, pf.topo, cp, batch_size=16, num_classes=4,
                          jitter_sigma=jitter, seed=5)
    assert (got.block_params, got.head_params) \
        == (want.block_params, want.head_params)
    n_clients = pf.fed.n_clients
    for use_split in (True, False):
        splits_p = {n: pf.split_for(n, use_split) for n in range(n_clients)}
        splits_j = {n: jf.split_for(n, use_split) for n in range(n_clients)}
        assert {n: (s.p, s.q, s.o) for n, s in splits_p.items()} \
            == {n: (s.p, s.q, s.o) for n, s in splits_j.items()}
        for n in range(n_clients):
            for edge in (None, 0, 1, -1):
                for steps, r in ((1, 0), (4, 3)):
                    a = got.round_cost(n, splits_p[n], steps, edge, r)
                    b = want.round_cost(n, splits_j[n], steps, edge, r)
                    assert dataclasses.astuple(a) == dataclasses.astuple(b)
                    assert a.total_s == b.total_s
        edge_of = {n: n % 2 for n in range(n_clients)}
        for eo in (None, edge_of):
            assert got.estimate_population(splits_p, 2, eo) \
                == want.estimate_population(splits_j, 2, eo)


# ---------------------------------------------------------------------------
# whole runs in x64 against the JAX package
# ---------------------------------------------------------------------------

def _runtime_kw(policy, n_clients, jax_side):
    if policy == "sync":
        return dict(policy="sync")
    mod = jax_topo if jax_side else topology
    policy = policy.removesuffix(" under churn and faults")
    return dict(policy=policy,
                churn=mod.make_churn_trace(**_churn(n_clients)),
                faults=mod.make_fault_trace(n_clients, **FAULTS))


@pytest.mark.parametrize("policy", ["sync", "sync under churn and faults",
                                    "deadline", "async"])
def test_runtime_matches_jax_x64(feds, policy):
    jf, pf = feds
    n = pf.fed.n_clients
    with jax.enable_x64(True):
        want = jf.run("elsa", global_rounds=2, steps_per_round=1,
                      runtime=JaxRuntimeConfig(**_runtime_kw(policy, n,
                                                             True)))
    got = pf.run("elsa", global_rounds=2, steps_per_round=1,
                 runtime=RuntimeConfig(**_runtime_kw(policy, n, False)))
    assert got["policy"] == want["policy"] == policy.split()[0]
    assert set(got) == set(want)
    # async meets Eq. 16's stopping rule after its first fusion here, in
    # both packages (its first window folds 2 of 8 dispatches)
    assert got["round"] == want["round"] == ([0] if policy == "async"
                                             else [0, 1])
    assert got["time"] == want["time"]
    assert got["accuracy"] == want["accuracy"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-8)
    np.testing.assert_allclose(got["delta"], want["delta"], rtol=1e-7)
    for c in range(n):
        np.testing.assert_allclose(got["client_losses"][c],
                                   want["client_losses"][c], rtol=1e-8)
    assert len(got["trace"]) == len(want["trace"]) > 0
    for a, b in zip(got["trace"].records, want["trace"].records):
        assert a == b
    assert got["trace"].summary() == want["trace"].summary()
    if policy != "sync":
        kinds = got["trace"].summary()
        assert {"crash", "drop", "dup", "corrupt"} & set(kinds), kinds


# ---------------------------------------------------------------------------
# the port's own behaviour (tests/test_runtime.py's counterparts)
# ---------------------------------------------------------------------------

def test_sync_policy_reproduces_run_history():
    """policy='sync' with no churn is ``run()`` bit for bit, and gains a
    strictly increasing simulated clock."""
    h_ref = Federation(FedConfig(**SMALL_KW), device="cpu").run(
        "elsa", global_rounds=2, steps_per_round=2)
    h_sync = Federation(FedConfig(**SMALL_KW), device="cpu").run(
        "elsa", global_rounds=2, steps_per_round=2,
        runtime=RuntimeConfig(policy="sync"))
    for key in ("accuracy", "loss", "delta", "round", "final_accuracy"):
        assert h_sync[key] == h_ref[key], key
    for n in range(SMALL_KW["n_clients"]):
        assert h_sync["client_losses"][n] == h_ref["client_losses"][n]
    t = h_sync["time"]
    assert len(t) == len(h_sync["round"]) and all(
        b > a for a, b in zip(t, t[1:]))
    assert h_sync["policy"] == "sync"


def _churny_kw():
    return dict(SMALL_KW, constrained_frac=0.34, seed=1)


@pytest.fixture(scope="module")
def churny_runs():
    """Two same-seed ``fedavg`` runs of each non-sync policy under churn,
    on fresh federations, the second with telemetry on."""
    kw = _churny_kw()
    churn = make_churn_trace(**_churn(kw["n_clients"]))
    runs = {}
    for policy in ("deadline", "async"):
        hs = []
        for i in range(2):
            fed = Federation(FedConfig(**kw), device="cpu")
            tel = tm.enable() if i else None
            try:
                hs.append(fed.run("fedavg", global_rounds=2,
                                  steps_per_round=2,
                                  runtime=RuntimeConfig(policy=policy,
                                                        churn=churn)))
            finally:
                tm.disable()
        runs[policy] = hs, tel
    return runs


@pytest.mark.parametrize("policy", ["deadline", "async"])
def test_runtime_deterministic_same_seed(churny_runs, policy):
    """Same seed and config: identical event trace, clock, losses and
    accuracy; the trace's events reach telemetry."""
    (a, b), tel = churny_runs[policy]
    assert a["trace"] == b["trace"] and len(a["trace"]) > 0
    assert a["final_accuracy"] == b["final_accuracy"]
    assert a["time"] == b["time"]
    assert a["loss"] == b["loss"]
    for kind, count in b["trace"].summary().items():
        assert tel.counter("runtime.events", kind=kind) == count
    assert [(r["round"], r["sim_time_s"]) for r in tel.rounds] \
        == [(0, b["time"][0]), (1, b["time"][1])]
    assert tel.counter("runtime.sim.compute_s") > 0


def test_deadline_and_async_structure_under_churn(churny_runs):
    (h_d, _), _ = churny_runs["deadline"]
    tr = h_d["trace"]
    assert tr.count("edge_agg") >= 2          # every edge round aggregated
    assert all(np.isfinite(h_d["accuracy"]))
    assert h_d["time"] == sorted(h_d["time"])
    for rec in tr.of_kind("edge_agg"):        # each folded an update
        assert dict(rec[4])["n_updates"] >= 1

    (h_a, _), _ = churny_runs["async"]
    tra = h_a["trace"]
    assert tra.count("cloud_agg") == 2
    for rec in tra.of_kind("arrival"):
        info = dict(rec[4])
        assert info["staleness"] >= 0 and 0 < info["weight"] <= 1
    assert np.isfinite(h_a["final_accuracy"])


def test_async_fedavg_random_subsamples_cohort():
    """fedavg-random under the async policy samples half the membership
    per cloud-fusion window, and only the sampled cohort is
    dispatched."""
    fed = Federation(FedConfig(**SMALL_KW), device="cpu")
    # homogeneous devices and a cloud period above the round time, so
    # every window folds its cohort's arrivals
    fed.topo.capacity[:] = 1e10
    fed.topo.bandwidth[:] = 1e7
    est = EdgeRuntime(fed).cost.estimate_population(
        {n: fed.split_for(n) for n in range(SMALL_KW["n_clients"])}, 2)
    h = fed.run("fedavg-random", global_rounds=2, steps_per_round=2,
                runtime=RuntimeConfig(policy="async",
                                      cloud_period_s=1.5 * max(est.values())))
    tr = h["trace"]
    agg_times = [r[0] for r in tr.of_kind("cloud_agg")]
    assert len(agg_times) == 2
    n, half = SMALL_KW["n_clients"], max(1, SMALL_KW["n_clients"] // 2)
    windows = [(0.0, agg_times[0]), (agg_times[0], agg_times[1])]
    for lo, hi in windows:
        dispatched = {r[2] for r in tr.of_kind("dispatch")
                      if lo <= r[0] < hi}
        assert len(dispatched) == half < n, (lo, hi, dispatched)
    assert np.isfinite(h["final_accuracy"])


def test_async_full_methods_still_dispatch_everyone():
    """Non-subsampling methods keep full participation under async."""
    fed = Federation(FedConfig(**SMALL_KW), device="cpu")
    h = fed.run("fedavg", global_rounds=1, steps_per_round=2,
                runtime=RuntimeConfig(policy="async"))
    tr = h["trace"]
    first_agg = tr.of_kind("cloud_agg")[0][0]
    dispatched = {r[2] for r in tr.of_kind("dispatch") if r[0] < first_agg}
    assert dispatched == set(range(SMALL_KW["n_clients"]))


def test_runtime_config_and_what_is_not_ported(tmp_path):
    with pytest.raises(ValueError, match="unknown runtime policy"):
        RuntimeConfig(policy="eager")
    kw = dict(n_clients=4, n_edges=2, layers=4, total_examples=200,
              probe_q=4)
    fed = Federation(FedConfig(**kw), device="cpu")
    rt = EdgeRuntime(fed, RuntimeConfig(policy="deadline"))
    assert rt.comm.lora_bytes == comm_model.lora_tree_bytes(fed.lora0) > 0
    assert rt.backhaul_s == rt.comm.lora_bytes / 1.25e9
    for policy in ("deadline", "async"):
        for opt in ("checkpoint", "resume_from"):
            with pytest.raises(ValueError,
                               match="'sync' runtime policy only"):
                fed.run("elsa", global_rounds=1,
                        runtime=RuntimeConfig(policy=policy),
                        **{opt: object()})
    # the sync policy checkpoints and resumes: a fresh federation resumed
    # from round 0 runs round 1 as the uninterrupted run did
    from repro_torch.checkpoint import CheckpointConfig
    from repro_torch.checkpoint.federation import round_path
    with pytest.raises(ValueError, match="no federation checkpoints"):
        fed.run("elsa", global_rounds=1, runtime=RuntimeConfig(),
                resume_from=str(tmp_path))
    hist = fed.run("elsa", global_rounds=2, steps_per_round=1,
                   runtime=RuntimeConfig(),
                   checkpoint=CheckpointConfig(dir=str(tmp_path)))
    resumed = Federation(FedConfig(**kw), device="cpu").run(
        "elsa", global_rounds=2, steps_per_round=1, runtime=RuntimeConfig(),
        resume_from=round_path(str(tmp_path), 0))
    for key in ("round", "time", "accuracy", "loss", "delta"):
        assert resumed[key] == hist[key], key
    assert resumed["trace"] == hist["trace"]
    with pytest.raises(TypeError, match="PopulationConfig or "
                                        "PopulationRuntime, got object"):
        fed.run("elsa", global_rounds=1,
                runtime=RuntimeConfig(policy="async"), population=object())
    assert fed._population is None


def test_example_runs_every_policy_on_cpu():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" /
                             "torch_async_edge_runtime.py"),
         "--device", "cpu", "--policy", "all", "--rounds", "1",
         "--steps", "1", "--clients", "4", "--churn"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                       "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    for policy in ("sync", "deadline", "async"):
        assert f"== {policy} ==" in out.stdout
    assert "time to training loss" in out.stdout
