"""The port's batched federation engine (``Federation()``'s default backend)
against the JAX package's batched engine and against the port's own
sequential backend.

Whole runs are held in float64 at lr 1e-4 (``PARITY_KW``, the JAX
package's own engine-parity configuration, ``tests/test_engine.py``):
the split model's gradient map is chaotic, so only x64 and a small lr
keep two implementations' round-off from growing over a run.  Client 0
holds 14 examples, so each of its batches is a ragged one, padded with
zero-weight rows.  The JAX side runs inside ``jax.enable_x64(True)``.
As in ``tests/test_torch_federation.py``, the JAX federation's
per-client channels (their SVD column signs are LAPACK's choice) are
carried into the port before the runs.
"""
import inspect

import jax
import numpy as np
import pytest
import torch

from repro.data import pipeline as jax_pipeline
from repro.federation import engine as jax_engine
from repro.federation.simulation import FedConfig as JaxFedConfig
from repro.federation.simulation import Federation as JaxFederation
from repro.optim import clip_by_global_norm
from repro_torch import bridge
from repro_torch import telemetry as tm
from repro_torch.core.split_training import Channel
from repro_torch.core.ssop import SSOP
from repro_torch.data import pipeline
from repro_torch.data.pipeline import infinite_batches
from repro_torch.federation import FedConfig, Federation, engine
from repro_torch.optim.optimizers import tree_leaves

PARITY_KW = dict(n_clients=6, n_edges=2, alpha=0.2, poisoned=(4,),
                 total_examples=300, probe_q=8, local_warmup_steps=2,
                 lr=1e-4, layers=4, t_rounds=1, batch_size=16,
                 dtype="float64", seed=0)


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


def _port_fed(jf, backend, **overrides):
    """A port federation on the JAX federation's weights and channels."""
    pf = Federation(FedConfig(**{**PARITY_KW, **overrides}), backend=backend,
                    device="cpu")
    params = bridge.params_from_jax_numpy(pf.cfg, _np(jf.frozen),
                                          _np(jf.lora0), device="cpu")
    pf.frozen, pf.lora0 = params["frozen"], params["lora"]
    for n, ch in jf.channels_np.items():
        pf._channels[n] = Channel(SSOP(u=torch.from_numpy(ch[0]),
                                       v=torch.from_numpy(ch[1])), pf.plan)
    return pf


@pytest.fixture(scope="module")
def jax_fed():
    with jax.enable_x64(True):
        jf = JaxFederation(JaxFedConfig(**PARITY_KW), backend="batched")
        chans = {n: jf.channel_for(n, jf.lora0)
                 for n in range(jf.fed.n_clients)}
        jf.channels_np = {n: (np.array(c.ssop.u), np.array(c.ssop.v))
                          for n, c in chans.items()}
    return jf


def _record_groups(fed, store):
    orig = fed._assign_groups

    def wrapped(method, rng):
        out = orig(method, rng)
        store.append(out)
        return out
    fed._assign_groups = wrapped


def _theta_np(lora):
    return bridge.params_to_jax_numpy({"frozen": {}, "lora": lora})[1]


def _max_tree_diff(a, b):
    return max((x - y).abs().max().item()
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_norm", [1e-3, 0.5, 3.0, 1e9])
def test_per_client_clip_is_each_rows_clip_by_global_norm(max_norm):
    """The engine's clip of a stacked gradient tree is the JAX engine's:
    ``clip_by_global_norm`` of each client's row, vmapped over the client
    axis (an all-zero row stays zero, a row under the cap is untouched)."""
    rng = np.random.default_rng(5)
    tree = {"a": rng.normal(size=(4, 6, 3)), "b": {"w": rng.normal(size=(4, 5))}}
    tree["a"][2] = 0.0
    tree["b"]["w"][2] = 0.0
    tree["a"][3] *= 1e-4
    tree["b"]["w"][3] *= 1e-4
    got = engine._clip_rows(jax.tree_util.tree_map(torch.from_numpy, tree),
                            max_norm)
    with jax.enable_x64(True):
        want = _np(jax.vmap(lambda g: clip_by_global_norm(g, max_norm))(
            jax.tree_util.tree_map(jax.numpy.asarray, tree)))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-13, atol=0)
    assert not np.any(jax.tree_util.tree_leaves(got)[0][2].numpy())


def test_padded_batch_stacks_are_bit_equal_to_jax():
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 1000, (37, 12)).astype(np.int64)
    labels = rng.integers(0, 4, 37)
    per_client = []
    for n in range(3):
        it = infinite_batches(tokens[:10 + 9 * n], labels[:10 + 9 * n], 8,
                              seed=n)
        per_client.append([next(it) for _ in range(4)])
    # a ragged tail batch (fewer than 8 rows) is among the draws
    assert any(len(b[0]) < 8 for c in per_client for b in c)
    for t, l in per_client[0]:
        for a, b in zip(pipeline.pad_batch(t, l, 8),
                        jax_pipeline.pad_batch(t, l, 8)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    got = pipeline.stack_padded_batches(per_client, 8)
    want = jax_pipeline.stack_padded_batches(per_client, 8)
    assert [a.shape for a in got] == [(4, 3, 8, 12), (4, 3, 8), (4, 3, 8)]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="same number"):
        pipeline.stack_padded_batches([per_client[0], per_client[1][:3]], 8)


def test_default_backend_matches_jax():
    want = inspect.signature(JaxFederation.__init__).parameters["backend"]
    got = inspect.signature(Federation.__init__).parameters["backend"]
    assert got.default == want.default == "batched"
    assert engine.PROX_MU == jax_engine.PROX_MU


# ---------------------------------------------------------------------------
# whole runs in x64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["elsa", "fedprox"])
def test_batched_run_matches_jax_batched_x64(jax_fed, method):
    """Port-batched against JAX-batched, at the tolerances of
    ``tests/test_torch_federation.py``."""
    pf = _port_fed(jax_fed, "batched")
    jgroups, pgroups = [], []
    _record_groups(jax_fed, jgroups)
    _record_groups(pf, pgroups)
    with jax.enable_x64(True):
        want = jax_fed.run(method, global_rounds=2, steps_per_round=1)
        want_theta = _np(jax_fed.last_theta)
    got = pf.run(method, global_rounds=2, steps_per_round=1)

    (jg, jdiv, jtrust), (pg, pdiv, ptrust) = jgroups[-1], pgroups[-1]
    assert pg == jg
    np.testing.assert_allclose(pdiv, jdiv, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(ptrust, jtrust, rtol=1e-6, atol=1e-12)
    assert got["round"] == want["round"] == [0, 1]
    assert got["accuracy"] == want["accuracy"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-8)
    np.testing.assert_allclose(got["delta"], want["delta"], rtol=1e-7)
    assert got["delta"][0] > 0
    for n in range(pf.fed.n_clients):
        np.testing.assert_allclose(got["client_losses"][n],
                                   want["client_losses"][n], rtol=1e-8)
    for a, b in zip(jax.tree_util.tree_leaves(_theta_np(pf.last_theta)),
                    jax.tree_util.tree_leaves(want_theta)):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


@pytest.mark.parametrize("method", ["elsa", "fedprox"])
def test_batched_run_matches_port_reference_x64(jax_fed, method):
    """Port-batched against the port's sequential backend, at
    ``tests/test_engine.py``'s tolerances (losses 1e-5, theta 1e-4)."""
    fb = _port_fed(jax_fed, "batched")
    fr = _port_fed(jax_fed, "reference")
    hb = fb.run(method, global_rounds=2, steps_per_round=2)
    hr = fr.run(method, global_rounds=2, steps_per_round=2)
    assert abs(hb["final_accuracy"] - hr["final_accuracy"]) <= 1e-4
    for n in range(fb.fed.n_clients):
        a = np.asarray(hb["client_losses"][n])
        b = np.asarray(hr["client_losses"][n])
        assert a.shape == b.shape
        if a.size:
            assert np.abs(a - b).max() <= 1e-5, f"client {n}"
    assert _max_tree_diff(fb.last_theta, fr.last_theta) <= 1e-4


def test_single_step_parity_at_training_lr():
    """One local step at the training lr (FedConfig's 5e-3), every client
    from ``lora0`` on its own split and channel (6 layers: two split
    buckets), with clipping and FedProx: the batched engine's loss to 1e-9
    and implied gradient to 1e-6 of the sequential backend's, both
    federations on the port's own init (the same seed)."""
    kw = dict(PARITY_KW, lr=5e-3, clip_norm=1.0, layers=6)
    fb = Federation(FedConfig(**kw), backend="batched", device="cpu")
    fr = Federation(FedConfig(**kw), backend="reference", device="cpu")
    clients = list(range(fb.fed.n_clients))

    def its(f):
        return {n: infinite_batches(f.data[n].tokens, f.data[n].labels,
                                    f.fed.batch_size, seed=777 + n)
                for n in clients}

    for anchor in (None, fb.lora0):
        rb = fb.group_steps(clients, fb.lora0, 1, its(fb),
                            prox_anchor=anchor)
        rr = fr.group_steps(clients, fr.lora0, 1, its(fr),
                            prox_anchor=anchor)
        assert len({fb.split_for(n) for n in clients}) > 1
        for n in clients:
            (lb, sb), (lr_, sr) = rb[n], rr[n]
            assert abs(sb - sr) <= 1e-9
            assert _max_tree_diff(lb, lr_) / kw["lr"] <= 1e-6
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(fb.lora0),
                                                 tree_leaves(fr.lora0)))


def test_a_client_map_of_one_tree_is_bitwise_the_broadcast_theta():
    """A 9-client cohort (over several split buckets, with clip and
    FedProx) started from a ``{client: tree}`` map of one tree (stacked
    copies) gives every client bitwise what the shared tree (broadcast, a
    view) gives it, and the engine counts the 9 clients."""
    kw = dict(n_clients=10, n_edges=2, alpha=0.5, poisoned=(),
              total_examples=800, probe_q=8, local_warmup_steps=2,
              lr=5e-3, layers=6, t_rounds=1, batch_size=8, seed=0,
              clip_norm=1.0)
    fed = Federation(FedConfig(**kw), device="cpu")
    clients = list(range(9))

    def run(theta):
        iters = {n: infinite_batches(fed.data[n].tokens, fed.data[n].labels,
                                     8, seed=100 + n) for n in clients}
        t = tm.enable()
        try:
            res = fed.group_steps(clients, theta, 2, iters,
                                  prox_anchor=fed.lora0)
        finally:
            tm.disable()
        return res, t

    (res_m, t_m), (res_b, t_b) = (run({n: fed.lora0 for n in clients}),
                                  run(fed.lora0))
    assert len({fed.split_for(n) for n in clients}) > 1
    assert t_m.counter("engine.clients") == t_b.counter("engine.clients") == 9
    for n in clients:
        (lm, l1), (lb, l2) = res_m[n], res_b[n]
        assert l1 == l2
        for a, b in zip(tree_leaves(lm), tree_leaves(lb)):
            assert torch.equal(a, b)


def test_batched_profile_matches_port_reference(jax_fed):
    """The batched warm-up (one engine round) gives the sequential
    backend's warm trees, divergences, trust and clusters."""
    fb = _port_fed(jax_fed, "batched")
    fr = _port_fed(jax_fed, "reference")
    db, tb, cb, wb = fb.profile_clients()
    dr, trr, cr, wr = fr.profile_clients()
    np.testing.assert_allclose(db, dr, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tb, trr, rtol=1e-6, atol=1e-12)
    assert cb.groups == cr.groups
    for n in range(fb.fed.n_clients):
        assert _max_tree_diff(wb[n], wr[n]) <= 1e-12


def test_engine_rejects_a_mesh():
    with pytest.raises(NotImplementedError, match="queue 8"):
        engine.BatchedEngine(None, None, lr=1e-3, batch_size=16,
                             mesh=object(), device="cpu")
