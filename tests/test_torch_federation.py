"""The port's federation (``Federation(..., backend="reference").run``)
against the JAX package's sequential loop, on bridged weights.

Whole runs are held in float64 at lr 1e-4 (the JAX package's own parity
configuration, ``tests/test_engine.py::PARITY_KW``): the split model's
gradient map is chaotic (parameter-Lipschitz ~1e5), so only x64 and a
small lr keep two implementations' round-off from growing over a run.
The reference side runs inside ``jax.enable_x64(True)``.

Both packages take each client's SS-OP basis U from an SVD whose column
signs are LAPACK's choice, so the reference's per-client channels (built
from the same initial LoRA the runs start from) are carried into the
port's before the runs; ``semantic_subspace`` itself is held up to column
signs in ``tests/test_torch_federation_parts.py``.
"""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as jax_restore
from repro.federation.simulation import FedConfig as JaxFedConfig
from repro.federation.simulation import Federation as JaxFederation
from repro_torch import bridge
from repro_torch.core.split_training import Channel
from repro_torch.core.ssop import SSOP
from repro_torch.federation import FedConfig, Federation

ROOT = Path(__file__).resolve().parents[1]
PARITY_KW = dict(n_clients=5, n_edges=2, alpha=0.2, poisoned=(3,),
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


def _record_groups(fed, store):
    """Keep what ``_assign_groups`` returns (the edge groups, the
    divergences and the trust scores) for comparison."""
    orig = fed._assign_groups

    def wrapped(method, rng):
        out = orig(method, rng)
        store.append(out)
        return out
    fed._assign_groups = wrapped


@pytest.fixture(scope="module")
def feds():
    with jax.enable_x64(True):
        jf = JaxFederation(JaxFedConfig(**PARITY_KW), backend="reference")
        jchannels = {n: jf.channel_for(n, jf.lora0)
                     for n in range(jf.fed.n_clients)}
    pf = Federation(FedConfig(**PARITY_KW), backend="reference",
                    device="cpu")
    params = bridge.params_from_jax_numpy(pf.cfg, _np(jf.frozen),
                                          _np(jf.lora0), device="cpu")
    pf.frozen, pf.lora0 = params["frozen"], params["lora"]
    for n, ch in jchannels.items():
        pf._channels[n] = Channel(
            SSOP(u=torch.from_numpy(np.array(ch.ssop.u)),
                 v=torch.from_numpy(np.array(ch.ssop.v))), pf.plan)
    return jf, pf


@pytest.mark.parametrize("method", ["elsa", "fedavg"])
def test_run_matches_jax_x64(feds, method):
    jf, pf = feds
    jgroups, pgroups = [], []
    _record_groups(jf, jgroups)
    _record_groups(pf, pgroups)
    with jax.enable_x64(True):
        want = jf.run(method, global_rounds=2, steps_per_round=1)
        want_theta = _np(jf.last_theta)
    got = pf.run(method, global_rounds=2, steps_per_round=1)

    (jg, jdiv, jtrust), (pg, pdiv, ptrust) = jgroups[-1], pgroups[-1]
    assert pg == jg
    # the divergences are ill-conditioned (KLs of 6e4-1.5e5 from Cholesky
    # solves against a ridge of 1e-3): the warmed-up embeddings' round-off
    # (~1e-13) comes out at ~5e-8; on identical embeddings the packages
    # agree to ~5e-13 (tests/test_torch_federation_parts.py)
    np.testing.assert_allclose(pdiv, jdiv, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(ptrust, jtrust, rtol=1e-6, atol=1e-12)
    if method == "elsa":
        assert len({n for g in pg.values() for n in g}) > 1
    assert got["round"] == want["round"] == [0, 1]
    assert got["accuracy"] == want["accuracy"]
    # round 0's losses agree to ~1e-13; round 1 starts from an aggregate
    # that carries the gradients' round-off amplified by the chaotic map
    # (seen at 1.3e-9 here)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-8)
    # delta is the norm of a round's update (~1e-2 of theta's scale), so
    # it carries the gradients' round-off (~5e-11 of their scale in one
    # step here), and the second round carries it amplified by the
    # chaotic map (~10x a local step at lr 1e-4): ~2e-8 relative
    np.testing.assert_allclose(got["delta"], want["delta"], rtol=1e-7)
    assert got["delta"][0] > 0
    for n in range(pf.fed.n_clients):
        np.testing.assert_allclose(got["client_losses"][n],
                                   want["client_losses"][n], rtol=1e-8)
    # the final theta carries that amplified round-off too (4e-7 of a
    # leaf's scale here; the JAX package holds its own two backends'
    # end-of-run theta to 1e-4, tests/test_engine.py)
    _, theta = bridge.params_to_jax_numpy({"frozen": {},
                                           "lora": pf.last_theta})
    for a, b in zip(jax.tree_util.tree_leaves(theta),
                    jax.tree_util.tree_leaves(want_theta)):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


def test_what_is_not_ported_raises(tmp_path):
    # update screening and checkpoints are ported: FedConfig(screen=True)
    # builds, and run(checkpoint=, resume_from=) works on the plain loop
    # and the sync runtime; a population that is neither config nor
    # runtime raises the JAX package's TypeError; meshes still raise
    assert FedConfig(screen=True).screen
    kw = dict(n_clients=4, n_edges=2, layers=4, total_examples=200,
              probe_q=4)
    # the batched backend and the causal-LM split model are ported now
    assert Federation(FedConfig(**kw), backend="batched",
                      device="cpu").engine.device.type == "cpu"
    with pytest.raises(NotImplementedError, match="queue 8"):
        Federation(FedConfig(**kw), mesh=object(), device="cpu")
    assert Federation(FedConfig(model="llama3-8b", **kw),
                      device="cpu").model.task == "causal-lm"
    fed = Federation(FedConfig(**kw), device="cpu")
    from repro_torch.checkpoint import CheckpointConfig, latest_checkpoint
    from repro_torch.runtime import RuntimeConfig
    for name, runtime in (("plain", None), ("sync", RuntimeConfig("sync"))):
        ck = CheckpointConfig(dir=str(tmp_path / name))
        hist = fed.run("elsa", global_rounds=1, steps_per_round=1,
                       runtime=runtime, checkpoint=ck)
        path = latest_checkpoint(ck.dir)
        assert path.endswith("ckpt_round_000000.msgpack")
        # resuming a finished run returns its history at once
        again = Federation(FedConfig(**kw), device="cpu").run(
            "elsa", global_rounds=1, steps_per_round=1, runtime=runtime,
            resume_from=path)
        assert again["accuracy"] == hist["accuracy"]
        assert again["loss"] == hist["loss"]
        with pytest.raises(TypeError, match="PopulationConfig or "
                                            "PopulationRuntime, got object"):
            fed.run("elsa", global_rounds=1, runtime=runtime,
                    population=object())
    with pytest.raises(ValueError, match="backend"):
        Federation(FedConfig(**kw), backend="eager", device="cpu")


def test_federation_defaults_to_cuda():
    kw = dict(n_clients=4, n_edges=2, layers=4, total_examples=200,
              probe_q=4)
    if torch.cuda.is_available():
        assert Federation(FedConfig(**kw)).lora0["head"]["w"].is_cuda
    else:
        with pytest.raises(RuntimeError):
            Federation(FedConfig(**kw))


def test_example_runs_one_round_on_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" /
                             "torch_elsa_federated_finetune.py"),
         "--device", "cpu", "--rounds", "1", "--steps", "1", "--clients",
         "4", "--edges", "2", "--backend", "reference", "--out",
         str(tmp_path)],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                       "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "phase 1: profiling 4 clients" in out.stdout
    # written by the port's checkpoint.save, read by the JAX package's
    hist = jax_restore(str(tmp_path / "elsa_history.msgpack"))
    assert hist["round"] == [0] and 0.0 <= hist["final_accuracy"] <= 1.0
    assert np.isfinite(hist["loss"]).all()
