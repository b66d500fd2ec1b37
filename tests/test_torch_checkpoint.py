"""The port's checkpoints: the JAX package's MessagePack wire format,
written and read without ``msgpack``, and full federation kill-and-resume.

The wire tests mirror ``tests/test_checkpoint.py`` (tuples survive, every
dtype restores bit-exactly, bad files fail with clear ``ValueError``s)
and hold the port's files against the JAX package's across packages:
each package's ``restore`` reads the other's files leaf for leaf, and for
a tree of numpy arrays and primitives the two ``save``s write the same
bytes.  The federation tests hold the headline guarantee in the port: a
plain-loop or sync-runtime run killed at a round boundary and resumed in a
fresh ``Federation`` (and in a fresh process) finishes with a
bit-identical history, event trace, final theta and trust ledger.
"""
import json
import os
import subprocess
import sys

import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

import repro.checkpoint.federation as jax_fedckpt
from repro import checkpoint as jax_ckpt
import repro_torch.checkpoint.federation as fedckpt
from repro_torch.checkpoint import (CheckpointConfig, Checkpointer,
                                    latest_checkpoint, restore, restore_state,
                                    save, save_state, tree_equal, wire)
from repro_torch.federation import FedConfig, Federation
from repro_torch.federation.topology import make_fault_trace
from repro_torch.launch import train
from repro_torch.runtime import RuntimeConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_clients=4, n_edges=2, alpha=5.0, poisoned=(),
             total_examples=200, probe_q=8, local_warmup_steps=1,
             layers=4, t_rounds=1, batch_size=8, seed=0, seq_len=16,
             num_classes=4, use_channel=True, clip_norm=1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch ops on one CPU thread (see
    ``tests/test_torch_federation.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

BOUNDARIES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
              2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
              -2 ** 31, -2 ** 31 - 1, -2 ** 63, 0.0, -0.0, 1.5, 1e300,
              float("inf"), None, True, False, "", "x" * 31, "x" * 32,
              "x" * 255, "x" * 256, "x" * 65536, "é∑ü", b"", b"y" * 255,
              b"y" * 256, b"y" * 65536, [], list(range(15)),
              list(range(16)), list(range(65536)), {},
              {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
              {str(i): [i, {"k": None}] for i in range(65536)},
              np.float64(2.5)]


@pytest.mark.parametrize("obj", BOUNDARIES,
                         ids=lambda o: f"{type(o).__name__}:{repr(o)[:12]}")
def test_codec_bytes_equal_msgpack(obj):
    """Every encoding at its size boundaries: the same bytes as
    ``msgpack.packb(..., use_bin_type=True)``, read back as
    ``msgpack.unpackb`` reads them."""
    data = wire.packb(obj)
    assert data == msgpack.packb(obj, use_bin_type=True)
    assert wire.unpackb(data) == msgpack.unpackb(data, raw=False,
                                                 strict_map_key=False)


def test_codec_reads_float32_and_refuses_bad_input():
    assert wire.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5
    assert wire.unpackb(wire.packb(float("nan"))) != 0.0
    with pytest.raises(ValueError, match="truncated"):
        wire.unpackb(wire.packb([1, 2, "abc"])[:-1])
    with pytest.raises(ValueError, match="extra data"):
        wire.unpackb(wire.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="unsupported"):
        wire.unpackb(msgpack.packb(msgpack.ExtType(1, b"ab")))
    with pytest.raises(OverflowError):
        wire.packb(2 ** 64)
    with pytest.raises(TypeError):
        wire.packb(object())


# ---------------------------------------------------------------------------
# wire format (tests/test_checkpoint.py's cases)
# ---------------------------------------------------------------------------

def test_tuples_survive_roundtrip(tmp_path):
    p = str(tmp_path / "t.msgpack")
    obj = {"rec": (1.5, "arrival", 3, (("late", 0), ("round", 2))),
           "nest": [(1, 2), [3, (4,)]], "empty": ()}
    save(p, obj)
    out = restore(p)
    assert out == obj
    assert isinstance(out["rec"], tuple)
    assert isinstance(out["rec"][3][0], tuple)
    assert isinstance(out["nest"][0], tuple) and out["empty"] == ()
    assert isinstance(out["nest"][1], list)


def _every_dtype():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "f64": rng.standard_normal(5),
        "f16": rng.standard_normal(3).astype(np.float16),
        "i8": np.array([-3, 7], np.int8), "u8": np.arange(4, dtype=np.uint8),
        "i16": np.array([-300], np.int16),
        "i32": np.arange(6, dtype=np.int32),
        "i64": np.arange(4, dtype=np.int64) * 10 ** 12,
        "bool": np.array([True, False, True]),
        "zero_d": np.array(7.25, np.float32), "np_int": np.int64(-9),
        "scalar": 3.25, "none": None, "s": "theta", "flag": True, "n": -5,
    }


def test_every_dtype_restores_bit_exactly(tmp_path):
    p = str(tmp_path / "d.msgpack")
    tree = _every_dtype()
    tree["bf16"] = torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)
    tree["bf16_0d"] = torch.tensor(0.1, dtype=torch.bfloat16)
    tree["tensor"] = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    save(p, tree)
    out = restore(p)
    assert tree_equal(tree, out)
    assert out["f64"].dtype == np.float64 and out["i64"].dtype == np.int64
    assert out["zero_d"].shape == () and out["np_int"].shape == ()
    assert out["bf16"].dtype == torch.bfloat16 and out["bf16"].device.type \
        == "cpu"
    assert torch.equal(out["bf16"], tree["bf16"])
    assert out["bf16_0d"].shape == ()
    assert isinstance(out["tensor"], np.ndarray)   # as the JAX package's
    assert out["scalar"] == 3.25 and out["none"] is None and out["n"] == -5


def test_object_dtype_rejected(tmp_path):
    with pytest.raises(TypeError, match="object-dtype"):
        save(str(tmp_path / "o.msgpack"), {"bad": np.array([{}, {}])})


def test_save_is_atomic_no_partial_file(tmp_path):
    p = str(tmp_path / "sub" / "a.msgpack")
    os.makedirs(os.path.dirname(p))
    with pytest.raises(TypeError):
        save(p, {"bad": object()})
    assert os.listdir(os.path.dirname(p)) == []   # no temp/partial left
    save(p, {"ok": 1})
    assert os.listdir(os.path.dirname(p)) == ["a.msgpack"]


def test_restore_state_validation_errors(tmp_path):
    params = {"w": torch.ones((2, 2))}
    p = str(tmp_path / "s.msgpack")
    save_state(p, params=params, opt_state=None, step=3)
    out = restore_state(p)
    assert out["step"] == 3 and out["opt_state"] is None
    assert tree_equal(out["params"], params)
    raw = open(p, "rb").read()
    t = str(tmp_path / "trunc.msgpack")
    open(t, "wb").write(raw[:len(raw) // 2])
    with pytest.raises(ValueError, match="corrupt or truncated"):
        restore_state(t)
    q = str(tmp_path / "not_state.msgpack")
    save(q, {"just": "data"})
    with pytest.raises(ValueError, match="format"):
        restore_state(q)
    state = restore(p)
    state["__version__"] = 99
    v = str(tmp_path / "vers.msgpack")
    save(v, state)
    with pytest.raises(ValueError, match="version"):
        restore_state(v)
    state = restore(p)
    del state["params"]
    m = str(tmp_path / "miss.msgpack")
    save(m, state)
    with pytest.raises(ValueError, match="params"):
        restore_state(m)


def test_tree_equal_structure_and_bits():
    a = {"x": [np.zeros(2, np.float32), (1, None)], "y": 2.0}
    assert tree_equal(a, {"y": 2.0, "x": [torch.zeros(2), (1, None)]})
    assert not tree_equal(a, {"x": [np.zeros(2, np.float32), [1, None]],
                              "y": 2.0})                      # tuple -> list
    assert not tree_equal(a, {"x": [np.zeros(2), (1, None)], "y": 2.0})
    assert not tree_equal(a, {"x": [np.zeros(2, np.float32), (1, 0)],
                              "y": 2.0})
    assert not tree_equal(a, {"x": [np.zeros(2, np.float32), (1, None)]})
    assert not tree_equal({"w": np.float32(-0.0)}, {"w": np.float32(0.0)})


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

def test_same_bytes_as_the_jax_package(tmp_path):
    """For a tree of numpy arrays and primitives the two packages' files
    are byte for byte the same, and each ``restore`` reads the other's."""
    tree = {"state": _every_dtype(), "hist": {"loss": [1.25, 0.5],
                                              "round": [0, 1]},
            "rec": [(0.5, "dispatch", 2, -1, (("round", 0),))],
            "nested": {"blocks": [{"q_a": np.ones((2, 3), np.float32)}]}}
    mine, theirs = str(tmp_path / "port.msgpack"), \
        str(tmp_path / "jax.msgpack")
    save(mine, tree)
    jax_ckpt.save(theirs, tree)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    assert jax_ckpt.tree_equal(jax_ckpt.restore(mine), tree)
    assert tree_equal(restore(theirs), tree)


def test_bfloat16_and_tensors_cross_packages(tmp_path):
    bits = np.array([1.5, -2.25, 3.0, 1e-3], np.float32)
    port = {"bf16": torch.from_numpy(bits).to(torch.bfloat16),
            "f32": torch.from_numpy(bits)}
    mine, theirs = str(tmp_path / "port.msgpack"), \
        str(tmp_path / "jax.msgpack")
    save(mine, port)
    got = jax_ckpt.restore(mine)
    assert got["bf16"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(got["bf16"].astype(np.float32),
                                  port["bf16"].float().numpy())
    np.testing.assert_array_equal(got["f32"], bits)
    jax_ckpt.save(theirs, {"bf16": bits.astype(ml_dtypes.bfloat16)})
    back = restore(theirs)["bf16"]
    assert back.dtype == torch.bfloat16
    assert torch.equal(back, port["bf16"])
    assert tree_equal(restore(mine), port)


# ---------------------------------------------------------------------------
# rolling federation checkpoints
# ---------------------------------------------------------------------------

def test_checkpointer_rolls_and_prunes(tmp_path):
    d = str(tmp_path)
    ck = Checkpointer(CheckpointConfig(dir=d, every=2, keep=2))
    assert ck.due(0, 9, 1.0, 0.0) and not ck.due(1, 9, 1.0, 0.0)
    assert ck.due(9, 9, 1.0, 0.0)          # final round always snapshots
    assert ck.due(3, 9, 0.0, 0.1)          # convergence stop too
    for g in (0, 2, 4, 6):
        ck.save(g, {"__format__": fedckpt.FORMAT,
                    "__version__": fedckpt.VERSION, "round": g})
    assert sorted(os.listdir(d)) == ["ckpt_round_000004.msgpack",
                                     "ckpt_round_000006.msgpack"]
    assert latest_checkpoint(d).endswith("000006.msgpack")
    assert jax_fedckpt.list_checkpoints(d) == fedckpt.list_checkpoints(d)
    with pytest.raises(ValueError):
        CheckpointConfig(dir=d, every=0)


def test_load_state_rejects_foreign_and_skewed(tmp_path):
    p = str(tmp_path / "x.msgpack")
    save(p, {"no": "marker"})
    with pytest.raises(ValueError, match="format marker"):
        fedckpt.load_state(p)
    save(p, {"__format__": "other-tool", "__version__": 1})
    with pytest.raises(ValueError, match="other-tool"):
        fedckpt.load_state(p)
    save(p, {"__format__": fedckpt.FORMAT, "__version__": 99})
    with pytest.raises(ValueError, match="version"):
        fedckpt.load_state(p)
    save(p, {"__format__": fedckpt.FORMAT,
             "__version__": fedckpt.VERSION, "round": 0})
    with pytest.raises(ValueError, match="missing sections"):
        fedckpt.load_state(p)
    with pytest.raises(ValueError, match="no federation checkpoints"):
        fedckpt.resolve(str(tmp_path))     # x.msgpack is no round file


# ---------------------------------------------------------------------------
# resume = bit-identical continuation
# ---------------------------------------------------------------------------

NAN_FAULTS = dict(faulty_frac=0.25, corrupt_rate=1.0, corrupt_modes=("nan",),
                  seed=11)


def _run(fed_kw, *, runtime=None, rounds=2, **run_kw):
    fed = Federation(FedConfig(**fed_kw), device="cpu")
    h = fed.run("elsa", global_rounds=rounds, steps_per_round=2,
                eval_every=1, runtime=runtime, **run_kw)
    return fed, h


def _same_ledger(a, b):
    for k in ("scores", "passes", "fails"):
        np.testing.assert_array_equal(getattr(a.trust_ledger, k),
                                      getattr(b.trust_ledger, k))


@pytest.mark.parametrize("screen", [False, True])
def test_plain_loop_resume_is_bit_identical(tmp_path, screen):
    d = str(tmp_path / "ck")
    kw = dict(SMALL, screen=screen)
    fed_a, h_a = _run(kw, checkpoint=CheckpointConfig(dir=d, keep=9))
    assert [os.path.basename(p) for p in fedckpt.list_checkpoints(d)] == [
        "ckpt_round_000000.msgpack", "ckpt_round_000001.msgpack"]
    fed_b, h_b = _run(kw, resume_from=fedckpt.round_path(d, 0))
    for key in ("round", "accuracy", "loss", "delta", "client_losses",
                "final_accuracy"):
        assert h_a[key] == h_b[key], key
    assert tree_equal(fed_a.last_theta, fed_b.last_theta)
    _same_ledger(fed_a, fed_b)
    if screen:
        assert len(fed_b.screen_log) == len(fed_a.screen_log) // 2 > 0
    # checkpointing is off the math path
    _, h_c = _run(kw)
    assert h_c["loss"] == h_a["loss"] and h_c["delta"] == h_a["delta"]
    # the restored channels are the live ones, on the device, bit for bit
    for n, ch in fed_a._channels.items():
        assert torch.equal(fed_b._channels[n].ssop.u, ch.ssop.u)
        assert torch.equal(fed_b._channels[n].ssop.v, ch.ssop.v)
        assert fed_b._channels[n].plan is fed_b.plan


def test_sync_runtime_resume_with_screening(tmp_path):
    """The sync policy under the NaN fault trace with screening on: the
    resumed run's history, clock, event trace, theta and trust ledger
    are the uninterrupted run's."""
    d = str(tmp_path / "ck")
    # xi 0: here the first round's delta (2.7e-6) would meet Eq. 16's stop
    kw = dict(SMALL, screen=True, xi=0.0)
    faults = make_fault_trace(SMALL["n_clients"], **NAN_FAULTS)
    fed_a, h_a = _run(kw, rounds=3,
                      runtime=RuntimeConfig("sync", faults=faults),
                      checkpoint=CheckpointConfig(dir=d, keep=9))
    assert h_a["round"] == [0, 1, 2]
    assert "nonfinite" in [v for r in fed_a.screen_log for v in r.verdicts]
    fed_b, h_b = _run(kw, rounds=3,
                      runtime=RuntimeConfig("sync", faults=faults),
                      resume_from=fedckpt.round_path(d, 0))
    for key in ("round", "time", "accuracy", "loss", "delta",
                "client_losses"):
        assert h_a[key] == h_b[key], key
    assert h_a["trace"].records == h_b["trace"].records
    assert tree_equal(fed_a.last_theta, fed_b.last_theta)
    _same_ledger(fed_a, fed_b)
    # resuming a finished run (its directory: the newest snapshot) returns
    # the final state at once
    fed_c, h_c = _run(kw, rounds=3,
                      runtime=RuntimeConfig("sync", faults=faults),
                      resume_from=d)
    assert h_c["accuracy"] == h_a["accuracy"]
    assert tree_equal(fed_c.last_theta, fed_a.last_theta)
    # the JAX package validates the port's federation checkpoint
    state = jax_fedckpt.load_state(fedckpt.round_path(d, 2))
    assert state["round"] == 2 and state["population"] is None
    assert state["trace"] == h_a["trace"].records
    assert state["channels"][0][1]["w"].dtype == np.float32


def test_resume_rejects_drift_and_other_policies(tmp_path):
    d = str(tmp_path / "ck")
    _run(SMALL, rounds=1, checkpoint=CheckpointConfig(dir=d, keep=9))
    path = fedckpt.round_path(d, 0)
    with pytest.raises(ValueError, match="config mismatch"):
        _run(dict(SMALL, lr=0.123), resume_from=path)
    fed = Federation(FedConfig(**SMALL), device="cpu")
    with pytest.raises(ValueError, match="method"):
        fed.run("fedavg", global_rounds=2, steps_per_round=2,
                resume_from=path)
    with pytest.raises(ValueError, match="steps_per_round"):
        fed.run("elsa", global_rounds=2, steps_per_round=3,
                resume_from=path)
    for policy in ("deadline", "async"):
        for kw in (dict(checkpoint=CheckpointConfig(dir=d)),
                   dict(resume_from=path)):
            with pytest.raises(ValueError, match="'sync' runtime policy"):
                fed.run("elsa", global_rounds=2,
                        runtime=RuntimeConfig(policy=policy), **kw)
    state = restore(path)
    state["population"] = {"registered": 8}
    other = str(tmp_path / "pop.msgpack")
    save(other, state)
    with pytest.raises(ValueError, match="population mismatch"):
        fed.run("elsa", global_rounds=2, steps_per_round=2,
                resume_from=other)


_RESUME_CHILD = """
import json, sys
import torch
torch.set_num_threads(1)
from repro_torch.checkpoint import save
from repro_torch.federation import FedConfig, Federation
from repro_torch.runtime import RuntimeConfig

ckpt_path, out_path, kw_json = sys.argv[1], sys.argv[2], sys.argv[3]
kw = json.loads(kw_json)
kw["poisoned"] = tuple(kw["poisoned"])   # json has no tuples
fed = Federation(FedConfig(**kw), device="cpu")
h = fed.run("elsa", global_rounds=2, steps_per_round=2, eval_every=1,
            runtime=RuntimeConfig(policy="sync"), resume_from=ckpt_path)
save(out_path, {"accuracy": h["accuracy"], "time": h["time"],
                "loss": h["loss"], "trace": h["trace"].records,
                "theta": fed.last_theta,
                "scores": fed.trust_ledger.scores})
"""


def test_kill_and_resume_in_fresh_process(tmp_path):
    """Checkpoint mid-training, resume in a FRESH process (nothing shared
    but the checkpoint file), and the final history, event trace, theta
    and ledger match bit for bit."""
    d = str(tmp_path / "ck")
    kw = dict(SMALL, screen=True)
    fed_a, h_a = _run(kw, runtime=RuntimeConfig(policy="sync"),
                      checkpoint=CheckpointConfig(dir=d, keep=9))
    out = str(tmp_path / "resumed.msgpack")
    proc = subprocess.run(
        [sys.executable, "-c", _RESUME_CHILD, fedckpt.round_path(d, 0), out,
         json.dumps(kw)],
        capture_output=True, text=True, timeout=600,
        env={"PYTHONPATH": os.path.join(ROOT, "src"),
             "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = restore(out)
    assert res["accuracy"] == h_a["accuracy"]
    assert res["time"] == h_a["time"]
    assert res["loss"] == h_a["loss"]
    assert list(res["trace"]) == h_a["trace"].records
    assert tree_equal(res["theta"], fed_a.last_theta)
    np.testing.assert_array_equal(res["scores"], fed_a.trust_ledger.scores)


def test_launcher_ckpt_round_trips(tmp_path):
    """``--ckpt`` writes ``save_state(path, params={"lora": lora},
    step=steps)``: the trained tree bit for bit, readable by both
    packages."""
    p = str(tmp_path / "lora.msgpack")
    out = train._main(["--device", "cpu", "--elsa", "--steps", "2",
                       "--batch", "2", "--seq", "16", "--ckpt", p])
    state = restore_state(p)
    assert state["step"] == 2 and state["opt_state"] is None
    assert tree_equal(state["params"]["lora"], out["lora"])
    assert jax_ckpt.restore_state(p)["step"] == 2
