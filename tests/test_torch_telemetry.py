"""The port's telemetry (``repro_torch.telemetry``: round records, JSONL
export, sinks, sessions) and its report
(``repro_torch.analysis.telemetry_report``) against the JAX package's.

- The cases of ``tests/test_telemetry.py`` run on both collectors with the
  same calls, and their states must be equal (apart from wall times).
- A JSONL file written by either package reads the same through either
  package's ``read_jsonl``.
- Sinks rotate into parts that parse alone; ``retain_rounds`` bounds
  memory, not the disk; sessions nest.
- An enabled run of the port is bit-inert, and its ``runtime.events``
  counters equal the event trace's counts.
- The report renders the committed example file to the JAX report's text
  exactly.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro import telemetry as jtm
from repro.analysis import telemetry_report as jax_report
from repro_torch import telemetry as tm
from repro_torch.analysis import telemetry_report
from repro_torch.federation import FedConfig, Federation
from repro_torch.federation.topology import (make_churn_trace,
                                             make_fault_trace)
from repro_torch.runtime import RuntimeConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "tests", "data", "telemetry_example.jsonl")
SMALL_KW = dict(n_clients=6, n_edges=2, alpha=0.2, poisoned=(4,),
                total_examples=600, probe_q=8, local_warmup_steps=2,
                lr=2e-2, layers=4, t_rounds=1, batch_size=16, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch ops on one CPU thread (see
    ``tests/test_torch_federation.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _telemetry_off():
    """No enabled collector leaks between tests, in either package."""
    tm.disable()
    jtm.disable()
    yield
    tm.disable()
    jtm.disable()


def _no_walls(obj):
    """A record (or parsed file) with its wall-clock fields zeroed."""
    if isinstance(obj, dict):
        return {k: (0.0 if k in ("dur_s", "wall_s") else _no_walls(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_no_walls(v) for v in obj]
    return obj


def _drive(mod, tel):
    """The same calls on either package's collector: counters, gauges,
    histograms, spans (timed and simulated), rounds and a trailing
    partial round."""
    tel.inc("c", 2, kind="x")
    tel.inc("c", 3, kind="x")
    tel.inc("c", 1, kind="y")
    tel.set_gauge("g", 1.0)
    tel.set_gauge("g", 7.0)
    tel.observe("h", 0.002)
    tel.observe("h", 50.0)
    tel.observe("b", 2.0, buckets=(1.0, 4.0), edge=1)
    tel.end_round(0)
    tel.inc("c", 2, kind="x")
    with tel.span("uplink", edge=1) as sp:
        sp.set(sim_s=3.0)
    tel.record_span("cloud_agg", dur_s=0.5, sim_s=2.0, n_edges=2)
    tel.end_round(1, sim_time_s=10.0)
    tel.inc("tail", 1)


def _state(tel, summarize):
    return _no_walls({"counters": tel.counters, "gauges": tel.gauges,
                      "histograms": {k: h.state()
                                     for k, h in tel.histograms.items()},
                      "rounds": tel.rounds, "summary": summarize(tel)})


def test_collectors_agree_with_jax():
    tel, jtel = tm.Telemetry({"m": 1}), jtm.Telemetry({"m": 1})
    _drive(tm, tel)
    _drive(jtm, jtel)
    assert _state(tel, tm.summarize) == _state(jtel, jtm.summarize)
    assert tel.counter("c", kind="x") == 7
    assert tel.counters_by_name("c") == {"c{kind=x}": 7.0,
                                         "c{kind=y}": 1.0}
    assert tel.gauge("g") == 7.0
    h = tel.histograms["h"]
    assert h.count == 2 and h.max == 50.0 and h.counts[-1] == 1
    r0, r1 = tel.rounds
    assert r0["counters"] == {"c{kind=x}": 5.0, "c{kind=y}": 1.0}
    assert r1["counters"] == {"c{kind=x}": 2.0}
    assert r1["sim_time_s"] == 10.0 and "sim_time_s" not in r0
    assert r1["spans"][0]["name"] == "uplink"
    assert r1["spans"][0]["attrs"] == {"edge": 1, "sim_s": 3.0}
    tel.flush_pending()
    jtel.flush_pending()
    assert _state(tel, tm.summarize) == _state(jtel, jtm.summarize)
    assert tel.rounds[-1]["round"] is None
    assert tel.rounds[-1]["counters"] == {"tail": 1.0}
    assert tm.SCHEMA_VERSION == jtm.SCHEMA_VERSION
    assert tm.DEFAULT_TIME_BUCKETS == jtm.DEFAULT_TIME_BUCKETS
    assert tm.flat_key("a", {}) == jtm.flat_key("a", {}) == "a"
    assert tm.flat_key("a", {"b": 1, "a": 2}) == "a{a=2,b=1}"
    for mod in (tm, jtm):
        with pytest.raises(ValueError):
            mod.Histogram((1.0, 0.5))
        with pytest.raises(ValueError):
            mod.Telemetry(retain_rounds=-1)


def test_disabled_module_helpers_are_noops():
    assert not tm.enabled() and tm.get() is None
    tm.inc("c")
    tm.set_gauge("g", 1.0)
    tm.observe("h", 1.0)
    tm.record_span("x", dur_s=1.0)
    tm.end_round(0)
    assert tm.export("/nonexistent/should-not-write") is None
    assert tm.summary() is None
    sp = tm.span("x")
    assert isinstance(sp, tm.NullSpan) and sp is tm.span("y")
    with sp as s:
        s.set(anything=1)


def test_session_nests_and_restores():
    outer = tm.enable({"level": "outer"})
    with tm.session({"level": "inner"}) as inner:
        assert tm.get() is inner
        tm.inc("c")
        with tm.session() as innermost:
            tm.inc("c", 5)
        assert tm.get() is inner
    assert tm.get() is outer
    assert inner.counter("c") == 1 and innermost.counter("c") == 5
    assert outer.counter("c") == 0
    tm.disable()
    assert tm.get() is None


def test_jsonl_files_cross_packages(tmp_path):
    """Each package exports the same calls; each file reads the same
    through both readers, and the two files agree apart from wall
    times.  A killed run (no summary line) is rebuilt alike too."""
    ours, theirs = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    with tm.session({"m": 1}, jsonl=ours) as tel:
        _drive(tm, tel)
    with jtm.session({"m": 1}, jsonl=theirs) as jtel:
        _drive(jtm, jtel)
    parsed = {(f, r): reader(f) for f in (ours, theirs)
              for r, reader in (("port", tm.read_jsonl),
                                ("jax", jtm.read_jsonl))}
    assert parsed[(ours, "port")] == parsed[(ours, "jax")]
    assert parsed[(theirs, "port")] == parsed[(theirs, "jax")]
    assert _no_walls(parsed[(ours, "port")]) \
        == _no_walls(parsed[(theirs, "port")])
    d = parsed[(ours, "port")]
    assert d["meta"]["meta"] == {"m": 1}
    assert [r["round"] for r in d["rounds"]] == [0, 1, None]
    assert d["summary"]["spans"]["cloud_agg"] == {"count": 1, "wall_s": 0.5,
                                                  "sim_s": 2.0}
    for path in (ours, theirs):
        lines = open(path).read().strip().split("\n")
        cut = str(tmp_path / "cut.jsonl")
        with open(cut, "w") as f:
            f.write("\n".join(lines[:-1]) + "\n")
        a, b = tm.read_jsonl(cut), jtm.read_jsonl(cut)
        assert a == b
        assert a["summary"]["counters"] == d["summary"]["counters"]


def _fill(tel, rounds, spans_per_round=2, start=0):
    for g in range(start, start + rounds):
        tel.inc("x.events", 3)
        for s in range(spans_per_round):
            tel.record_span("phase", dur_s=0.01, idx=s)
        tel.end_round(g)


def test_jsonl_sink_streams_and_rotates_like_jax(tmp_path):
    """Every closed round is on disk at once; rotation re-stamps the meta
    line so each part parses alone; with the same calls (fixed span
    durations), the parts are the JAX sink's byte for byte."""
    files = {}
    for name, mod in (("port", tm), ("jax", jtm)):
        p = str(tmp_path / f"{name}.jsonl")
        sink = mod.JsonlSink(p, rotate_bytes=600)
        tel = mod.Telemetry({"bench": "rot"}, sink=sink)
        _fill(tel, 3)
        assert [json.loads(x)["round"] for x in open(p)
                if '"round"' in x][-1] == 2            # streamed live
        _fill(tel, 9, start=3)
        mod.finalize_sink(tel)
        sink.close()                                   # idempotent
        assert sink.parts >= 1
        files[name] = [open(f).read() for f in sink.rotated_paths() + [p]]
        rounds_seen = []
        for part in sink.rotated_paths() + [p]:
            d = tm.read_jsonl(part)
            assert d["meta"]["meta"] == {"bench": "rot"}
            rounds_seen += [r["round"] for r in d["rounds"]]
        assert rounds_seen == list(range(12))
    assert files["port"] == files["jax"]
    with pytest.raises(ValueError):
        tm.JsonlSink(str(tmp_path / "x.jsonl"), rotate_bytes=-1)


def test_retain_rounds_bounds_memory_not_disk(tmp_path):
    p = str(tmp_path / "t.jsonl")
    tel = tm.Telemetry(sink=tm.JsonlSink(p), retain_rounds=2)
    _fill(tel, 8)
    assert [r["round"] for r in tel.rounds] == [6, 7]
    tm.finalize_sink(tel)
    assert len(tm.read_jsonl(p)["rounds"]) == 8
    assert len(jtm.read_jsonl(p)["rounds"]) == 8
    plain = tm.Telemetry()
    _fill(plain, 2)
    tm.finalize_sink(plain)                            # no sink: no-op
    assert plain.sink is None and len(plain.rounds) == 2


def test_session_with_sink_finalizes_on_exit(tmp_path):
    p = str(tmp_path / "s.jsonl")
    with tm.session(meta={"m": 1}, sink=tm.JsonlSink(p)) as tel:
        tel.inc("a")
        tel.end_round(0)
        tel.inc("b")                                   # partial round
    d = jtm.read_jsonl(p)
    assert len(d["rounds"]) == 2 and d["rounds"][1]["round"] is None
    assert d["summary"]["counters"] == {"a": 1.0, "b": 1.0}
    assert tm.get() is None
    with tm.session(sink=tm.JsonlSink(str(tmp_path / "e.jsonl"))):
        tm.enable(sink=tm.JsonlSink(str(tmp_path / "f.jsonl")))
        tm.inc("z")
        tm.disable()                                   # flushes its sink
    assert tm.read_jsonl(str(tmp_path / "f.jsonl"))["summary"][
        "counters"] == {"z": 1.0}


# ---------------------------------------------------------------------------
# an enabled run of the port
# ---------------------------------------------------------------------------

def _sync_run(enabled, tmp_path=None):
    ctx = tm.session({"run": "sync"}, jsonl=str(tmp_path / "run.jsonl")) \
        if enabled else None
    fed = Federation(FedConfig(**SMALL_KW, screen=True), device="cpu")
    faults = make_fault_trace(SMALL_KW["n_clients"], faulty_frac=0.5,
                              crash_rate=0.2, corrupt_rate=0.7,
                              corrupt_modes=("nan",), seed=3)
    churn = make_churn_trace(SMALL_KW["n_clients"], 1e6, churn_frac=0.5,
                             seed=7)
    rt = RuntimeConfig(policy="sync", faults=faults, churn=churn)
    if ctx is None:
        return fed.run("elsa-nocluster", global_rounds=2,
                       steps_per_round=2, runtime=rt), None
    with ctx as tel:
        h = fed.run("elsa-nocluster", global_rounds=2, steps_per_round=2,
                    runtime=rt)
    return h, tel


def test_enabled_run_is_bit_inert_and_counts_match_trace(tmp_path):
    h_off, _ = _sync_run(False)
    h_on, tel = _sync_run(True, tmp_path)
    for key in ("accuracy", "loss", "delta", "time", "client_losses"):
        assert h_on[key] == h_off[key], key
    assert h_on["trace"] == h_off["trace"]
    summary = h_on["trace"].summary()
    assert summary
    for kind, n in summary.items():
        assert tel.counter("runtime.events", kind=kind) == n, kind
    assert len(tel.counters_by_name("runtime.events")) == len(summary)
    assert tel.counter("runtime.sim.compute_s") > 0
    assert tel.counter("runtime.uplink_bytes") > 0
    assert tel.counter("screening.verdicts", verdict="nonfinite") > 0
    assert [r["round"] for r in tel.rounds] == [0, 1]
    assert tel.rounds[-1]["sim_time_s"] == h_on["time"][-1]
    names = {s["name"] for rec in tel.rounds for s in rec["spans"]}
    assert {"profile", "dispatch", "local_steps", "uplink", "edge_agg",
            "cloud_agg", "eval"} <= names
    uplinks = [s for rec in tel.rounds for s in rec["spans"]
               if s["name"] == "uplink"]
    assert all("sim_s" in s["attrs"] for s in uplinks)
    assert any(s["attrs"]["sim_s"] > 0 for s in uplinks)
    # the exported file: per-round event deltas sum to the summary, and
    # either package reads it and renders it alike
    path = str(tmp_path / "run.jsonl")
    d, jd = tm.read_jsonl(path), jtm.read_jsonl(path)
    assert d == jd
    ev = tel.counters_by_name("runtime.events")
    assert {k: sum(r["counters"].get(k, 0) for r in d["rounds"])
            for k in ev} == ev
    assert telemetry_report.render(d, show_rounds=True) \
        == jax_report.render(jd, show_rounds=True)


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("show_rounds", [False, True])
def test_report_renders_the_jax_reports_text(show_rounds):
    got = telemetry_report.render(tm.read_jsonl(EXAMPLE),
                                  show_rounds=show_rounds)
    want = jax_report.render(jtm.read_jsonl(EXAMPLE),
                             show_rounds=show_rounds)
    assert got == want
    assert got.index("local_steps") < got.index("uplink") \
        < got.index("edge_agg") < got.index("cloud_agg")
    for part in ("simulated cost", "wire: uplink", "runtime events",
                 "jit compiles", "screening verdicts", "histograms"):
        assert part in got
    assert ("round     sim_time" in got) == show_rounds


def test_report_module_prints_the_jax_text():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.telemetry_report",
         EXAMPLE, "--rounds"], cwd=ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": os.path.join(ROOT, "src"),
             "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout == jax_report.render(jtm.read_jsonl(EXAMPLE),
                                           show_rounds=True) + "\n"
    assert "jax" not in out.stderr
