"""Full federation-state checkpointing (the counterpart of the JAX
package's ``repro/checkpoint/federation.py``, in its file format).

A federation checkpoint captures everything the round loop threads
between global rounds: global theta, the per-client channel state (SS-OP
bases), server optimizer moments, clustering outputs
(groups/divergence/trust), the live trust ledger, the numpy RNG state,
per-client batch-iterator cursors, fault-schedule cursors, the
simulated-clock/round cursor, and the recorded history/trace.  So killing
a run and resuming from its last checkpoint reproduces the uninterrupted
run *bit-identically* on the plain round loop and the sync runtime policy
(the deadline/async schedulers carry in-flight event-queue state between
rounds and do not support resume).  Tensors are copied to the host on
save; :func:`restore_run` puts theta, the server state and the channels
back on the federation's device.

Writes are atomic (:func:`repro_torch.checkpoint.checkpoint.save` renames
a temp file into place) and rolling: :class:`Checkpointer` keeps the
newest ``keep`` round snapshots and prunes the rest.  With a bound
registry-backed population the ``population`` section holds its state
(:meth:`repro_torch.population.PopulationRuntime.state`: the registry's
columns and adapter shards, the slot map and the identity channels).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import telemetry as tm
from repro_torch.bridge import stack_blocks, unstack_blocks
from repro_torch.checkpoint.checkpoint import restore, save

FORMAT = "elsa-federation"
VERSION = 1

_REQUIRED = ("config", "method", "steps_per_round", "round", "t_global",
             "delta", "theta", "server_state", "groups", "div", "trust",
             "ledger", "rng_state", "draws", "dispatches", "channels",
             "history", "client_losses", "trace")
_FNAME = re.compile(r"^ckpt_round_(\d{6})\.msgpack$")


@dataclasses.dataclass
class CheckpointConfig:
    """Where/how often the round loop snapshots itself."""
    dir: str
    every: int = 1           # checkpoint every N global rounds
    keep: int = 2            # rolling window of snapshots to retain

    def __post_init__(self):
        if self.every < 1 or self.keep < 1:
            raise ValueError("CheckpointConfig.every/keep must be >= 1")


def round_path(d: str, round_idx: int) -> str:
    return os.path.join(d, f"ckpt_round_{round_idx:06d}.msgpack")


def list_checkpoints(d: str) -> List[str]:
    """Checkpoint paths in ``d``, oldest round first."""
    if not os.path.isdir(d):
        return []
    hits = [(int(m.group(1)), f) for f in os.listdir(d)
            if (m := _FNAME.match(f))]
    return [os.path.join(d, f) for _, f in sorted(hits)]


def latest_checkpoint(d: str) -> Optional[str]:
    paths = list_checkpoints(d)
    return paths[-1] if paths else None


def resolve(path_or_dir: str) -> str:
    """A concrete checkpoint file: a file path passes through, a
    directory resolves to its newest round snapshot."""
    if os.path.isdir(path_or_dir):
        latest = latest_checkpoint(path_or_dir)
        if latest is None:
            raise ValueError(
                f"no federation checkpoints in directory {path_or_dir!r}")
        return latest
    return path_or_dir


class Checkpointer:
    """Rolling atomic round snapshots."""

    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg

    def due(self, round_idx: int, last_round: int, delta: float,
            xi: float) -> bool:
        """Snapshot on the cadence, at the final round, and at the
        convergence stop (so ``resume_from`` a finished run is exact)."""
        return (round_idx % self.cfg.every == 0 or round_idx == last_round
                or delta <= xi)

    def save(self, round_idx: int, state: Dict) -> str:
        path = round_path(self.cfg.dir, round_idx)
        t0 = time.perf_counter()
        save(path, state)
        if tm.enabled():
            tm.observe("checkpoint.save_s", time.perf_counter() - t0)
            tm.inc("checkpoint.saves", 1)
            tm.inc("checkpoint.bytes_written", os.path.getsize(path))
        for old in list_checkpoints(self.cfg.dir)[:-self.cfg.keep]:
            os.unlink(old)
        return path


# ---------------------------------------------------------------------------
# state assembly / restoration
# ---------------------------------------------------------------------------

def _pairs(d: Dict) -> List:
    """int-keyed dict -> sorted [key, value] pairs (wire-stable)."""
    return [[int(k), v] for k, v in sorted(d.items())]


def _unpairs(pairs) -> Dict:
    return {int(k): v for k, v in pairs}


def _to_device(tree, device):
    """A restored tree's numpy (and bfloat16 tensor) leaves as tensors on
    ``device``, each in its saved dtype; primitives stay."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def build_state(fed, *, method: str, steps_per_round: int, round_idx: int,
                theta, server_state, rng, iters, history, client_losses,
                groups, div, trust, delta: float, t_global: float = 0.0,
                dispatches: Optional[Dict[int, int]] = None,
                trace_records=None, population=None) -> Dict:
    """Assemble one checkpoint payload from a live ``Federation`` run.

    ``rng`` is the loop's ``np.random.default_rng`` (its
    ``bit_generator.state`` carries 128-bit ints, which overflow
    MessagePack's 64-bit integers, hence the JSON string).  ``iters`` are
    the per-client :class:`~repro_torch.data.pipeline.CountingIterator`
    streams; only their draw counts are stored, the resumed process
    rebuilds the same seeded streams and fast-forwards.  ``theta`` and the
    server state are written in the JAX package's layout (each ``blocks``
    leaf stacked on a layer axis), so either package resumes from the
    other's files; :func:`restore_run` reads both layouts.  ``channels``
    carries each client's SS-OP ``u``, ``v`` and the JAX package's fused
    ``w = Vᵀ - I``, ``w_inv = V - I`` (the port derives those from ``v``
    and reads only ``u`` and ``v`` back).  The edge groups keep their
    iteration order (an escalated group ``-1`` comes last), so a resumed
    run visits the edges, and sums their losses, in the same order.
    With a bound ``population`` the registry carries the draw cursors
    instead (slots have no fixed occupant), so ``draws`` is stored empty
    and the population's state rides in the ``population`` section;
    its identity-keyed channels live there too, so the slot-keyed
    ``channels`` section is empty.
    """
    ssops = []
    for n in sorted(fed._channels):
        ss = fed._channels[n].ssop
        if ss is None:
            ssops.append([int(n), None])
            continue
        eye = torch.eye(ss.v.shape[0], dtype=ss.v.dtype, device=ss.v.device)
        ssops.append([int(n), {"u": ss.u, "v": ss.v, "w": ss.v.T - eye,
                               "w_inv": ss.v - eye}])
    hist = {k: v for k, v in history.items()
            if k not in ("final_accuracy", "client_losses", "trace",
                         "policy")}
    return {
        "__format__": FORMAT, "__version__": VERSION,
        "config": dataclasses.asdict(fed.fed),
        "method": method, "steps_per_round": int(steps_per_round),
        "round": int(round_idx), "t_global": float(t_global),
        "delta": float(delta),
        "theta": stack_blocks(theta),
        "server_state": stack_blocks(server_state),
        "groups": [[int(k), [int(n) for n in ms]]
                   for k, ms in groups.items()],
        "div": np.asarray(div), "trust": np.asarray(trust),
        "ledger": fed.trust_ledger.state(),
        "rng_state": json.dumps(rng.bit_generator.state),
        "draws": _pairs({} if population is not None
                        else {n: it.count for n, it in iters.items()}),
        "dispatches": _pairs(dispatches or {}),
        "channels": ssops,
        "history": hist,
        "client_losses": _pairs(client_losses),
        "trace": list(trace_records) if trace_records is not None else None,
        "population": None if population is None else population.state(),
    }


def load_state(path: str) -> Dict:
    """Read + validate a federation checkpoint; clear ``ValueError`` on
    truncation, wrong format, version skew, or missing sections."""
    t0 = time.perf_counter()
    state = restore(path)
    if tm.enabled():
        tm.observe("checkpoint.restore_s", time.perf_counter() - t0)
        tm.inc("checkpoint.restores", 1)
        tm.inc("checkpoint.bytes_read", os.path.getsize(path))
    if not isinstance(state, dict) or "__format__" not in state:
        raise ValueError(
            f"{path!r} is not a federation checkpoint (no format marker); "
            "it may be stale or written by a different tool")
    if state["__format__"] != FORMAT:
        raise ValueError(f"{path!r} has format {state['__format__']!r}, "
                         f"expected {FORMAT!r}")
    if state["__version__"] != VERSION:
        raise ValueError(
            f"{path!r} is federation-checkpoint version "
            f"{state['__version__']}, this code reads {VERSION}; "
            "re-run from scratch or upgrade in lockstep")
    missing = [k for k in _REQUIRED if k not in state]
    if missing:
        raise ValueError(f"{path!r} is missing sections {missing} — "
                         "the payload was corrupted after the header")
    return state


def restore_run(fed, state: Dict, *, method: str, steps_per_round: int,
                iters, rng, population=None) -> SimpleNamespace:
    """Rehydrate a live run from a validated checkpoint payload.

    Side effects on ``fed``: per-client channels (SS-OP bases, on the
    federation's device, with ``fed.plan``) are reinstalled and the trust
    ledger reloaded.  ``rng`` is restored to the saved generator state
    and each client's ``iters`` stream is fast-forwarded to its saved
    draw count.  Raises ``ValueError`` when the checkpoint was written
    under a different config/method (a resumed run must continue the
    *same* experiment).

    ``population`` must match the checkpoint: a snapshot written with a
    bound :class:`~repro_torch.population.PopulationRuntime` restores its
    registry (which carries the per-id draw cursors in place of the
    slot-keyed ``draws`` section) and its identity channels, and refuses
    to resume without one, and vice versa.
    """
    from repro_torch.core.split_training import Channel
    from repro_torch.core.ssop import SSOP

    cfg_now = dataclasses.asdict(fed.fed)
    cfg_then = state["config"]
    diff = sorted(k for k in set(cfg_now) | set(cfg_then)
                  if cfg_now.get(k) != cfg_then.get(k))
    if diff:
        raise ValueError(
            f"checkpoint config mismatch on {diff}: the checkpoint was "
            f"written under a different FedConfig than this Federation")
    if state["method"] != method or \
            state["steps_per_round"] != steps_per_round:
        raise ValueError(
            f"checkpoint ran method={state['method']!r} with "
            f"steps_per_round={state['steps_per_round']}; resume asked "
            f"for method={method!r}, steps_per_round={steps_per_round}")

    pop_state = state.get("population")
    if (pop_state is not None) != (population is not None):
        raise ValueError(
            "population mismatch: the checkpoint was written "
            + ("with" if pop_state is not None else "without")
            + " a registry-backed population, this resume runs "
            + ("without" if population is None else "with") + " one")
    rng.bit_generator.state = json.loads(state["rng_state"])
    if population is not None:
        population.load_state(pop_state)
    else:
        for n, count in _unpairs(state["draws"]).items():
            iters[n].fast_forward(int(count))
    device = fed.device
    plan = fed.plan if fed.fed.use_channel else None
    fed._channels.clear()
    for n, ss in state["channels"]:
        ssop = None if ss is None else SSOP(
            u=_to_device(ss["u"], device), v=_to_device(ss["v"], device))
        if population is not None:
            # a population snapshot with slot-keyed channels: those were
            # built at profile time, when slot n held identity n, so
            # adopting them identity-keyed is exact
            population.adopt_channel(int(n), Channel(ssop, plan))
        else:
            fed._channels[int(n)] = Channel(ssop, plan)
    if state["ledger"] is not None:
        fed.trust_ledger.load_state(state["ledger"])
    return SimpleNamespace(
        round_idx=int(state["round"]),
        t_global=float(state["t_global"]),
        delta=float(state["delta"]),
        theta=_to_device(unstack_blocks(state["theta"]), device),
        server_state=_to_device(unstack_blocks(state["server_state"]),
                                device),
        groups=_unpairs(state["groups"]),
        div=np.asarray(state["div"]),
        trust=np.asarray(state["trust"]),
        history={k: list(v) for k, v in state["history"].items()},
        client_losses={n: list(v)
                       for n, v in _unpairs(state["client_losses"]).items()},
        dispatches={int(n): int(c)
                    for n, c in _unpairs(state["dispatches"]).items()},
        trace_records=(None if state["trace"] is None
                       else list(state["trace"])),
    )
