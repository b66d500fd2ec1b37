"""Scheduler policies for the event-driven edge runtime (the counterpart of
the JAX package's ``repro/runtime/schedulers.py``: the same event order,
the same numpy draws, the same mixing weights, spans and counters).

All three schedulers drive the same training machinery — the
federation's :class:`~repro_torch.federation.engine.BatchedEngine` via
``Federation._edge_round`` (which buckets whatever ready-set it is handed
by split configuration), and on a CUDA device every client step runs the
hand-written kernels — and differ only in *when* edge and cloud
aggregations happen on the simulated clock:

- :class:`SyncScheduler`: barrier per edge round.  With no churn this
  issues the exact same sequence of training/aggregation calls as
  ``Federation.run``, so histories are bit-identical; it additionally
  prices every round in simulated seconds (the barrier waits for the
  slowest straggler, churn pauses included).
- :class:`DeadlineScheduler`: the edge aggregates whoever reported
  within a per-round deadline; stragglers keep training and their
  updates carry over into a later aggregation with a per-round-late
  weight discount.
- :class:`AsyncScheduler`: the edge folds each arrival into its model
  continuously with staleness-discounted mixing weights (FedAsync-style)
  and the cloud fuses edge models on a fixed period.

All three inject faults from ``RuntimeConfig.faults`` (a seeded
:class:`~repro_torch.federation.topology.FaultTrace`): crashes lose
in-flight work, drops lose the uplink after training, dups deliver it
twice, and corruptions mangle the arriving adapter update — each sampled
per dispatch, so the schedule is identical whether screening is on or
off.  With ``FedConfig(screen=True)`` the sync policy's edges aggregate
through ``Federation.screened_aggregate``, the deadline policy screens each
window's arrivals with ``Federation.screen_cohort``, and the async policy
screens each arrival alone (the finite check) and scales its mixing
weight by the client's trust.  The sync policy also supports full-state
checkpoint/resume (:mod:`repro_torch.checkpoint.federation`): resuming a
killed run reproduces the uninterrupted history bit-identically.  With a
bound population (``run(population=...)``) each policy samples a cohort of
registered ids into the client slots, per round (sync, deadline) or per
fusion window (async); a straggler writes its update and its verdict back
under its pinned dispatch-time identity, never under the slot's new
occupant.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import telemetry as tm
from repro_torch.core import aggregation as agg
from repro_torch.core.screening import LOW_TRUST, NONFINITE, OK
from repro_torch.data.pipeline import CountingIterator, infinite_batches
from repro_torch.federation.engine import screen_stats
from repro_torch.federation.topology import corrupt_update
from repro_torch.optim.optimizers import tree_map
from repro_torch.runtime.client import ClientRuntimeState
from repro_torch.runtime.events import (ARRIVAL, CLOUD_AGG, CORRUPT, CRASH,
                                        DISPATCH, DROP, DUP, EDGE_AGG, EVAL,
                                        OFFLINE, REJOIN, Event, EventQueue)

ELSA_METHODS = ("elsa", "elsa-fixed", "elsa-nocluster")


@torch.no_grad()
def _mix(theta, update, w: float, mode: str = "factor"):
    """theta <- (1-w) theta + w update (async edge fold); in product
    mode the mix happens in weight-delta space (factor-space mixing has
    the same cross-term cancellation as factor averaging)."""
    return agg.mix_adapters(theta, update, w, mode=mode)


class _SchedulerBase:
    def __init__(self, rt):
        self.rt = rt
        self.fed = rt.federation
        self.fc = rt.federation.fed
        self.cost = rt.cost
        self.churn = rt.churn
        self.trace = rt.trace
        self.rcfg = rt.config
        # registry-backed population binding, if Federation.run /
        # EdgeRuntime.run installed one (None -> the slot-keyed path)
        self.pop = rt.federation._population

    # -- shared setup ------------------------------------------------------
    def _setup(self, method: str, assign: bool = True):
        """Shared run preamble.  ``assign=False`` skips the clustering
        phase: a resumed run restores groups/div/trust (and the channels
        the clustering built) from its checkpoint instead."""
        fc = self.fc
        rng = np.random.default_rng(fc.seed + 5)
        groups = div = trust = None
        if assign:
            with tm.span("profile", method=method):
                groups, div, trust = self.fed._assign_groups(method, rng)
            if self.pop is not None:
                self.pop.after_assign(groups)
        iters = self.pop.iters if self.pop is not None else \
            {n: CountingIterator(
                 infinite_batches(self.fed.data[n].tokens,
                                  self.fed.data[n].labels,
                                  fc.batch_size,
                                  seed=fc.seed + 100 + n))
             for n in range(fc.n_clients)}
        server_opt = self.fed.server_optimizer(method)
        server_state = server_opt.init(self.fed.lora0) if server_opt \
            else None
        return rng, groups, div, trust, iters, server_opt, server_state

    def _sample_fault(self, n: int, dispatch_idx: int):
        faults = self.rcfg.faults
        return faults.sample(n, dispatch_idx) if faults is not None \
            else None

    def _round_seconds(self, n: int, use_split: bool, steps: int,
                       edge: int, round_idx: int) -> float:
        rc = self.cost.round_cost(
            n, self.fed.split_for(n, use_split), steps,
            edge, round_idx)
        if tm.enabled():
            # per-phase simulated seconds + wire bytes, one bill per
            # dispatch (the sim-time breakdown lives in counters, wall
            # time in spans)
            tm.inc("runtime.sim.compute_s", rc.compute_s)
            tm.inc("runtime.sim.uplink_s", rc.comm_s)
            tm.inc("runtime.sim.downlink_s", rc.downlink_s)
            tm.inc("runtime.sim.latency_s", rc.latency_s)
            tm.inc("runtime.uplink_bytes", rc.uplink_bytes)
            tm.inc("runtime.downlink_bytes", rc.downlink_bytes)
        return rc.total_s

    # -- cloud fusion (identical math to Federation.run) -------------------
    @torch.no_grad()
    def _cloud_fuse(self, method: str, edge_thetas, edge_alphas, theta,
                    server_opt, server_state):
        mode = self.fc.aggregate
        if method in ELSA_METHODS:
            theta_new = agg.cloud_aggregate(edge_thetas, edge_alphas,
                                            mode=mode)
        else:
            ws = {k: 1.0 for k in edge_thetas}
            theta_new = agg.cloud_aggregate(edge_thetas, ws, mode=mode)
        if server_opt is not None:
            pseudo = tree_map(lambda a, b: a - b, theta, theta_new)
            theta_new, server_state = server_opt.update(theta, pseudo,
                                                        server_state)
        delta = agg.global_delta(theta_new, theta)
        return theta_new, server_state, delta

    def _edge_alpha(self, div, trust, members) -> float:
        return agg.edge_weight(agg.mean_pairwise_kld(div, members),
                               self.fed.fusion_trust(trust, members))

    def _record_eval(self, history, round_idx: int, t: float, theta,
                     losses, delta: float, log: bool, label: str) -> None:
        """Evaluate + append one history/trace point (all policies)."""
        with tm.span("eval", round=round_idx):
            acc = self.fed.evaluate(theta)
        self.trace.log(t, EVAL, round=round_idx, accuracy=acc)
        history["round"].append(round_idx)
        history["time"].append(t)
        history["accuracy"].append(acc)
        history["loss"].append(
            float(np.mean(losses)) if losses else float("nan"))
        history["delta"].append(delta)
        if log:
            print(f"[{label}] round {round_idx}: t={t:.1f}s "
                  f"acc={acc:.4f} loss={history['loss'][-1]:.4f}")

    def _finish_history(self, history, theta, client_losses):
        if not history["accuracy"]:
            # simulation hit max_sim_s before the first eval point
            history["round"].append(0)
            history["time"].append(0.0)
            history["accuracy"].append(self.fed.evaluate(theta))
            history["loss"].append(float("nan"))
            history["delta"].append(float("nan"))
        history["final_accuracy"] = history["accuracy"][-1]
        history["client_losses"] = client_losses
        self.fed.last_theta = theta
        return history


# ---------------------------------------------------------------------------
# sync: barrier semantics, priced in wall-clock
# ---------------------------------------------------------------------------

class SyncScheduler(_SchedulerBase):
    """Reproduces ``Federation.run`` exactly (same dispatch sequence,
    same aggregation order) while assigning every round a simulated
    duration: each edge round ends when its slowest participant finishes
    (churn pauses included); the cloud waits for the slowest edge.

    Crash faults lose the client's round entirely — it contributes no
    update, no loss, and the barrier does not wait for it (the edge
    times it out); drops train and count toward the barrier but the
    uplink is lost; dups fold the update twice; corruptions mangle it
    in flight.  This is the only policy supporting checkpoint/resume: at a
    global-round boundary the whole scheduler state is in (theta,
    server_state, rng, iterator cursors, dispatch counters, clock), which
    :mod:`repro_torch.checkpoint.federation` serializes.
    """

    def run(self, method: str, global_rounds: int, steps_per_round: int,
            eval_every: int, log: bool, checkpoint=None,
            resume_from: Optional[str] = None) -> Dict:
        from repro_torch.checkpoint import federation as fedckpt
        fed, fc = self.fed, self.fc
        use_split_dyn = method not in ("elsa-fixed",)
        rng, groups, div, trust, iters, server_opt, server_state = \
            self._setup(method, assign=resume_from is None)
        history = {"round": [], "time": [], "accuracy": [], "loss": [],
                   "delta": []}
        client_losses: Dict[int, List[float]] = {
            n: [] for n in range(fc.n_clients)}
        theta = fed.lora0
        t_global = 0.0
        disp = {n: 0 for n in range(fc.n_clients)}  # fault cursors
        start_round, last_delta = 0, float("inf")

        if resume_from is not None:
            state = fedckpt.load_state(fedckpt.resolve(resume_from))
            res = fedckpt.restore_run(fed, state, method=method,
                                      steps_per_round=steps_per_round,
                                      iters=iters, rng=rng,
                                      population=self.pop)
            groups, div, trust = res.groups, res.div, res.trust
            theta, server_state = res.theta, res.server_state
            history, client_losses = res.history, res.client_losses
            start_round, last_delta = res.round_idx + 1, res.delta
            t_global = res.t_global
            disp.update(res.dispatches)
            if res.trace_records is not None:
                self.trace.records = list(res.trace_records)
            if last_delta <= fc.xi or t_global >= self.rcfg.max_sim_s:
                return self._finish_history(history, theta, client_losses)
        ckpt = fedckpt.Checkpointer(checkpoint) if checkpoint else None

        for g in range(start_round, global_rounds):
            if self.pop is not None:
                self.pop.begin_round(g, t=t_global)
            edge_thetas, edge_alphas, losses = {}, {}, []
            edge_done = {}
            for k, members in groups.items():
                if not members:
                    continue
                active = members
                if method == "fedavg-random":
                    m = max(1, len(members) // 2)
                    active = list(rng.choice(members, m, replace=False))
                theta_k = theta
                t_k = t_global
                for r in range(fc.t_rounds):
                    with tm.span("dispatch", round=g, edge=k) as sp_d:
                        avail = [n for n in active
                                 if self.churn.is_online(n, t_k)]
                        while not avail:
                            # whole cohort offline: the barrier waits for
                            # the first rejoin (finite churn traces
                            # guarantee one)
                            t_k = min(self.churn.next_online(n, t_k)
                                      for n in active
                                      if not self.churn.is_online(n, t_k))
                            avail = [n for n in active
                                     if self.churn.is_online(n, t_k)]
                        for n in avail:
                            self.trace.log(t_k, DISPATCH, n, k, round=g,
                                           edge_round=r)
                        for n in active:
                            if n not in avail:
                                self.trace.log(t_k, OFFLINE, n, k,
                                               round=g, edge_round=r)
                        sp_d.set(n_clients=len(avail))
                    with tm.span("local_steps", round=g, edge=k,
                                 n_clients=len(avail)):
                        locals_, weights, loss_map = fed._edge_round(
                            avail, theta_k, steps_per_round, iters,
                            use_split=use_split_dyn,
                            prox_anchor=(theta if method == "fedprox"
                                         else None))
                    barrier = t_k
                    upds, wts, senders = [], [], []
                    with tm.span("uplink", round=g, edge=k) as sp_u:
                        for lora_n, w_n, n in zip(locals_, weights, avail):
                            fault = self._sample_fault(n, disp[n])
                            disp[n] += 1
                            dur = self._round_seconds(n, use_split_dyn,
                                                      steps_per_round, k, g)
                            f_n = self.churn.finish_time(n, t_k, dur)
                            if fault is not None and fault.kind == "crash":
                                # work lost, not paused: no update, no
                                # loss, and the barrier does not wait
                                t_c = t_k + fault.at_frac \
                                    * max(f_n - t_k, 0.0)
                                self.trace.log(t_c, CRASH, n, k, round=g,
                                               edge_round=r)
                                continue
                            self.trace.log(f_n, ARRIVAL, n, k, round=g)
                            barrier = max(barrier, f_n)
                            losses.append(loss_map[n])
                            client_losses[n].append(loss_map[n])
                            if fault is not None and fault.kind == "drop":
                                self.trace.log(f_n, DROP, n, k, round=g)
                                continue
                            if fault is not None and fault.kind == "corrupt":
                                lora_n = corrupt_update(theta_k, lora_n,
                                                        fault)
                                self.trace.log(f_n, CORRUPT, n, k, round=g,
                                               mode=fault.mode)
                            upds.append(lora_n)
                            wts.append(w_n)
                            senders.append(n)
                            if fault is not None and fault.kind == "dup":
                                upds.append(lora_n)
                                wts.append(w_n)
                                senders.append(n)
                                self.trace.log(f_n, DUP, n, k, round=g)
                        sp_u.set(sim_s=barrier - t_k, n_updates=len(upds))
                    if upds:
                        if self.pop is not None:
                            self.pop.note_updates(senders, upds, theta_k)
                        with tm.span("edge_agg", round=g, edge=k,
                                     n_updates=len(upds)), torch.no_grad():
                            theta_k = fed.screened_aggregate(
                                senders, upds, wts, theta_k)
                    # else: every uplink was lost; the edge keeps its model
                    t_k = barrier
                    self.trace.log(t_k, EDGE_AGG, -1, k, round=g,
                                   n_updates=len(upds))
                edge_thetas[k] = theta_k
                edge_alphas[k] = self._edge_alpha(div, trust, active)
                edge_done[k] = t_k

            t_global = max(edge_done.values()) + self.rt.backhaul_s
            with tm.span("cloud_agg", round=g, n_edges=len(edge_thetas)):
                theta, server_state, delta = self._cloud_fuse(
                    method, edge_thetas, edge_alphas, theta, server_opt,
                    server_state)
            self.trace.log(t_global, CLOUD_AGG, round=g,
                           n_edges=len(edge_thetas))
            if g % eval_every == 0 or g == global_rounds - 1:
                self._record_eval(history, g, t_global, theta, losses,
                                  delta, log, f"sync/{method}")
            if self.pop is not None:
                self.pop.end_round(g)
            if ckpt is not None and ckpt.due(g, global_rounds - 1, delta,
                                             fc.xi):
                ckpt.save(g, fedckpt.build_state(
                    fed, method=method, steps_per_round=steps_per_round,
                    round_idx=g, theta=theta, server_state=server_state,
                    rng=rng, iters=iters, history=history,
                    client_losses=client_losses, groups=groups, div=div,
                    trust=trust, delta=delta, t_global=t_global,
                    dispatches=disp, trace_records=self.trace.records,
                    population=self.pop))
            tm.end_round(g, sim_time_s=t_global)
            if delta <= fc.xi or t_global >= self.rcfg.max_sim_s:
                break
        return self._finish_history(history, theta, client_losses)


# ---------------------------------------------------------------------------
# deadline: bounded edge rounds, straggler carry-over
# ---------------------------------------------------------------------------

class DeadlineScheduler(_SchedulerBase):
    """Edge rounds end at ``start + deadline_s``; whoever reported in the
    window is folded into the edge model by partial-participation
    averaging — the current ``theta_k`` is weighted by the cohort mass
    that did *not* report, so late windows perturb rather than replace
    it — with stragglers from earlier rounds discounted by
    ``straggler_discount**rounds_late``.  Clients still training at the
    deadline are simply not re-dispatched until they finish — their work
    is never thrown away, it just arrives late (unless a fault crashes
    it mid-flight or drops the uplink)."""

    def run(self, method: str, global_rounds: int, steps_per_round: int,
            eval_every: int, log: bool, checkpoint=None,
            resume_from: Optional[str] = None) -> Dict:
        # checkpoint/resume kwargs are rejected upstream by EdgeRuntime
        # for non-sync policies; they reach here only as None
        fed, fc = self.fed, self.fc
        use_split_dyn = method not in ("elsa-fixed",)
        rng, groups, div, trust, iters, server_opt, server_state = \
            self._setup(method)
        history = {"round": [], "time": [], "accuracy": [], "loss": [],
                   "delta": []}
        client_losses: Dict[int, List[float]] = {
            n: [] for n in range(fc.n_clients)}
        theta = fed.lora0
        t_global = 0.0

        placed = [n for ms in groups.values() for n in ms]
        deadline_s = self.rcfg.deadline_s
        if deadline_s is None:
            est = self.cost.estimate_population(
                {n: fed.split_for(n, use_split_dyn) for n in placed},
                steps_per_round)
            deadline_s = float(np.quantile(list(est.values()),
                                           self.rcfg.deadline_quantile))
        states = {n: ClientRuntimeState(n) for n in placed}
        queues = {k: EventQueue() for k, ms in groups.items() if ms}
        edge_round_idx = {k: 0 for k in queues}

        for g in range(global_rounds):
            if self.pop is not None:
                self.pop.begin_round(g, t=t_global)
            edge_thetas, edge_alphas, losses = {}, {}, []
            edge_done = {}
            for k, members in groups.items():
                if not members:
                    continue
                active = members
                if method == "fedavg-random":
                    m = max(1, len(members) // 2)
                    active = list(rng.choice(members, m, replace=False))
                theta_k = theta
                t_k = t_global
                for _ in range(fc.t_rounds):
                    t_k, theta_k = self._edge_deadline_round(
                        k, active, theta_k, t_k, deadline_s,
                        steps_per_round, iters, method, theta,
                        use_split_dyn, states, queues[k], edge_round_idx,
                        losses, client_losses, g)
                edge_thetas[k] = theta_k
                edge_alphas[k] = self._edge_alpha(div, trust, active)
                edge_done[k] = t_k

            t_global = max(edge_done.values()) + self.rt.backhaul_s
            with tm.span("cloud_agg", round=g, n_edges=len(edge_thetas)):
                theta, server_state, delta = self._cloud_fuse(
                    method, edge_thetas, edge_alphas, theta, server_opt,
                    server_state)
            self.trace.log(t_global, CLOUD_AGG, round=g,
                           n_edges=len(edge_thetas))
            if g % eval_every == 0 or g == global_rounds - 1:
                self._record_eval(history, g, t_global, theta, losses,
                                  delta, log, f"deadline/{method}")
            if self.pop is not None:
                self.pop.end_round(g)
            tm.end_round(g, sim_time_s=t_global)
            if delta <= fc.xi or t_global >= self.rcfg.max_sim_s:
                break
        return self._finish_history(history, theta, client_losses)

    # ------------------------------------------------------------------
    def _edge_deadline_round(self, k, active, theta_k, t_k, deadline_s,
                             steps, iters, method, theta_anchor,
                             use_split_dyn, states, queue, edge_round_idx,
                             losses, client_losses, g):
        """One deadline-bounded edge round; returns (t_end, theta_k)."""
        fed = self.fed
        r_idx = edge_round_idx[k]
        while True:
            ready = [n for n in active if states[n].idle
                     and self.churn.is_online(n, t_k)]
            if ready:
                with tm.span("local_steps", round=g, edge=k,
                             n_clients=len(ready)):
                    locals_, _, loss_map = fed._edge_round(
                        ready, theta_k, steps, iters,
                        use_split=use_split_dyn,
                        prox_anchor=(theta_anchor if method == "fedprox"
                                     else None))
                for lora_n, n in zip(locals_, ready):
                    fault = self._sample_fault(n, states[n].dispatches)
                    dur = self._round_seconds(n, use_split_dyn, steps, k,
                                              states[n].rounds_run)
                    f_n = self.churn.finish_time(n, t_k, dur)
                    if self.pop is not None:
                        # a straggler may arrive after a cohort swap:
                        # remember who actually trained in this slot
                        self.pop.pin(n)
                    states[n].dispatch(t_k, f_n, 0, r_idx)
                    if fault is not None and fault.kind == "crash":
                        t_c = t_k + fault.at_frac * max(f_n - t_k, 0.0)
                        queue.push(Event(t_c, CRASH, n, k))
                    else:
                        if fault is not None and fault.kind == "corrupt":
                            lora_n = corrupt_update(theta_k, lora_n,
                                                    fault)
                        queue.push(Event(f_n, ARRIVAL, n, k,
                                         payload=(lora_n, loss_map[n],
                                                  fault)))
                    self.trace.log(t_k, DISPATCH, n, k, round=g,
                                   edge_round=r_idx)
            if queue:
                break
            # nothing in flight and nobody dispatchable: jump to the
            # first rejoin among idle members and retry
            t_k = min(self.churn.next_online(n, t_k) for n in active
                      if states[n].idle
                      and not self.churn.is_online(n, t_k))

        deadline = t_k + deadline_s
        nxt = queue.peek()
        if nxt.time > deadline:
            # nobody would report in the window — stretch it to the first
            # arrival so an edge round never aggregates nothing
            deadline = nxt.time
        upds, wts, senders, n_late, rep_w = [], [], [], 0, 0.0
        note_ids = []
        with tm.span("uplink", round=g, edge=k) as sp_u:
            for ev in queue.drain_until(deadline):
                n = ev.client
                if ev.kind == CRASH:
                    # in-flight work lost; the client idles and is
                    # eligible for re-dispatch from the next window
                    states[n].crash()
                    self.trace.log(ev.time, CRASH, n, k, round=g)
                    continue
                states[n].complete(ev.payload)
                lora_n, loss_n, fault = states[n].collect()
                late = r_idx - states[n].base_round
                losses.append(loss_n)
                client_losses[n].append(loss_n)
                self.trace.log(ev.time, ARRIVAL, n, k, round=g, late=late)
                if fault is not None and fault.kind == "drop":
                    # trained (loss counted) but the uplink was lost: not
                    # folded, and its mass stays with the absent cohort
                    self.trace.log(ev.time, DROP, n, k, round=g)
                    continue
                if fault is not None and fault.kind == "corrupt":
                    self.trace.log(ev.time, CORRUPT, n, k, round=g,
                                   mode=fault.mode)
                w = fed.client_weight(n) \
                    * (self.rcfg.straggler_discount ** late)
                upds.append(lora_n)
                wts.append(w)
                senders.append(n)
                if self.pop is not None:
                    note_ids.append(self.pop.pinned(n))
                rep_w += fed.client_weight(n)
                n_late += int(late > 0)
                if fault is not None and fault.kind == "dup":
                    upds.append(lora_n)
                    wts.append(w)
                    senders.append(n)
                    if self.pop is not None:
                        note_ids.append(self.pop.pinned(n))
                    self.trace.log(ev.time, DUP, n, k, round=g)
            sp_u.set(sim_s=deadline - t_k, n_updates=len(upds),
                     n_stragglers=n_late)
        if tm.enabled() and n_late:
            # straggler carry-overs folded this window (late > 0 rounds)
            tm.inc("runtime.stragglers", n_late)
        if self.pop is not None and upds:
            # stragglers write back under their pinned dispatch-time
            # identity; the delta base is the window's edge model (a
            # straggler's true dispatch model is gone; the registry
            # column is off the math path)
            self.pop.note_updates(senders, upds, theta_k, ids=note_ids)
        with tm.span("edge_agg", round=g, edge=k, n_updates=len(upds)), \
                torch.no_grad():
            if self.fc.screen and upds:
                upds, wts = fed.screen_cohort(senders, upds, wts, theta_k)
            # partial participation: the current edge model stands in for
            # the cohort mass that did NOT report this window, so a lone
            # (possibly stale, discounted) arrival perturbs theta_k
            # proportionally instead of replacing it — fedavg's weight
            # normalization would otherwise cancel the straggler discount
            # whenever a window's arrivals are uniformly late
            absent_w = max(float(sum(fed.client_weight(n)
                                     for n in active)) - rep_w, 0.0)
            if upds and absent_w > 0:
                theta_k = agg.aggregate_adapters([theta_k] + upds,
                                                 [absent_w] + wts,
                                                 mode=self.fc.aggregate)
            elif upds:
                theta_k = agg.aggregate_adapters(upds, wts,
                                                 mode=self.fc.aggregate)
            # else: every uplink this window was lost or screened out;
            # the edge keeps its model
        self.trace.log(deadline, EDGE_AGG, -1, k, round=g,
                       n_updates=len(upds), n_stragglers=n_late)
        edge_round_idx[k] = r_idx + 1
        return deadline, theta_k


# ---------------------------------------------------------------------------
# async: continuous staleness-weighted folding, periodic cloud fusion
# ---------------------------------------------------------------------------

class AsyncScheduler(_SchedulerBase):
    """FedAsync-style hierarchical execution: every arrival is folded
    into its edge model immediately with weight
    ``alpha / (1 + staleness)^decay`` (staleness = edge-model versions
    since dispatch) and the client is re-dispatched from the fresh edge
    model; the cloud fuses all edge models every ``cloud_period_s``
    simulated seconds and broadcasts the result back to the edges.
    ``global_rounds`` counts cloud fusions.

    ``fedavg-random`` keeps its partial-participation semantics here
    too: each cloud-fusion window samples half of every edge's members
    as the active cohort — only cohort members are (re-)dispatched, and
    the fusion's edge weights are computed over the *actually-sampled*
    cohort, not the full membership."""

    def run(self, method: str, global_rounds: int, steps_per_round: int,
            eval_every: int, log: bool, checkpoint=None,
            resume_from: Optional[str] = None) -> Dict:
        # checkpoint/resume kwargs are rejected upstream by EdgeRuntime
        # for non-sync policies; they reach here only as None
        fed, fc = self.fed, self.fc
        use_split_dyn = method not in ("elsa-fixed",)
        rng, groups, div, trust, iters, server_opt, server_state = \
            self._setup(method)
        history = {"round": [], "time": [], "accuracy": [], "loss": [],
                   "delta": []}
        client_losses: Dict[int, List[float]] = {
            n: [] for n in range(fc.n_clients)}

        groups = {k: ms for k, ms in groups.items() if ms}
        theta = fed.lora0
        edge_theta = {k: theta for k in groups}
        version = {k: 0 for k in groups}
        states = {n: ClientRuntimeState(n)
                  for ms in groups.values() for n in ms}
        queue = EventQueue()
        self._steps = steps_per_round
        self._use_split_dyn = use_split_dyn
        self._method = method
        self._iters = iters
        self._anchor = theta

        def sample_cohort():
            """Per-fusion-window active set per edge (fedavg-random
            subsamples half the members, like the sync/deadline loops
            do per global round; other methods run everyone)."""
            if method != "fedavg-random":
                return {k: list(ms) for k, ms in groups.items()}
            return {k: sorted(int(x) for x in
                              rng.choice(ms, max(1, len(ms) // 2),
                                         replace=False))
                    for k, ms in groups.items()}

        cohort = sample_cohort()

        period = self.rcfg.cloud_period_s
        if period is None:
            est = self.cost.estimate_population(
                {n: fed.split_for(n, use_split_dyn) for n in states},
                steps_per_round)
            period = fc.t_rounds * float(np.median(list(est.values()))) \
                + self.rt.backhaul_s

        if self.pop is not None:
            # the async cohort swaps per fusion window, not per round
            self.pop.begin_round(0, t=0.0)
        # initial dispatch: every online cohort member, batched per edge
        for k in groups:
            ready = [n for n in cohort[k] if self.churn.is_online(n, 0.0)]
            if ready:
                self._dispatch(ready, k, 0.0, edge_theta[k], version[k],
                               states, queue)
            for n in cohort[k]:
                if n not in ready:
                    queue.push(Event(self.churn.next_online(n, 0.0),
                                     REJOIN, n, k))
        queue.push(Event(period, CLOUD_AGG))

        fusions = 0
        window_losses: List[float] = []
        while queue and fusions < global_rounds:
            ev = queue.pop()
            t = ev.time
            if t > self.rcfg.max_sim_s:
                break
            if ev.kind == ARRIVAL:
                n, k = ev.client, ev.edge
                states[n].complete(ev.payload)
                lora_n, loss_n, fault = states[n].collect()
                s = states[n].staleness(version[k])
                w = min(1.0, self.rcfg.async_alpha
                        / (1.0 + s) ** self.rcfg.staleness_decay)
                folds = 1
                if fault is not None and fault.kind == "drop":
                    folds = 0   # trained, but the uplink was lost
                elif fault is not None and fault.kind == "dup":
                    folds = 2   # delivered (and folded) twice
                if fc.screen and folds:
                    # no cohort to median against here: each arrival is
                    # screened alone (the finite check) and discounted by
                    # its client's trust; the norm and direction screens
                    # need the cohorts of the sync and deadline paths
                    fin, _, _ = screen_stats(edge_theta[k], [lora_n], [1.0])
                    ok = bool(fin[0])
                    if self.pop is not None:
                        # the verdict belongs to whoever trained the
                        # update: the pinned dispatch-time identity,
                        # not slot n's current occupant
                        cid = self.pop.pinned(n)
                        self.pop.record_trust(cid, ok)
                        score = self.pop.trust_weight(cid)
                    else:
                        fed.trust_ledger.record(n, ok)
                        score = float(fed.trust_ledger.scores[n])
                    if not ok or score < fed.screening.trust_floor:
                        folds = 0
                    if tm.enabled():
                        v = NONFINITE if not ok else \
                            (OK if folds else LOW_TRUST)
                        tm.inc("screening.verdicts", 1, verdict=v)
                    if folds:
                        w = min(1.0, w * score)
                if folds and self.pop is not None:
                    # write back under the dispatch-time identity (the
                    # cohort may have swapped since); delta base is the
                    # current pre-fold edge model
                    self.pop.note_updates([n], [lora_n], edge_theta[k],
                                          ids=[self.pop.pinned(n)])
                for _ in range(folds):
                    edge_theta[k] = _mix(edge_theta[k], lora_n, w,
                                         mode=fc.aggregate)
                    version[k] += 1
                window_losses.append(loss_n)
                client_losses[n].append(loss_n)
                self.trace.log(t, ARRIVAL, n, k, staleness=s,
                               weight=round(w, 6))
                if fault is not None and fault.kind == "drop":
                    self.trace.log(t, DROP, n, k)
                elif fault is not None and fault.kind == "dup":
                    self.trace.log(t, DUP, n, k)
                elif fault is not None and fault.kind == "corrupt":
                    self.trace.log(t, CORRUPT, n, k, mode=fault.mode)
                if n not in cohort[k]:
                    pass   # dropped from the current cohort: stay idle
                elif self.churn.is_online(n, t):
                    self._dispatch([n], k, t, edge_theta[k], version[k],
                                   states, queue)
                else:
                    queue.push(Event(self.churn.next_online(n, t),
                                     REJOIN, n, k))
            elif ev.kind == CRASH:
                n, k = ev.client, ev.edge
                states[n].crash()
                self.trace.log(t, CRASH, n, k)
                if n not in cohort[k]:
                    pass   # crashed out of a stale cohort: stay idle
                elif self.churn.is_online(n, t):
                    self._dispatch([n], k, t, edge_theta[k], version[k],
                                   states, queue)
                else:
                    queue.push(Event(self.churn.next_online(n, t),
                                     REJOIN, n, k))
            elif ev.kind == REJOIN:
                n, k = ev.client, ev.edge
                if not (states[n].idle and n in cohort[k]):
                    pass   # mid-flight, or no longer sampled this window
                elif self.churn.is_online(n, t):
                    self._dispatch([n], k, t, edge_theta[k], version[k],
                                   states, queue)
                else:
                    queue.push(Event(self.churn.next_online(n, t),
                                     REJOIN, n, k))
            elif ev.kind == CLOUD_AGG:
                fusions += 1
                # weight every edge by the cohort that actually trained
                # this window (== full membership except fedavg-random)
                alphas = {k: self._edge_alpha(div, trust, cohort[k])
                          for k in groups}
                with tm.span("cloud_agg", round=fusions - 1,
                             n_edges=len(groups)):
                    theta, server_state, delta = self._cloud_fuse(
                        method, edge_theta, alphas, theta, server_opt,
                        server_state)
                self._anchor = theta
                for k in groups:       # broadcast fused model to edges
                    edge_theta[k] = theta
                    version[k] += 1
                self.trace.log(t, CLOUD_AGG, round=fusions - 1,
                               n_edges=len(groups))
                if (fusions - 1) % eval_every == 0 \
                        or fusions == global_rounds:
                    self._record_eval(history, fusions - 1, t, theta,
                                      window_losses, delta, log,
                                      f"async/{method}")
                    # reset only once recorded, so with eval_every > 1
                    # the loss covers every window since the last eval
                    window_losses = []
                if self.pop is not None:
                    self.pop.end_round(fusions - 1)
                tm.end_round(fusions - 1, sim_time_s=t)
                if delta <= fc.xi:
                    break
                if fusions < global_rounds:
                    if self.pop is not None:
                        self.pop.begin_round(fusions, t=t)
                    cohort = sample_cohort()   # next window's active set
                    for k in groups:           # wake newly-sampled idlers
                        ready = [n for n in cohort[k] if states[n].idle
                                 and self.churn.is_online(n, t)]
                        if ready:
                            self._dispatch(ready, k, t, edge_theta[k],
                                           version[k], states, queue)
                        for n in cohort[k]:
                            if states[n].idle and n not in ready:
                                queue.push(Event(
                                    self.churn.next_online(n, t),
                                    REJOIN, n, k))
                    queue.push(Event(t + period, CLOUD_AGG))
        return self._finish_history(history, theta, client_losses)

    # ------------------------------------------------------------------
    def _dispatch(self, ready: List[int], k: int, t: float, theta_k,
                  version_k: int, states, queue) -> None:
        fed = self.fed
        with tm.span("local_steps", edge=k, n_clients=len(ready)):
            locals_, _, loss_map = fed._edge_round(
                ready, theta_k, self._steps, self._iters,
                use_split=self._use_split_dyn,
                prox_anchor=(self._anchor if self._method == "fedprox"
                             else None))
        for lora_n, n in zip(locals_, ready):
            fault = self._sample_fault(n, states[n].dispatches)
            dur = self._round_seconds(n, self._use_split_dyn, self._steps,
                                      k, states[n].rounds_run)
            f_n = self.churn.finish_time(n, t, dur)
            if self.pop is not None:
                self.pop.pin(n)
            states[n].dispatch(t, f_n, version_k, states[n].rounds_run)
            if fault is not None and fault.kind == "crash":
                t_c = t + fault.at_frac * max(f_n - t, 0.0)
                queue.push(Event(t_c, CRASH, n, k))
            else:
                if fault is not None and fault.kind == "corrupt":
                    lora_n = corrupt_update(theta_k, lora_n, fault)
                queue.push(Event(f_n, ARRIVAL, n, k,
                                 payload=(lora_n, loss_map[n], fault)))
            self.trace.log(t, DISPATCH, n, k, version=version_k)


SCHEDULERS = {"sync": SyncScheduler, "deadline": DeadlineScheduler,
              "async": AsyncScheduler}
