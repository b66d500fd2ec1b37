"""End-to-end ELSA federation simulation (Alg. 1) plus FL baselines.

Runs the real machinery end to end: behavioral fingerprinting on a public
probe set, trust scoring, latency-aware spectral clustering, per-client
dynamic splits, split training through the SS-OP∘sketch channel, edge
FedAvg, and coherence/trust-weighted cloud fusion with the Eq. 16 stopping
rule.  ``FedConfig.model`` names any architecture registered in
:mod:`repro_torch.models.split_api`.

The counterpart of the JAX package's ``repro/federation/simulation.py``,
with both of its backends: ``backend="batched"`` (the default) runs each
local round through :class:`~repro_torch.federation.engine.BatchedEngine`
over the cohort's stacked clients, with one host sync a round;
``backend="reference"`` is the sequential loop, one client at a time, an
eager autograd step and a host sync per local step.  On a CUDA device
every step runs the hand-written kernels (the LoRA projections, flash
attention, and the channel's SS-OP, scatter and gather, forward and
backward).  ``run(runtime=RuntimeConfig(...))`` hands the run to the
event-driven :class:`~repro_torch.runtime.EdgeRuntime` (sync, deadline
and async policies over a simulated clock, with churn and fault traces).
``FedConfig(screen=True)`` screens every cohort's updates before the edge
aggregates them and keeps a live trust EMA per client
(:mod:`repro_torch.core.screening`); ``run(checkpoint=, resume_from=)``
snapshots the whole federation state each round and resumes a killed run
bit-identically (:mod:`repro_torch.checkpoint.federation`);
``run(population=PopulationConfig(registered=N))`` streams a registered
population of ``N`` client identities through the ``n_clients`` slots, a
sampled cohort a round, each identity with its own data, batch stream,
trust and SS-OP rotation (:mod:`repro_torch.population`).  Not ported
yet, and raising ``NotImplementedError`` that names the ROADMAP.md item:
``mesh=`` (queue 8).

Entry points take ``device`` and default to ``"cuda"``; the CPU runs only
when a caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import telemetry as tm
from repro_torch.core import aggregation as agg
from repro_torch.core import clustering as clus
from repro_torch.core import splitting as split_mod
from repro_torch.core.fingerprint import divergence_matrix, fingerprint
from repro_torch.core.screening import (ScreeningConfig, TrustLedger,
                                        screen_and_aggregate, screen_updates)
from repro_torch.core.sketch import make_plan
from repro_torch.core.split_training import (Channel, Split, loss_and_grad,
                                             split_loss)
from repro_torch.core.ssop import (make_ssop, make_ssop_from_basis,
                                   semantic_subspace)
from repro_torch.core.trust import trust_scores
from repro_torch.data.pipeline import CountingIterator, infinite_batches
from repro_torch.data.probe import make_probe_set
from repro_torch.data.synthetic import (SyntheticTaskConfig,
                                        make_federation_data, make_test_set)
from repro_torch.federation.engine import (BatchedEngine, _not_ported,
                                           is_client_map, screen_stats)
from repro_torch.federation.topology import make_topology
from repro_torch.models.params import init_tree
from repro_torch.models.split_api import get_split_model
from repro_torch.optim import (FedAdam, FedAMS, adapter_head_lr_tree,
                               clip_by_global_norm, fedprox_gradient)
from repro_torch.optim.optimizers import tree_map


@dataclasses.dataclass
class FedConfig:
    n_clients: int = 20
    n_edges: int = 4
    alpha: float = 0.1                   # Dirichlet concentration
    poisoned: tuple = (3, 8, 12, 17)     # 4 unreliable clients (§IV.A)
    total_examples: int = 4000
    batch_size: int = 16
    t_rounds: int = 2                    # client-edge rounds per global agg
    probe_q: int = 32
    tau_max: float = 200.0
    gamma: float = 1.0
    w_min: float = 0.25
    lr: float = 5e-3
    ssop_r: int = 8
    sketch_y: int = 3
    sketch_z: int = 0                    # 0 -> derive from rho
    rho: float = 2.1
    xi: float = 1e-4                     # Eq. 16 threshold
    local_warmup_steps: int = 10         # steps before fingerprinting
    seed: int = 0
    num_classes: int = 4
    use_channel: bool = True
    use_ssop: bool = True
    model: str = "bert-base"             # split-model registry name
    layers: Optional[int] = None         # reduced-model depth (None -> 8)
    bert_layers: Optional[int] = None    # DEPRECATED: use ``layers=``
    seq_len: int = 24                    # synthetic-task sequence length
    class_sharpness: float = 4.0         # synthetic-task separability
    background_frac: float = 0.5         # synthetic-task noise fraction
    cls_token: int = -1                  # >= 0: constant [CLS] at pos 0
    constrained_frac: float = 0.0        # fraction of slow/throttled devices
    dtype: str = "float32"               # params+activations; parity tests
                                         # use float64
    # -- convergence stack ------------------------------------------------
    aggregate: str = "product"           # "product" | "factor"
    clip_norm: float = 0.0               # >0: per-client global-norm clip
    head_lr: float = 0.0                 # >0: readout-head lr; 0 -> ``lr``
    server_opt: str = "none"             # "none" | "fedadam" | "fedams"
    server_lr: float = 0.05              # server-opt lr
    pooling: str = "cls"                 # encoder readout: "cls" | "mean"
    vocab_size: int = 0                  # >0: override the model vocab
    # -- update screening; off by default and bit-inert when off ---------
    screen: bool = False                 # server-side update screening
    screen_norm_k: float = 4.0           # reject ||delta|| > k * median
    screen_cos_min: float = -0.5         # reject cos(delta, cohort mean)
                                         # below this (sign-flip catch)
    screen_trust_beta: float = 0.7       # trust-EMA retention
    screen_trust_floor: float = 0.15     # exclude trust EMA below this
    screen_min_cohort: int = 2           # fewer survivors -> trimmed mean
    screen_trim_frac: float = 0.25       # fallback per-side trim fraction

    def __post_init__(self):
        if self.aggregate not in ("product", "factor"):
            raise ValueError(f"unknown aggregate mode {self.aggregate!r}")
        if not 0.0 <= self.screen_trust_beta <= 1.0:
            raise ValueError("screen_trust_beta must be in [0, 1], "
                             f"got {self.screen_trust_beta}")
        if not 0.0 <= self.screen_trim_frac < 0.5:
            raise ValueError("screen_trim_frac must be in [0, 0.5), "
                             f"got {self.screen_trim_frac}")
        if self.server_opt not in ("none", "fedadam", "fedams"):
            raise ValueError(f"unknown server_opt {self.server_opt!r}")
        if self.pooling not in ("cls", "mean"):
            raise ValueError(f"unknown pooling {self.pooling!r}")
        if self.bert_layers is not None and self.layers != self.bert_layers:
            warnings.warn(
                "FedConfig.bert_layers is deprecated; use FedConfig.layers "
                "(the federation is model-agnostic now)",
                DeprecationWarning, stacklevel=3)
            if self.layers is None:
                self.layers = self.bert_layers
        if self.layers is None:
            self.layers = 8
        self.bert_layers = self.layers   # keep legacy readers consistent


class Federation:
    """Simulation harness; ``run(method)`` with method in
    {'elsa', 'elsa-fixed', 'elsa-nocluster', 'fedavg', 'fedavg-random',
    'fedprox', 'fedams', 'vanilla'}.

    ``backend="batched"`` (the default, as in the JAX package) runs local
    training through the batched engine; ``backend="reference"`` is the
    sequential eager loop (the parity baseline).  The weights are drawn
    on ``device`` from a ``torch.Generator`` seeded with
    ``FedConfig.seed``; everything else (data, probes, topology, splits,
    sketch plan, SS-OP rotations) is drawn by numpy exactly as the JAX
    package draws it."""

    def __init__(self, fed: FedConfig = FedConfig(),
                 backend: str = "batched", mesh=None, device="cuda"):
        if backend not in ("batched", "reference"):
            raise ValueError(f"unknown backend {backend!r}")
        if mesh is not None:
            raise _not_ported("mesh= (the multi-GPU engine)", "queue 8")
        self.backend = backend
        self.fed = fed
        self.device = torch.device(device)
        overrides = {}
        if fed.vocab_size:
            overrides["vocab_size"] = fed.vocab_size
        self.model = get_split_model(fed.model, num_layers=fed.layers,
                                     dtype=fed.dtype,
                                     pooling=(fed.pooling
                                              if fed.pooling != "cls"
                                              else None),
                                     **overrides)
        self.cfg = self.model.cfg
        self.task = SyntheticTaskConfig(vocab_size=self.cfg.vocab_size,
                                        num_classes=fed.num_classes,
                                        seq_len=fed.seq_len,
                                        class_sharpness=fed.class_sharpness,
                                        background_frac=fed.background_frac,
                                        cls_token=fed.cls_token,
                                        seed=fed.seed)
        self.topo = make_topology(fed.n_clients, fed.n_edges,
                                  constrained_frac=fed.constrained_frac,
                                  seed=fed.seed)
        self.data = make_federation_data(
            self.task, fed.n_clients, fed.total_examples, fed.alpha,
            poisoned_clients=fed.poisoned, seed=fed.seed,
            task_kind=self.model.task)
        self.test_tokens, self.test_labels = make_test_set(self.task, 512,
                                                           seed=fed.seed + 7)
        self.probe = make_probe_set(self.task, fed.probe_q, seed=fed.seed + 3)
        self.policy = split_mod.SplitPolicy(
            num_blocks=self.cfg.num_layers, o_fix=2, p_min=1,
            p_max=min(5, self.cfg.num_layers - 3))
        self.splits = split_mod.splits_for_population(
            self.topo.capacity, self.topo.bandwidth, self.policy)

        gen = torch.Generator(device=self.device).manual_seed(fed.seed)
        tree = init_tree(self.model.specs(fed.num_classes), gen,
                         getattr(torch, fed.dtype), self.device)
        self.frozen, self.lora0 = tree["frozen"], tree["lora"]

        d = self.cfg.d_model
        z = fed.sketch_z or max(4, int(d / (fed.rho * fed.sketch_y)))
        self.plan = make_plan(d, fed.sketch_y, z, seed=fed.seed + 11,
                              device=self.device)
        # identity-keyed channels (identity == slot without a bound
        # population; with one, channel_for routes through the
        # population's identity LRU and this dict stays empty)
        self._channels: Dict[int, Channel] = {}
        self._ref_basis = None
        self._engine: Optional[BatchedEngine] = None

        self.screening = ScreeningConfig(
            norm_k=fed.screen_norm_k, cos_min=fed.screen_cos_min,
            trust_floor=fed.screen_trust_floor,
            min_cohort=fed.screen_min_cohort,
            trim_frac=fed.screen_trim_frac)
        self.trust_ledger = TrustLedger(fed.n_clients,
                                        beta=fed.screen_trust_beta)
        self.screen_log: List = []           # one ScreenReport a pass
        # registry-backed population binding, installed by
        # run(population=) and the runtime schedulers
        self._population = None

    @property
    def engine(self) -> BatchedEngine:
        """The batched backend's round executor, built at first use."""
        if self._engine is None:
            self._engine = BatchedEngine(
                self.model, self.frozen, lr=self.fed.lr,
                batch_size=self.fed.batch_size,
                head_lr=self.fed.head_lr or None,
                clip_norm=self.fed.clip_norm, device=self.device)
        return self._engine

    def _tokens(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a)).to(self.device, torch.int64)

    def server_optimizer(self, method: str):
        """Cloud pseudo-gradient optimizer: ``FedConfig.server_opt``
        overrides the method default; ``method="fedams"`` keeps
        FedAMS(lr=1.0)."""
        fed = self.fed
        if fed.server_opt == "fedadam":
            return FedAdam(lr=fed.server_lr)
        if fed.server_opt == "fedams":
            return FedAMS(lr=fed.server_lr)
        return FedAMS(lr=1.0) if method == "fedams" else None

    def _default_split(self) -> Split:
        return Split(self.policy.p_max,
                     self.cfg.num_layers - self.policy.p_max - 2, 2)

    def split_for(self, client: int, use_split: bool = True) -> Split:
        """The tripartite split client ``client`` trains."""
        return (Split(*self.splits[client]) if use_split
                else self._default_split())

    def client_weight(self, client: int) -> int:
        """FedAvg weight: the example count of the client currently
        occupying slot ``client`` (with a bound population the occupant
        is whatever registered id the round's cohort mapped there)."""
        if self._population is not None:
            return self._population.slot_weight(client)
        return len(self.data[client].tokens)

    def _bind_population(self, population):
        """Attach a registry-backed population for this run.  Accepts a
        :class:`~repro_torch.population.PopulationConfig` (builds the
        runtime) or a prebuilt
        :class:`~repro_torch.population.PopulationRuntime`; ``None``
        detaches."""
        if population is None:
            self._population = None
            return None
        from repro_torch.population import (PopulationConfig,
                                            PopulationRuntime)
        if isinstance(population, PopulationConfig):
            population = PopulationRuntime(self, population)
        elif not isinstance(population, PopulationRuntime):
            raise TypeError(
                f"population must be a PopulationConfig or "
                f"PopulationRuntime, got {type(population).__name__}")
        if population.federation is not self:
            raise ValueError("population is bound to a different federation")
        self._population = population
        return population

    # ------------------------------------------------------------------
    def channel_for(self, client: int, lora, emb=None) -> Channel:
        """Lazily build the client's SS-OP∘sketch channel.

        Channels are keyed by client *identity*: with a bound population
        ``client`` is a slot index and the call resolves through the
        population's identity-keyed channel LRU (the slot's occupant);
        without one, identity == slot and the channel lives in
        ``_channels``.  ``emb`` lets callers share one probe forward
        across clients that create their channels from the same lora."""
        if not self.fed.use_channel:
            return Channel(None, None)
        if self._population is not None:
            return self._population.channel_for_slot(client)
        if client not in self._channels:
            if emb is None:
                emb = self._probe_embeddings(lora)
            ss = (make_ssop(emb, self.fed.ssop_r, "elsa-salt", client)
                  if self.fed.use_ssop else None)
            self._channels[client] = Channel(ss, self.plan)
        return self._channels[client]

    @torch.no_grad()
    def _probe_embeddings(self, lora):
        return self.model.probe_repr(self.frozen, lora,
                                     self._tokens(self.probe))

    def _reference_basis(self):
        """Shared semantic basis for identity-keyed channels: top-r SVD
        of the *reference model's* probe embeddings, computed once.
        Channels without a population are built from ``lora0``'s
        embeddings too (elsa profiles from ``lora0``; the plain loops
        build at round 0, where theta is ``lora0``), so the fixed basis
        keeps an identity cohort bit-inert, and an evicted identity's
        channel regenerates bit-exactly whenever it returns."""
        if self._ref_basis is None:
            self._ref_basis = semantic_subspace(
                self._probe_embeddings(self.lora0), self.fed.ssop_r)
        return self._ref_basis

    def _build_identity_channel(self, cid: int) -> Channel:
        """One registered identity's channel: shared reference basis +
        its own seeded rotation (Eq. 18 keyed on the id)."""
        ss = (make_ssop_from_basis(self._reference_basis(), "elsa-salt",
                                   cid)
              if self.fed.use_ssop else None)
        return Channel(ss, self.plan)

    # ------------------------------------------------------------------
    def _grad_fn(self, client: int, split: Split):
        """``(lora, batch, channel) -> (loss, grads)`` of client
        ``client``'s split loss, by autograd."""
        def loss(lp, batch, channel):
            return split_loss(self.model, self.frozen, lp, batch, split,
                              channel)
        return lambda lora, batch, channel: loss_and_grad(loss, lora, batch,
                                                          channel)

    def client_steps(self, client: int, lora, n_steps: int,
                     it, use_split=True, prox_anchor=None):
        """Run local training steps; returns (lora, mean loss).  One host
        sync per step (the loss)."""
        fed = self.fed
        split = self.split_for(client, use_split)
        channel = self.channel_for(client, lora)
        gfn = self._grad_fn(client, split)
        lrs = adapter_head_lr_tree(lora, fed.lr, fed.head_lr or None)
        losses = []
        for _ in range(n_steps):
            tok, lab = next(it)
            batch = {"tokens": self._tokens(tok),
                     "labels": torch.from_numpy(lab).to(self.device)}
            lv, g = gfn(lora, batch, channel)
            with torch.no_grad():
                if prox_anchor is not None:
                    g = fedprox_gradient(g, lora, prox_anchor, 0.01)
                if fed.clip_norm > 0:
                    g = clip_by_global_norm(g, fed.clip_norm)
                lora = tree_map(lambda p, gg, s: p - s * gg, lora, g, lrs)
            losses.append(float(lv))
        return lora, float(np.mean(losses))

    def group_steps(self, clients, theta, n_steps: int, iters,
                    use_split=True, prox_anchor=None, per_client=None):
        """Run one local round for a client group on the active backend.
        ``theta`` is one shared LoRA tree or a ``{client: tree}`` map
        (``per_client``; by default sniffed with
        :func:`~repro_torch.federation.engine.is_client_map`).  Returns
        ``{client: (lora, mean loss)}``.  The batched backend runs the
        group through the engine, its buckets stacked by split; the
        reference backend runs ``client_steps`` for each client in
        turn."""
        if per_client is None:
            per_client = is_client_map(theta)
        if self.backend != "batched":
            return {n: self.client_steps(n, theta[n] if per_client
                                         else theta, n_steps, iters[n],
                                         use_split=use_split,
                                         prox_anchor=prox_anchor)
                    for n in clients}
        splits = {n: self.split_for(n, use_split) for n in clients}
        # every missing channel derives from the same theta -> one probe
        # forward shared across the clients (per-client thetas share it
        # too when they are one object)
        emb = None
        shared = (theta if not per_client
                  else (theta[clients[0]]
                        if len({id(theta[n]) for n in clients}) == 1
                        else None))
        if self.fed.use_channel and self._population is None and \
                shared is not None and \
                any(n not in self._channels for n in clients):
            emb = self._probe_embeddings(shared)
        channels = {n: self.channel_for(n, theta[n] if per_client
                                        else theta, emb=emb)
                    for n in clients}
        batches = {n: [next(iters[n]) for _ in range(n_steps)]
                   for n in clients}
        return self.engine.run_clients(theta, clients, splits, channels,
                                       batches, prox_anchor=prox_anchor,
                                       per_client_theta=per_client)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, lora) -> float:
        logits = self.model.forward(self.frozen, lora,
                                    self._tokens(self.test_tokens))[1]
        return self.model.accuracy(logits, self.test_tokens,
                                   self.test_labels)

    # ------------------------------------------------------------------
    def profile_clients(self):
        """Phase 1: warm up each client locally, fingerprint it on the
        probes, score trust, cluster.  The warm-up of all clients is one
        ``group_steps`` round on the active backend (they share the
        default split)."""
        fed = self.fed
        iters = {n: infinite_batches(self.data[n].tokens,
                                     self.data[n].labels, fed.batch_size,
                                     seed=fed.seed + n)
                 for n in range(fed.n_clients)}
        clients = list(range(fed.n_clients))
        res = self.group_steps(clients, self.lora0, fed.local_warmup_steps,
                               iters, use_split=False)
        warm_loras = {n: res[n][0] for n in clients}
        embs = [self._probe_embeddings(warm_loras[n]) for n in clients]
        fps = [fingerprint(embs[n]) for n in clients]
        norms = [torch.linalg.vector_norm(embs[n], dim=-1).cpu().numpy()
                 for n in clients]
        div = divergence_matrix(fps)
        trust = trust_scores(div, np.stack(norms))
        result = clus.cluster_clients(div, trust, self.topo.latency,
                                      tau_max=fed.tau_max, gamma=fed.gamma,
                                      w_min=fed.w_min, seed=fed.seed)
        return div, trust, result, warm_loras

    # ------------------------------------------------------------------
    def _assign_groups(self, method: str, rng):
        """Phase-1 edge assignment: returns ``(groups, div, trust)``."""
        fed = self.fed
        use_cluster = method in ("elsa", "elsa-fixed")
        if method in ("elsa", "elsa-fixed", "elsa-nocluster"):
            div, trust, cres, _ = (self.profile_clients() if use_cluster
                                   else (None, None, None, None))
            if not use_cluster:   # random assignment ablation
                groups = {k: [] for k in range(fed.n_edges)}
                for n in range(fed.n_clients):
                    groups[rng.integers(0, fed.n_edges)].append(n)
                div = np.ones((fed.n_clients, fed.n_clients))
                np.fill_diagonal(div, 0)
                trust = np.ones(fed.n_clients)
            else:
                groups = {k: v for k, v in cres.groups.items()}
                if cres.escalated:
                    # Stage 4(ii): escalate to cloud-level aggregation
                    groups[-1] = list(cres.escalated)
                if not any(groups.values()):
                    # degenerate clustering: fall back to latency assignment
                    groups = {k: [] for k in range(fed.n_edges)}
                    for n in range(fed.n_clients):
                        groups[int(np.argmin(self.topo.latency[n]))].append(n)
        else:
            groups = {0: list(range(fed.n_clients))}
            div = np.zeros((fed.n_clients, fed.n_clients))
            trust = np.ones(fed.n_clients)
        # the screening ledger starts from the clustering-time trust
        self.trust_ledger.seed(trust)
        return groups, div, trust

    def _edge_round(self, active, theta_k, steps: int, iters, *,
                    use_split: bool = True, prox_anchor=None):
        """One local round for ``active`` clients from edge model
        ``theta_k``; returns ``(locals_, weights, {client: loss})``."""
        res = self.group_steps(active, theta_k, steps, iters,
                               use_split=use_split, prox_anchor=prox_anchor)
        locals_ = [res[n][0] for n in active]
        weights = [self.client_weight(n) for n in active]
        losses = {n: res[n][1] for n in active}
        return locals_, weights, losses

    # -- update screening ----------------------------------------------
    def _screen_identities(self, clients):
        """(ledger, keys) for one screening pass.  With a bound
        population, verdicts are recorded against client *identities*:
        each slot resolves to its pinned dispatch-time id, so a straggler
        arriving after a cohort swap credits or blames the identity that
        trained, never the slot's new occupant, through the
        identity-keyed ledger facade.  Without one, identity == slot and
        the slot ledger is used directly."""
        if self._population is None:
            return self.trust_ledger, list(clients)
        pop = self._population
        return pop.ledger_view, [pop.pinned(int(n)) for n in clients]

    def screened_aggregate(self, clients, trees, weights, base):
        """Edge aggregation with the optional screening stage.

        With ``FedConfig.screen`` off this IS
        ``agg.aggregate_adapters(trees, weights)``: the same call, the
        same floats.  With it on, updates are screened against ``base``
        (the model they were dispatched from), the trust EMA is updated
        from the verdicts, survivors are trust-down-weighted, and an
        over-screened cohort falls back to the trimmed mean
        (:mod:`repro_torch.core.screening`)."""
        if not self.fed.screen:
            return agg.aggregate_adapters(trees, weights,
                                          mode=self.fed.aggregate)
        ledger, keys = self._screen_identities(clients)
        out, report = screen_and_aggregate(
            base, trees, weights, keys, ledger,
            self.screening, mode=self.fed.aggregate, stats_fn=screen_stats)
        self.screen_log.append(report)
        return out

    def screen_cohort(self, clients, trees, weights, base):
        """Screening without aggregation, for schedulers that combine
        arrivals with an anchor term (the deadline policy): returns the
        surviving ``(trees, weights)`` with trust-scaled weights.  A
        fully-screened-out cohort returns empty lists; the caller's
        anchor then carries the round."""
        if not self.fed.screen:
            return list(trees), list(weights)
        ledger, keys = self._screen_identities(clients)
        report = screen_updates(base, trees, weights, keys,
                                ledger, self.screening,
                                stats_fn=screen_stats)
        self.screen_log.append(report)
        kept_trees = [trees[i] for i in report.kept]
        kept_wts = [float(weights[i]) * ledger.weight(keys[i])
                    for i in report.kept]
        return kept_trees, kept_wts

    def fusion_trust(self, trust, members) -> float:
        """Mean trust feeding an edge's cloud-fusion weight (Eq. 14): the
        live screening EMA when screening is on, the static
        clustering-time scores otherwise."""
        if self.fed.screen:
            return float(np.mean(self.trust_ledger.scores[list(members)]))
        return float(np.mean(trust[list(members)]))

    # ------------------------------------------------------------------
    def run(self, method: str = "elsa", global_rounds: int = 10,
            steps_per_round: int = 4, eval_every: int = 1,
            log: bool = False, runtime=None, checkpoint=None,
            resume_from: Optional[str] = None, population=None) -> Dict:
        """Run the federation; returns the history ``{"round",
        "accuracy", "loss", "delta", "final_accuracy", "client_losses"}``
        and leaves the final LoRA in ``last_theta``.

        ``runtime=None`` runs the round-synchronous loop (no wall-clock
        model).  A :class:`repro_torch.runtime.RuntimeConfig` hands the run
        to the event-driven :class:`repro_torch.runtime.EdgeRuntime`: the
        history gains a simulated ``time`` axis, the ``policy`` and an
        event ``trace``; with ``policy="sync"`` and no churn or faults the
        training math, and so the history, is this loop's.

        ``checkpoint`` (a :class:`repro_torch.checkpoint.CheckpointConfig`)
        snapshots the full federation state on a rolling cadence;
        ``resume_from`` (a checkpoint file or its directory) restores one
        and continues, bit-identically to the uninterrupted run on this
        loop and the sync runtime policy.

        ``population`` (a :class:`repro_torch.population.PopulationConfig`
        or a bound :class:`~repro_torch.population.PopulationRuntime`)
        decouples the registered client population from the
        ``n_clients`` slots: each round samples a cohort of registered
        ids into the slots.  With ``registered == n_clients`` the run is
        bit-identical to ``population=None``."""
        if runtime is not None:
            from repro_torch.runtime import EdgeRuntime
            return EdgeRuntime(self, runtime).run(
                method, global_rounds=global_rounds,
                steps_per_round=steps_per_round, eval_every=eval_every,
                log=log, checkpoint=checkpoint, resume_from=resume_from,
                population=population)
        from repro_torch.checkpoint import federation as fedckpt
        fed = self.fed
        rng = np.random.default_rng(fed.seed + 5)
        history = {"round": [], "accuracy": [], "loss": [], "delta": []}
        use_split_dyn = method not in ("elsa-fixed",)
        pop = self._bind_population(population)
        iters = pop.iters if pop is not None else \
            {n: CountingIterator(
                 infinite_batches(self.data[n].tokens,
                                  self.data[n].labels, fed.batch_size,
                                  seed=fed.seed + 100 + n))
             for n in range(fed.n_clients)}
        server_opt = self.server_optimizer(method)

        start_round, last_delta = 0, float("inf")
        if resume_from is not None:
            state = fedckpt.load_state(fedckpt.resolve(resume_from))
            res = fedckpt.restore_run(self, state, method=method,
                                      steps_per_round=steps_per_round,
                                      iters=iters, rng=rng, population=pop)
            groups, div, trust = res.groups, res.div, res.trust
            theta, server_state = res.theta, res.server_state
            history, client_losses = res.history, res.client_losses
            start_round, last_delta = res.round_idx + 1, res.delta
        else:
            with tm.span("profile", method=method):
                groups, div, trust = self._assign_groups(method, rng)
            if pop is not None:
                pop.after_assign(groups)
            theta = self.lora0
            server_state = server_opt.init(theta) if server_opt else None
            client_losses: Dict[int, List[float]] = {
                n: [] for n in range(fed.n_clients)}
        ckpt = fedckpt.Checkpointer(checkpoint) if checkpoint else None
        if last_delta <= fed.xi:
            # the checkpointed run had already converged (Eq. 16)
            history["final_accuracy"] = history["accuracy"][-1]
            history["client_losses"] = client_losses
            self.last_theta = theta
            return history
        for g in range(start_round, global_rounds):
            if pop is not None:
                pop.begin_round(g)
            edge_thetas, edge_alphas, losses = {}, {}, []
            actives = {}
            for k, members in groups.items():
                if not members:
                    continue
                active = members
                if method == "fedavg-random":
                    m = max(1, len(members) // 2)
                    active = list(rng.choice(members, m, replace=False))
                actives[k] = active
            anchor = theta if method == "fedprox" else None
            for k, active in actives.items():
                theta_k = theta
                for _ in range(fed.t_rounds):
                    with tm.span("local_steps", round=g, edge=k,
                                 n_clients=len(active)):
                        locals_, weights, loss_map = self._edge_round(
                            active, theta_k, steps_per_round, iters,
                            use_split=use_split_dyn, prox_anchor=anchor)
                    for n in active:
                        losses.append(loss_map[n])
                        client_losses[n].append(loss_map[n])
                    if pop is not None:
                        pop.note_updates(active, locals_, theta_k)
                    with tm.span("edge_agg", round=g, edge=k,
                                 n_updates=len(active)):
                        theta_k = self.screened_aggregate(
                            active, locals_, weights, theta_k)
                edge_thetas[k] = theta_k
            for k, active in actives.items():
                edge_alphas[k] = agg.edge_weight(
                    agg.mean_pairwise_kld(div, active),
                    self.fusion_trust(trust, active))

            with tm.span("cloud_agg", round=g, n_edges=len(edge_thetas)):
                with torch.no_grad():
                    if method in ("elsa", "elsa-fixed", "elsa-nocluster"):
                        theta_new = agg.cloud_aggregate(
                            edge_thetas, edge_alphas, mode=fed.aggregate)
                    else:
                        ws = {k: 1.0 for k in edge_thetas}
                        theta_new = agg.cloud_aggregate(
                            edge_thetas, ws, mode=fed.aggregate)
                    if server_opt is not None:
                        pseudo = tree_map(lambda a, b: a - b, theta,
                                          theta_new)
                        theta_new, server_state = server_opt.update(
                            theta, pseudo, server_state)
                delta = agg.global_delta(theta_new, theta)
            theta = theta_new
            if g % eval_every == 0 or g == global_rounds - 1:
                with tm.span("eval", round=g):
                    acc = self.evaluate(theta)
                history["round"].append(g)
                history["accuracy"].append(acc)
                history["loss"].append(float(np.mean(losses)))
                history["delta"].append(delta)
                if log:
                    print(f"[{method}] round {g}: acc={acc:.4f} "
                          f"loss={np.mean(losses):.4f} delta={delta:.2e}")
            if pop is not None:
                # write the round's outcomes back before any snapshot so
                # a resume sees the post-round registry
                pop.end_round(g)
            if ckpt is not None and ckpt.due(g, global_rounds - 1, delta,
                                            fed.xi):
                ckpt.save(g, fedckpt.build_state(
                    self, method=method, steps_per_round=steps_per_round,
                    round_idx=g, theta=theta, server_state=server_state,
                    rng=rng, iters=iters, history=history,
                    client_losses=client_losses, groups=groups, div=div,
                    trust=trust, delta=delta, population=pop))
            tm.end_round(g)
            if delta <= fed.xi:
                break
        history["final_accuracy"] = history["accuracy"][-1]
        history["client_losses"] = client_losses
        self.last_theta = theta           # final aggregated LoRA (parity)
        return history
