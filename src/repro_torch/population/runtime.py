"""PopulationRuntime: binds a registry + sampler to a live Federation (the
counterpart of the JAX package's ``repro/population/runtime.py``).

The federation's machinery is slot-indexed (``n_clients`` slots:
topology, splits, engine buckets, channels, trust ledger).  This binding
streams registered client *identities* through those slots, one cohort
per round:

- ``begin_round(g)`` samples the cohort, installs the slot->id map, and
  gathers registry trust into the slot-level
  :class:`~repro_torch.core.screening.TrustLedger`;
- during the round, the federation sees the occupants transparently:
  :class:`_IterProxy` resolves ``iters[slot]`` to the occupant's seeded
  batch stream (LRU-cached; evicted streams persist their cursor in the
  registry ``draws`` column and fast-forward bit-exactly on return) and
  ``Federation.client_weight`` reads the occupant's example count;
- ``note_updates`` scatters the trained LoRA deltas (vs the dispatch
  model) into the registry's sharded adapter column: the trees are
  flattened on the device into one matrix, copied to the host in one
  transfer, and subtracted there in float64 as the JAX package does;
- ``end_round(g)`` scatters trust/staleness/participation/cursors back.

Everything here but the channels' rotations and the adapter rows stays on
the host, as in the JAX package, and draws exactly its numpy streams:
cohorts, per-id data and batch streams are bit-identical across packages.

Client data: ids below ``n_clients`` reuse the federation's materialized
datasets by construction (the legacy generator draws every client from
one shared sequential RNG, so client ``n``'s data can never be
regenerated per id); ids at or beyond ``n_clients`` synthesize lazily from
the registry's per-id ``data_seed`` stream and live in an LRU.  With
``registered == n_clients`` every id hits the legacy datasets and the
identity cohort draws no RNG, which makes the binding bit-inert there.

Privacy channels and trust follow the *identity*, not the slot:

- :meth:`channel_for_slot` resolves a slot to its occupant and serves
  that identity's SS-OP channel from a bounded LRU.  The semantic basis
  ``U`` (SVD of the reference model's probe embeddings) is shared and
  computed once; the per-identity rotation ``V_n`` is seeded by
  ``Hash(salt || id)`` (Eq. 18), so two identities streaming through the
  same slot get distinct rotations and an evicted identity's channel
  regenerates bit-exactly on return (each build uploads its ``V_n``);
- :meth:`record_trust` / :meth:`trust_weight` attribute screening
  verdicts to an identity: in-cohort ids go through the slot-level
  ledger (and mirror into the registry ``trust`` column immediately),
  while a straggler whose slot was re-assigned applies the same EMA
  directly to its registry row.  ``screen_passes`` / ``screen_fails``
  count per-identity verdicts.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import telemetry as tm
from repro_torch.bridge import jax_leaf_order
from repro_torch.core.split_training import Channel
from repro_torch.data.pipeline import CountingIterator, infinite_batches
from repro_torch.data.synthetic import ClientData, make_task, sample_examples
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.population.registry import ClientRegistry
from repro_torch.population.sampler import CohortSampler, PopulationConfig


class _IterProxy:
    """``iters[slot]`` -> the current occupant's batch stream."""

    __slots__ = ("_pop",)

    def __init__(self, pop: "PopulationRuntime"):
        self._pop = pop

    def __getitem__(self, slot: int) -> CountingIterator:
        return self._pop.iter_for(int(self._pop.slot_to_id[slot]))


class _IdentityLedger:
    """Identity-keyed facade over the population's trust state, shaped
    like a :class:`~repro_torch.core.screening.TrustLedger` so
    ``screen_updates`` / ``screen_and_aggregate`` run unchanged with
    client *ids* in place of slot indices: ``record`` routes through
    :meth:`PopulationRuntime.record_trust` and ``scores`` is the registry
    ``trust`` column itself."""

    __slots__ = ("_pop",)

    def __init__(self, pop: "PopulationRuntime"):
        self._pop = pop

    @property
    def beta(self) -> float:
        return self._pop.federation.trust_ledger.beta

    @property
    def scores(self) -> np.ndarray:
        return self._pop.registry.trust

    def record(self, cid: int, passed: bool) -> None:
        self._pop.record_trust(cid, passed)

    def weight(self, cid: int) -> float:
        return self._pop.trust_weight(cid)


def _flat(tree) -> torch.Tensor:
    """One LoRA tree as a flat vector on its device, in the JAX package's
    leaf order."""
    return torch.cat([leaf.reshape(-1) for leaf in jax_leaf_order(tree)])


class PopulationRuntime:
    """One federation's registry-backed population."""

    def __init__(self, federation, cfg: PopulationConfig):
        fed = federation.fed
        if cfg.registered < fed.n_clients:
            raise ValueError(
                f"registered population ({cfg.registered}) must be >= the "
                f"federation's slot count (n_clients={fed.n_clients})")
        if cfg.cohort is not None and cfg.cohort != fed.n_clients:
            raise ValueError(
                f"cohort must equal the federation's n_clients slot count "
                f"({fed.n_clients}); got {cfg.cohort} — resize n_clients "
                "to change the per-round cohort")
        self.federation = federation
        self.cfg = cfg
        self.cohort = fed.n_clients
        self.adapter_dim = (sum(leaf.numel() for leaf in
                                tree_leaves(federation.lora0))
                            if cfg.store_adapters else 0)
        self.registry = ClientRegistry(
            cfg.registered, adapter_dim=self.adapter_dim,
            shard_rows=cfg.shard_rows, adapter_dtype=cfg.adapter_dtype,
            seed=fed.seed)
        self.sampler = CohortSampler(self.registry, cfg)
        self.slot_to_id = np.arange(self.cohort, dtype=np.int64)
        self.iters = _IterProxy(self)
        cap = cfg.data_cache or max(4 * self.cohort, 64)
        self._cache_cap = max(cap, self.cohort)
        self._data: "OrderedDict[int, ClientData]" = OrderedDict()
        self._iters: "OrderedDict[int, CountingIterator]" = OrderedDict()
        self._class_p = None           # synthesized-task unigrams, lazy
        self._inflight: Dict[int, int] = {}     # slot -> pinned id
        self._round_ids: Optional[np.ndarray] = None
        self._id_to_slot: Dict[int, int] = {
            i: i for i in range(self.cohort)}
        # identity-keyed SS-OP channel LRU (shared U basis, per-id V_n;
        # evictions regenerate bit-exactly from the identity's seed)
        self._channel_cap = max(cfg.channel_cache or self._cache_cap,
                                self.cohort)
        self._channels: "OrderedDict[int, Channel]" = OrderedDict()
        self._chan_hits = 0
        self._chan_misses = 0
        self._chan_evictions = 0
        self.ledger_view = _IdentityLedger(self)

    # -- per-client data ------------------------------------------------------
    def data_for(self, cid: int) -> ClientData:
        fed = self.federation
        if cid < fed.fed.n_clients:
            return fed.data[cid]
        d = self._data.get(cid)
        if d is None:
            d = self._synthesize(cid)
            self._data[cid] = d
            while len(self._data) > self._cache_cap:
                self._data.popitem(last=False)
        else:
            self._data.move_to_end(cid)
        return d

    def _synthesize(self, cid: int) -> ClientData:
        """Per-id dataset from the registry data-seed stream: its own
        Dirichlet class mix + the shared class-conditional unigrams."""
        fed = self.federation
        task = fed.task
        if self._class_p is None:
            self._class_p = make_task(task)
        rng = np.random.default_rng(int(self.registry.data_seed[cid]))
        props = rng.dirichlet([fed.fed.alpha] * task.num_classes)
        n_ex = max(8, fed.fed.total_examples // fed.fed.n_clients)
        labels = rng.choice(task.num_classes, size=n_ex, p=props)
        tokens = sample_examples(task, self._class_p, labels, rng)
        return ClientData(tokens=tokens, labels=labels.astype(np.int32))

    def iter_for(self, cid: int) -> CountingIterator:
        it = self._iters.get(cid)
        if it is None:
            fed = self.federation
            d = self.data_for(cid)
            it = CountingIterator(infinite_batches(
                d.tokens, d.labels, fed.fed.batch_size,
                seed=fed.fed.seed + 100 + cid))
            it.fast_forward(int(self.registry.draws[cid]))
            self._iters[cid] = it
            while len(self._iters) > self._cache_cap:
                old_cid, old_it = self._iters.popitem(last=False)
                self.registry.draws[old_cid] = old_it.count
        else:
            self._iters.move_to_end(cid)
        return it

    def slot_weight(self, slot: int) -> int:
        """FedAvg weight of the slot's current occupant."""
        return len(self.data_for(int(self.slot_to_id[slot])).tokens)

    # -- identity-keyed SS-OP channels ----------------------------------------
    def channel_for_slot(self, slot: int) -> Channel:
        """The SS-OP channel of the slot's *current occupant* — the
        privacy rotation travels with the identity, never the slot."""
        return self.channel_for_id(int(self.slot_to_id[int(slot)]))

    def channel_for_id(self, cid: int) -> Channel:
        fed = self.federation
        if not fed.fed.use_channel:
            return Channel(None, None)
        cid = int(cid)
        ch = self._channels.get(cid)
        if ch is None:
            self._chan_misses += 1
            ch = fed._build_identity_channel(cid)
            self._channels[cid] = ch
            while len(self._channels) > self._channel_cap:
                self._channels.popitem(last=False)
                self._chan_evictions += 1
        else:
            self._chan_hits += 1
            self._channels.move_to_end(cid)
        return ch

    def adopt_channel(self, cid: int, channel: Channel) -> None:
        """Install a deserialized channel (checkpoint restore) under its
        identity, honoring the LRU bound."""
        self._channels[int(cid)] = channel
        self._channels.move_to_end(int(cid))
        while len(self._channels) > self._channel_cap:
            self._channels.popitem(last=False)

    # -- identity-keyed trust attribution -------------------------------------
    def record_trust(self, cid: int, passed: bool) -> None:
        """Credit a screening verdict to the identity that trained the
        update: an in-cohort id records through the slot-level ledger
        (mirrored into the registry at once); a straggler whose slot was
        handed to someone else applies the EMA to its own registry row,
        and the new occupant's trust is untouched."""
        cid = int(cid)
        reg = self.registry
        slot = self._id_to_slot.get(cid)
        if slot is not None:
            ledger = self.federation.trust_ledger
            ledger.record(slot, passed)
            reg.trust[cid] = ledger.scores[slot]
        else:
            b = self.federation.trust_ledger.beta
            reg.trust[cid] = b * reg.trust[cid] \
                + (1.0 - b) * (1.0 if passed else 0.0)
        if passed:
            reg.screen_passes[cid] += 1
        else:
            reg.screen_fails[cid] += 1

    def trust_weight(self, cid: int) -> float:
        """The identity's current trust EMA (registry column)."""
        return float(self.registry.trust[int(cid)])

    # -- round lifecycle ------------------------------------------------------
    def after_assign(self, groups: Dict[int, List[int]]) -> None:
        """Seed registry columns from the clustering phase: the
        bootstrap cohort (ids 0..n_clients-1 in identity slots) carries
        its edge assignment and clustering-time trust into the
        registry."""
        fed = self.federation
        n = fed.fed.n_clients
        boot = np.arange(n, dtype=np.int64)
        self.registry.scatter(boot, trust=fed.trust_ledger.scores[:n])
        for k, members in groups.items():
            if members:
                m = np.asarray(members, np.int64)
                self.registry.scatter(m, edge=np.full(len(m), k, np.int32),
                                      cluster=np.full(len(m), k, np.int32))

    def begin_round(self, round_idx: int,
                    t: Optional[float] = None) -> np.ndarray:
        """Sample the cohort, install the slot->id map, load trust."""
        ids = self.sampler.sample(round_idx, self.cohort, t=t)
        self.slot_to_id = ids
        self._round_ids = ids
        self._id_to_slot = {int(c): s for s, c in enumerate(ids)}
        # registry trust -> slot ledger (float64 copies round-trip
        # exactly, so the identity cohort is bit-inert)
        self.federation.trust_ledger.scores = \
            self.registry.trust[ids].copy()
        if tm.enabled():
            tm.set_gauge("population.registered", self.registry.registered)
            tm.set_gauge("population.eligible", self.sampler.last_eligible)
            tm.set_gauge("population.sampled", len(ids))
            tm.set_gauge("population.registry_bytes", self.registry.nbytes)
        return ids

    @torch.no_grad()
    def note_updates(self, slots: Sequence[int], trees: Sequence,
                     base, ids: Optional[Sequence[int]] = None) -> None:
        """Scatter trained LoRA deltas (vs the dispatch model ``base``)
        into the registry's sharded adapter column.  ``base`` and the
        trees are flattened into one matrix on their device and copied
        out in one transfer; the deltas are then formed in float64, as
        the JAX package forms them."""
        if self.adapter_dim == 0 or not len(trees):
            return
        if ids is None:
            ids = [int(self.slot_to_id[s]) for s in slots]
        mat = torch.stack([_flat(base)] + [_flat(t) for t in trees])
        if mat.dtype == torch.bfloat16:
            mat = mat.float()
        host = mat.cpu().numpy().astype(np.float64)
        self.registry.scatter_adapters(np.asarray(ids, np.int64),
                                       host[1:] - host[0])

    def end_round(self, round_idx: int) -> None:
        """Scatter the round's outcomes back into the registry."""
        ids = self._round_ids
        if ids is None:
            return
        reg = self.registry
        ledger = self.federation.trust_ledger
        reg.scatter(ids, trust=ledger.scores[:len(ids)])
        prev = reg.last_round[ids]
        age = np.where(prev >= 0, round_idx - prev, 0).astype(np.float64)
        b = self.cfg.staleness_beta
        reg.staleness_ema[ids] = b * reg.staleness_ema[ids] + (1 - b) * age
        reg.last_round[ids] = round_idx
        reg.participations[ids] += 1
        for cid in ids:
            cid = int(cid)
            it = self._iters.get(cid)
            if it is not None:
                reg.draws[cid] = it.count
            d = self._data.get(cid)
            if d is not None or cid < self.federation.fed.n_clients:
                reg.n_examples[cid] = len(self.data_for(cid).tokens)
        if tm.enabled():
            tm.set_gauge("population.registry_bytes", reg.nbytes)
            tm.set_gauge("population.adapter_shards",
                         reg.allocated_shards)
            tm.set_gauge("population.channel_cache_size",
                         len(self._channels))
            tm.set_gauge("population.channel_cache_hits", self._chan_hits)
            tm.set_gauge("population.channel_cache_misses",
                         self._chan_misses)
            tm.set_gauge("population.channel_cache_evictions",
                         self._chan_evictions)

    # -- in-flight identity (deadline/async stragglers) -----------------------
    def pin(self, slot: int) -> int:
        """Record the slot's occupant at dispatch time, so a straggler
        completing after a cohort swap still writes back under the
        identity that trained it."""
        cid = int(self.slot_to_id[slot])
        self._inflight[slot] = cid
        return cid

    def pinned(self, slot: int) -> int:
        return self._inflight.get(int(slot), int(self.slot_to_id[slot]))

    def sync_draws(self) -> None:
        """Persist every live iterator cursor into the registry (called
        before checkpointing)."""
        for cid, it in self._iters.items():
            self.registry.draws[cid] = it.count

    # -- checkpoint plumbing --------------------------------------------------
    def state(self) -> Dict:
        """The population's checkpoint section, in the JAX package's
        layout: the cached identity channels carry ``u``, ``v`` and the
        JAX package's fused ``w = Vᵀ - I``, ``w_inv = V - I``."""
        self.sync_draws()
        chans = []
        for cid, ch in self._channels.items():
            ss = ch.ssop
            if ss is None:
                chans.append([int(cid), None])
                continue
            eye = torch.eye(ss.v.shape[0], dtype=ss.v.dtype,
                            device=ss.v.device)
            chans.append([int(cid), {"u": ss.u, "v": ss.v,
                                     "w": ss.v.T - eye,
                                     "w_inv": ss.v - eye}])
        return {
            "registered": self.cfg.registered,
            "seed": self.cfg.seed,
            "strategy": self.cfg.strategy,
            "registry": self.registry.state(),
            "slot_to_id": np.asarray(self.slot_to_id, np.int64),
            "channels": chans,
        }

    def load_state(self, state: Dict) -> None:
        """Restore :meth:`state`'s section (this package's or the JAX
        package's); the channels come back on the federation's device."""
        from repro_torch.core.ssop import SSOP
        for field in ("registered", "seed", "strategy"):
            if state[field] != getattr(self.cfg, field):
                raise ValueError(
                    f"population {field} mismatch: checkpoint has "
                    f"{state[field]!r}, this run {getattr(self.cfg, field)!r}")
        self.registry.load_state(state["registry"])
        self.slot_to_id = np.asarray(state["slot_to_id"], np.int64).copy()
        self._id_to_slot = {int(c): s
                            for s, c in enumerate(self.slot_to_id)}
        self._data.clear()
        self._iters.clear()
        self._inflight.clear()
        self._round_ids = None
        self._channels.clear()
        fed = self.federation
        plan = fed.plan if fed.fed.use_channel else None

        def dev(a):
            return torch.as_tensor(np.asarray(a)).to(fed.device)
        for cid, ss in state.get("channels", []):
            ssop = None if ss is None else SSOP(u=dev(ss["u"]),
                                                v=dev(ss["v"]))
            self.adopt_channel(int(cid), Channel(ssop, plan))
