"""Array-resident per-client state for the full registered population (the
counterpart of the JAX package's ``repro/population/registry.py``, copied:
numpy only, on the host, bit-equal columns and the same checkpoint state).

One :class:`ClientRegistry` row per registered client, held as
preallocated numpy columns (structure-of-arrays, not dict-of-objects):

==================  =========  ==============================================
column              dtype      meaning
==================  =========  ==============================================
``trust``           float64    screening trust EMA (:mod:`repro_torch.core.
                               screening`); seeded 1.0, synced with the
                               slot-level ``TrustLedger`` every round
``staleness_ema``   float64    EMA of rounds-between-participations
``last_round``      int64      last global round the client trained (-1 never)
``participations``  int64      completed participations
``draws``           int64      batch-stream cursor (``CountingIterator``
                               count), so an evicted iterator rebuilds
                               bit-exactly
``edge``            int32      edge group of the last assignment (-1 none)
``cluster``         int32      clustering-time cluster id (-1 none)
``data_seed``       uint64     per-client data-synthesis stream key
``n_examples``      int64      local dataset size (0 until first seen)
``avail_cursor``    int64      churn-trace interval cursor
                               (:class:`~repro_torch.population.sampler.
                               AvailabilityCursors`)
``screen_passes``   int64      screening verdicts credited to this
                               identity that passed (attribution follows
                               the pinned dispatch-time id, never the
                               slot's current occupant)
``screen_fails``    int64      screening verdicts credited to this
                               identity that failed
==================  =========  ==============================================

The LoRA adapter-delta column is a ``(registered, adapter_dim)`` matrix
stored as fixed-size row-block shards allocated on first touch: scalar
columns are O(registered) and tiny, while adapter memory grows with the
set of clients that actually trained (~ cohort x rounds), never with the
registered population — at 10^5 clients x ~0.9 M adapter floats
(full-width bert-base) an eager float16 matrix would be ~180 GB; lazily
it is one shard per client that trained.

Gather/scatter are the only access paths (a scatter touches exactly its
rows and leaves every other row bitwise intact).  A row of the adapter
column is the LoRA tree flattened in the JAX package's leaf order
(:func:`repro_torch.bridge.jax_leaves`), so the two packages' registries
compare row by row.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)

#: (name, dtype, fill) for every eager scalar column.
SCALAR_COLUMNS = (
    ("trust", np.float64, 1.0),
    ("staleness_ema", np.float64, 0.0),
    ("last_round", np.int64, -1),
    ("participations", np.int64, 0),
    ("draws", np.int64, 0),
    ("edge", np.int32, -1),
    ("cluster", np.int32, -1),
    ("data_seed", np.uint64, 0),
    ("n_examples", np.int64, 0),
    ("avail_cursor", np.int64, 0),
    ("screen_passes", np.int64, 0),
    ("screen_fails", np.int64, 0),
)


def mix64(x: np.ndarray, salt: int = 0) -> np.ndarray:
    """Vectorized splitmix64 finalizer: a stable 64-bit stream key per
    client id, so data-seed columns fill in one vectorized pass instead
    of 10^5 ``SeedSequence`` spawns."""
    with np.errstate(over="ignore"):
        z = (np.asarray(x, np.uint64) + np.uint64(salt)
             + np.uint64(0x9E3779B97F4A7C15)) & _MASK64
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9) \
            & _MASK64
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB) \
            & _MASK64
    return z ^ (z >> np.uint64(31))


class ClientRegistry:
    """Preallocated per-client state columns + lazily-sharded adapter
    deltas for ``registered`` clients."""

    def __init__(self, registered: int, *, adapter_dim: int = 0,
                 shard_rows: int = 256, adapter_dtype: str = "float32",
                 seed: int = 0):
        if registered < 1:
            raise ValueError(f"registered must be >= 1, got {registered}")
        if shard_rows < 1:
            raise ValueError(f"shard_rows must be >= 1, got {shard_rows}")
        self.registered = int(registered)
        self.adapter_dim = int(adapter_dim)
        self.shard_rows = int(shard_rows)
        self.adapter_dtype = np.dtype(adapter_dtype)
        self.seed = int(seed)
        self.columns: Dict[str, np.ndarray] = {
            name: np.full(registered, fill, dtype=dt)
            for name, dt, fill in SCALAR_COLUMNS}
        self.columns["data_seed"] = mix64(np.arange(registered), salt=seed)
        n_shards = -(-registered // self.shard_rows)
        self._adapter_shards: List[Optional[np.ndarray]] = [None] * n_shards

    def __getattr__(self, name: str) -> np.ndarray:
        cols = self.__dict__.get("columns")
        if cols is not None and name in cols:
            return cols[name]
        raise AttributeError(name)

    # -- scalar columns -----------------------------------------------------
    def _check_ids(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.registered):
            raise IndexError(f"client ids out of range [0, "
                             f"{self.registered}): {ids.min()}..{ids.max()}")
        return ids

    def gather(self, ids: Sequence[int],
               columns: Optional[Sequence[str]] = None
               ) -> Dict[str, np.ndarray]:
        """Copies of the requested columns at ``ids`` (cohort-sized)."""
        ids = self._check_ids(ids)
        names = columns if columns is not None else self.columns.keys()
        return {name: self.columns[name][ids].copy() for name in names}

    def scatter(self, ids: Sequence[int], **values: np.ndarray) -> None:
        """Write cohort-sized vectors back into their registry rows."""
        ids = self._check_ids(ids)
        for name, v in values.items():
            col = self.columns[name]
            col[ids] = np.asarray(v).astype(col.dtype, copy=False)

    # -- adapter-delta column -----------------------------------------------
    def _shard_of(self, i: int) -> np.ndarray:
        s = self._adapter_shards[i]
        if s is None:
            rows = min(self.shard_rows,
                       self.registered - i * self.shard_rows)
            s = np.zeros((rows, self.adapter_dim), self.adapter_dtype)
            self._adapter_shards[i] = s
        return s

    def has_adapter_shard(self, i: int) -> bool:
        return self._adapter_shards[i] is not None

    def gather_adapters(self, ids: Sequence[int]) -> np.ndarray:
        """(len(ids), adapter_dim) deltas; untouched rows read as zero
        without allocating their shard."""
        ids = self._check_ids(ids)
        out = np.zeros((len(ids), self.adapter_dim), self.adapter_dtype)
        for j, cid in enumerate(ids):
            i = int(cid) // self.shard_rows
            s = self._adapter_shards[i]
            if s is not None:
                out[j] = s[int(cid) - i * self.shard_rows]
        return out

    def scatter_adapters(self, ids: Sequence[int],
                         deltas: np.ndarray) -> None:
        ids = self._check_ids(ids)
        deltas = np.asarray(deltas)
        if deltas.shape != (len(ids), self.adapter_dim):
            raise ValueError(f"adapter deltas shape {deltas.shape} != "
                             f"({len(ids)}, {self.adapter_dim})")
        for j, cid in enumerate(ids):
            i = int(cid) // self.shard_rows
            self._shard_of(i)[int(cid) - i * self.shard_rows] = \
                deltas[j].astype(self.adapter_dtype, copy=False)

    # -- accounting -----------------------------------------------------------
    @property
    def allocated_shards(self) -> int:
        return sum(s is not None for s in self._adapter_shards)

    @property
    def n_shards(self) -> int:
        return len(self._adapter_shards)

    @property
    def nbytes(self) -> int:
        """Resident bytes: every scalar column + allocated adapter
        shards only (the lazy-allocation contract the population bench
        reports as registry memory)."""
        n = sum(c.nbytes for c in self.columns.values())
        n += sum(s.nbytes for s in self._adapter_shards if s is not None)
        return n

    # -- checkpoint plumbing --------------------------------------------------
    def state(self) -> Dict:
        return {
            "registered": self.registered,
            "adapter_dim": self.adapter_dim,
            "shard_rows": self.shard_rows,
            "adapter_dtype": self.adapter_dtype.name,
            "seed": self.seed,
            "columns": dict(self.columns),
            # int-keyed pairs, wire-stable like checkpoint groups/draws
            "adapter_shards": [[i, s] for i, s in
                               enumerate(self._adapter_shards)
                               if s is not None],
        }

    def load_state(self, state: Dict) -> None:
        for field in ("registered", "adapter_dim", "shard_rows"):
            if int(state[field]) != getattr(self, field):
                raise ValueError(
                    f"registry {field} mismatch: checkpoint has "
                    f"{state[field]}, this registry {getattr(self, field)}")
        for name, col in self.columns.items():
            if name not in state["columns"]:
                # column added after the checkpoint was written: keep
                # its freshly-initialized fill so pre-upgrade snapshots
                # stay loadable
                continue
            self.columns[name] = np.asarray(state["columns"][name],
                                            col.dtype).copy()
        self._adapter_shards = [None] * self.n_shards
        for i, s in state["adapter_shards"]:
            self._adapter_shards[int(i)] = np.asarray(
                s, self.adapter_dtype).copy()
