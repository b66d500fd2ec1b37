"""Batching / shuffling pipeline over client datasets: the per-client
epoch iterators, the draw-counting wrapper of the federation's batch
streams, and the padded batch stacks of the batched engine.

The counterpart of the JAX package's ``repro/data/pipeline.py``, copied
(numpy only: bit-equal draws and stacks).
"""
from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np


def batch_iterator(tokens: np.ndarray, labels: np.ndarray, batch_size: int,
                   *, shuffle: bool = True, seed: int = 0, drop_last: bool = False
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Epoch iterator yielding (tokens, labels) batches."""
    n = len(tokens)
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n) if shuffle else np.arange(n)
    stop = (n // batch_size) * batch_size if drop_last else n
    for i in range(0, stop, batch_size):
        sel = idx[i:i + batch_size]
        if len(sel) == 0:
            continue
        yield tokens[sel], labels[sel]


def infinite_batches(tokens: np.ndarray, labels: np.ndarray,
                     batch_size: int, seed: int = 0):
    epoch = 0
    while True:
        for b in batch_iterator(tokens, labels, batch_size,
                                seed=seed + epoch):
            yield b
        epoch += 1


class CountingIterator:
    """Iterator wrapper that counts draws, so a seeded stream can be
    reproduced exactly after a restart: checkpoint the count, rebuild
    the same seeded iterator in the new process, and
    :meth:`fast_forward` to it.  The federation checkpoints
    (:mod:`repro_torch.checkpoint.federation`) rely on this for the
    per-client batch streams."""

    def __init__(self, it):
        self._it = it
        self.count = 0

    def __iter__(self):
        return self

    def __next__(self):
        out = next(self._it)
        self.count += 1
        return out

    def fast_forward(self, count: int) -> None:
        """Discard draws until ``self.count == count``."""
        if count < self.count:
            raise ValueError(
                f"cannot rewind an iterator (at {self.count}, "
                f"asked for {count})")
        while self.count < count:
            next(self)


def pad_batch(tokens: np.ndarray, labels: np.ndarray, batch_size: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad a ragged (b, S) batch to ``batch_size`` rows.

    Returns (tokens, labels, weights) with weights 1.0 on real rows and
    0.0 on padding; the weighted loss then matches the unpadded mean
    exactly (padding contributes exact zeros).
    """
    b = len(tokens)
    w = np.zeros(batch_size, np.float32)
    w[:b] = 1.0
    if b == batch_size:
        return tokens, labels, w
    pt = np.zeros((batch_size,) + tokens.shape[1:], tokens.dtype)
    pl = np.zeros((batch_size,) + labels.shape[1:], labels.dtype)
    pt[:b], pl[:b] = tokens, labels
    return pt, pl, w


def stack_padded_batches(per_client: Sequence[List[Tuple[np.ndarray,
                                                         np.ndarray]]],
                         batch_size: int
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack per-client batch sequences into step-major arrays.

    ``per_client``: one list of ``steps`` (tokens, labels) batches per
    client (already drawn from that client's iterator, preserving its
    shuffle order).  Returns host arrays
    ``tokens (steps, N, B, S) int32``, ``labels (steps, N, B) int32``,
    ``weights (steps, N, B) float32``, the step axis leading.
    """
    steps = len(per_client[0])
    if any(len(c) != steps for c in per_client):
        raise ValueError("all clients must contribute the same number of "
                         "local steps")
    toks, labs, wts = [], [], []
    for s in range(steps):
        trow, lrow, wrow = [], [], []
        for client in per_client:
            t, l, w = pad_batch(client[s][0], client[s][1], batch_size)
            trow.append(t)
            lrow.append(l)
            wrow.append(w)
        toks.append(np.stack(trow))
        labs.append(np.stack(lrow))
        wts.append(np.stack(wrow))
    return (np.stack(toks).astype(np.int32), np.stack(labs).astype(np.int32),
            np.stack(wts))
