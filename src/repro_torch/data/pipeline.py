"""Batching / shuffling pipeline over client datasets: the per-client
epoch iterators and the draw-counting wrapper of the federation's batch
streams.

The part of the JAX package's ``repro/data/pipeline.py`` that the
sequential federation uses, copied (numpy only, bit-equal draws).  Its
batch stacks for the batched engine (``pad_batch``,
``stack_padded_batches``) come with that engine (ROADMAP.md, queue 1,
item 3b).
"""
from __future__ import annotations

from typing import Iterator, Tuple

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
    :meth:`fast_forward` to it.  The JAX package's federation checkpoints
    rely on this for the per-client batch streams (in the port they wait
    for ROADMAP.md, queue 5)."""

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
