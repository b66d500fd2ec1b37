"""Tripartite split training (ELSA §III.B.2–3): the client<->edge channel.

The model stack is cut at (p, p+q); activations crossing each cut pass
through the ELSA channel (SS-OP -> count-sketch -> median-decode ->
SS-OPᵀ).  Each stage is a ``torch.autograd.Function`` whose backward is a
hand-written kernel on the card, so gradients cross the cut through the
same channel in reverse.

The counterpart of the channel half of the JAX package's
``repro/core/split_training.py``.  ``split_forward``, ``split_loss``,
``weighted_split_loss`` and ``split_train_step`` need the split-model
registry and come with the federation slice (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core.sketch import SketchPlan, compress, decompress
from repro_torch.core.ssop import SSOP, apply_ssop, apply_ssop_inverse


class Channel(NamedTuple):
    """The client<->edge activation channel."""
    ssop: Optional[SSOP]
    plan: Optional[SketchPlan]

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        if self.ssop is not None:
            h = apply_ssop(h, self.ssop)
        if self.plan is not None:
            h = decompress(compress(h, self.plan), self.plan)
        if self.ssop is not None:
            h = apply_ssop_inverse(h, self.ssop)
        return h

    def transmit(self, h: torch.Tensor) -> torch.Tensor:
        """What actually crosses the network (privacy-attack surface)."""
        if self.ssop is not None:
            h = apply_ssop(h, self.ssop)
        if self.plan is not None:
            h = compress(h, self.plan)
        return h


IDENTITY_CHANNEL = Channel(None, None)


@dataclasses.dataclass(frozen=True)
class Split:
    p: int
    q: int
    o: int
