"""Tripartite split training (ELSA §III.B.2–3): the client<->edge channel.

The model stack is cut at (p, p+q); activations crossing each cut pass
through the ELSA channel (SS-OP -> count-sketch -> median-decode ->
SS-OPᵀ).  Each stage is a ``torch.autograd.Function`` whose backward is a
hand-written kernel on the card, so gradients cross the cut through the
same channel in reverse.

The counterpart of the JAX package's ``repro/core/split_training.py``.
Every entry point takes a :class:`~repro_torch.models.split_api.SplitModel`
(or an ``ArchConfig``, adapted through the split-model registry).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core.sketch import SketchPlan, compress, decompress
from repro_torch.core.ssop import SSOP, apply_ssop, apply_ssop_inverse
from repro_torch.models.split_api import as_split_model
from repro_torch.optim.optimizers import tree_leaves, tree_map


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


def split_forward(model, frozen, lora, tokens, split: Split,
                  channel: Channel = IDENTITY_CHANNEL,
                  mask_valid=None):
    """Split forward pass; returns (repr, logits, h_up, h_down)."""
    m = as_split_model(model)
    x = m.embed(frozen, tokens)
    # Part 1 (client)
    h_up = m.run_blocks(frozen, lora, x, 0, split.p, mask_valid)
    h_up_t = channel(h_up)
    # Part 2 (edge)
    h_down = m.run_blocks(frozen, lora, h_up_t,
                          split.p, split.p + split.q, mask_valid)
    h_down_t = channel(h_down)
    # Part 3 (client)
    x = m.run_blocks(frozen, lora, h_down_t,
                     split.p + split.q, m.num_blocks, mask_valid)
    repr_, logits = m.head(frozen, lora, x)
    return repr_, logits, h_up, h_down


def split_loss(model, frozen, lora, batch, split: Split,
               channel: Channel = IDENTITY_CHANNEL):
    m = as_split_model(model)
    _, logits, _, _ = split_forward(m, frozen, lora, batch["tokens"],
                                    split, channel,
                                    batch.get("mask_valid"))
    return torch.mean(m.per_example_loss(logits, batch))


def weighted_split_loss(model, frozen, lora, batch, split: Split,
                        channel: Channel = IDENTITY_CHANNEL):
    """``split_loss`` with per-example weights: Σ w_i ℓ_i / Σ w_i; an
    all-zero weight vector gives exactly zero loss and gradients."""
    m = as_split_model(model)
    _, logits, _, _ = split_forward(m, frozen, lora, batch["tokens"],
                                    split, channel,
                                    batch.get("mask_valid"))
    per = m.per_example_loss(logits, batch)
    w = batch["weights"].to(per.dtype)
    s = torch.sum(w)
    return torch.sum(per * w) / torch.where(s > 0, s, torch.ones_like(s))


def loss_and_grad(loss_fn, lora, *args):
    """``(loss, grads)`` of ``loss_fn(lora, *args)`` over the LoRA tree by
    autograd (the counterpart of ``jax.value_and_grad``); the loss comes
    back detached."""
    lp = tree_map(lambda p: p.detach().requires_grad_(True), lora)
    loss = loss_fn(lp, *args)
    grads = iter(torch.autograd.grad(loss, tree_leaves(lp)))
    return loss.detach(), tree_map(lambda _: next(grads), lp)


def split_train_step(model, split: Split, channel: Channel, optimizer):
    """A ``(frozen, lora, opt_state, batch) -> (lora, opt_state, loss)``
    step.  Gradients flow Part 3 -> channelᵀ -> Part 2 -> channelᵀ ->
    Part 1 (each channel stage's backward is its kernel on the card).
    Eager: the JAX package compiles this step with ``jit``, which PyTorch
    has no need of (its ``donate`` option has no counterpart here)."""
    m = as_split_model(model)

    def step(frozen, lora, opt_state, batch):
        loss, grads = loss_and_grad(
            lambda lp: split_loss(m, frozen, lp, batch, split, channel),
            lora)
        with torch.no_grad():
            lora_new, opt_state = optimizer.update(lora, grads, opt_state)
        return lora_new, opt_state, loss

    return step
