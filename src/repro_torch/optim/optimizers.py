"""Optimizers over parameter trees (nested dicts and lists of tensors).

The counterpart of the JAX package's ``repro/optim/optimizers.py`` for
AdamW and clipping.  Updates are functional, as in JAX: ``update`` returns
new tensors and leaves its inputs as they are.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


class Optimizer:
    """Interface: init(params) -> state; update(params, grads, state) ->
    (new_params, new_state)."""

    def init(self, params):
        raise NotImplementedError

    def update(self, params, grads, state):
        raise NotImplementedError


def tree_map(f, tree, *rest):
    """``f`` over the leaves of equally shaped dict/list trees."""
    if isinstance(tree, dict):
        return {k: tree_map(f, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(f, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return f(tree, *rest)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def _acc(t):
    return torch.promote_types(t.dtype, torch.float32)


def global_norm(tree) -> torch.Tensor:
    """L2 norm over every leaf of a tree (f32+ accumulation)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(_acc(x))))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` so its global L2 norm is at most ``max_norm``: one
    shared scale, a no-op under the cap, no 0/0 on all-zero gradients."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.to(_acc(g)) * scale).to(g.dtype), grads)


@dataclasses.dataclass
class AdamW(Optimizer):
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def init(self, params):
        """``{"step": int32 scalar, "m", "v"}``; m and v are f32, on each
        parameter's device."""
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else "cpu"
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                      device=p.device)
        return {"step": torch.zeros((), dtype=torch.int32, device=device),
                "m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(self, params, grads, state):
        step = state["step"] + 1
        lr = self.lr if self.schedule is None else self.lr * self.schedule(step)
        b1c = 1.0 - self.b1 ** step.to(torch.float32)
        b2c = 1.0 - self.b2 ** step.to(torch.float32)
        m = tree_map(lambda mm, g: self.b1 * mm
                     + (1 - self.b1) * g.to(torch.float32), state["m"], grads)
        v = tree_map(lambda vv, g: self.b2 * vv
                     + (1 - self.b2) * torch.square(g.to(torch.float32)),
                     state["v"], grads)

        def upd(p, mm, vv):
            mh = mm / b1c
            vh = vv / b2c
            step_ = mh / (torch.sqrt(vh) + self.eps)
            if self.weight_decay:
                step_ = step_ + self.weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * step_).to(p.dtype)

        new = tree_map(upd, params, m, v)
        return new, {"step": step, "m": m, "v": v}
