"""Optimizers over parameter trees (nested dicts and lists of tensors):
AdamW, SGD, the FedProx proximal term and optimizer, the FedAdam/FedAMS
server optimizers, and global-norm clipping.

The counterpart of the JAX package's ``repro/optim/optimizers.py``.
Updates are functional, as in JAX: ``update`` returns new tensors and
leaves its inputs as they are.  Moments are kept in float32 whatever the
parameters' dtype, as there.
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


def fedprox_gradient(grads, params, anchor, mu: float):
    """FedProx proximal gradient ``g + mu (w - w_anchor)``, leafwise."""
    return tree_map(lambda g, p, a: g + mu * (p - a), grads, params, anchor)


def _zeros_f32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _step0(params):
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    return torch.zeros((), dtype=torch.int32, device=device)


@dataclasses.dataclass
class SGD(Optimizer):
    lr: float = 1e-2
    momentum: float = 0.0

    def init(self, params):
        if self.momentum == 0.0:
            return {"step": _step0(params)}
        return {"step": _step0(params),
                "m": tree_map(torch.zeros_like, params)}

    def update(self, params, grads, state):
        lr = self.lr
        if self.momentum == 0.0:
            new = tree_map(lambda p, g: p - lr * g.to(p.dtype), params, grads)
            return new, {"step": state["step"] + 1}
        m = tree_map(lambda mm, g: self.momentum * mm + g.to(mm.dtype),
                     state["m"], grads)
        new = tree_map(lambda p, mm: p - lr * mm.to(p.dtype), params, m)
        return new, {"step": state["step"] + 1, "m": m}


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
        return {"step": _step0(params), "m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params)}

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


@dataclasses.dataclass
class FedProx(Optimizer):
    """SGD with the FedProx proximal term mu/2 ||w - w_global||^2
    [Li et al., MLSys 2020]: g <- g + mu (w - w_global)."""
    lr: float = 1e-2
    mu: float = 0.01

    def init(self, params):
        return {"step": _step0(params), "anchor": tree_map(lambda p: p,
                                                           params)}

    def set_anchor(self, state, anchor):
        return {**state, "anchor": anchor}

    def update(self, params, grads, state):
        new = tree_map(
            lambda p, g, a: p - self.lr * (g.to(p.dtype) + self.mu * (p - a)),
            params, grads, state["anchor"])
        return new, {**state, "step": state["step"] + 1}


@dataclasses.dataclass
class FedAdam(Optimizer):
    """Server-side adaptive aggregation (FedOpt family, Reddi et al., ICLR
    2021) with bias-corrected moments: ``update`` treats ``grads`` as the
    pseudo-gradient (old_global - aggregated)."""
    lr: float = 0.05
    b1: float = 0.9
    b2: float = 0.99
    tau: float = 1e-3      # adaptivity floor (Reddi et al.'s tau)

    def init(self, params):
        return {"step": _step0(params), "m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params)}

    def update(self, params, grads, state):
        step = state["step"] + 1
        b1c = 1.0 - self.b1 ** step.to(torch.float32)
        b2c = 1.0 - self.b2 ** step.to(torch.float32)
        m = tree_map(lambda mm, g: self.b1 * mm
                     + (1 - self.b1) * g.to(torch.float32), state["m"], grads)
        v = tree_map(lambda vv, g: self.b2 * vv
                     + (1 - self.b2) * torch.square(g.to(torch.float32)),
                     state["v"], grads)
        new = tree_map(lambda p, mm, vv:
                       (p.to(torch.float32)
                        - self.lr * (mm / b1c)
                        / (torch.sqrt(vv / b2c) + self.tau)).to(p.dtype),
                       params, m, v)
        return new, {"step": step, "m": m, "v": v}


@dataclasses.dataclass
class FedAMS(Optimizer):
    """Server-side adaptive aggregation with AMSGrad-style max-v [Wang et
    al., ICML 2022].  ``update`` treats ``grads`` as the pseudo-gradient
    (old_global - aggregated)."""
    lr: float = 1.0
    b1: float = 0.9
    b2: float = 0.99
    eps: float = 1e-3

    def init(self, params):
        return {"step": _step0(params), "m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params),
                "vmax": tree_map(_zeros_f32, params)}

    def update(self, params, grads, state):
        m = tree_map(lambda mm, g: self.b1 * mm
                     + (1 - self.b1) * g.to(torch.float32), state["m"], grads)
        v = tree_map(lambda vv, g: self.b2 * vv
                     + (1 - self.b2) * torch.square(g.to(torch.float32)),
                     state["v"], grads)
        vmax = tree_map(torch.maximum, state["vmax"], v)
        new = tree_map(lambda p, mm, vm:
                       (p.to(torch.float32)
                        - self.lr * mm / (torch.sqrt(vm) + self.eps)
                        ).to(p.dtype), params, m, vmax)
        return new, {"step": state["step"] + 1, "m": m, "v": v, "vmax": vmax}
