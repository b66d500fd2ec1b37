"""Parameter-spec system: a model declares its parameters as a tree of
:class:`Spec` leaves (nested dicts and lists), and :func:`init_tree`
materializes it on a device from an explicit ``torch.Generator``.

The init kinds and scales are the JAX package's (``repro/models/params.py``);
the random numbers are not, since ``torch.Generator`` and ``jax.random``
differ.  Tests that compare the two packages carry weights across with
:mod:`repro_torch.bridge` instead.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch


class Spec(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis names, len == len(shape)
    init: str = "normal"              # normal | zeros | ones | const | embed
    scale: float = 1.0                # stddev multiplier / const value
    dtype: Optional[str] = None       # per-leaf dtype override (e.g. 'int32')

    def fan_in_scale(self) -> float:
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        return 1.0 / math.sqrt(max(fan_in, 1))


def is_spec(x) -> bool:
    return isinstance(x, Spec)


def _leaf_init(spec: Spec, generator: torch.Generator, dtype, device):
    if spec.dtype is not None:
        dtype = getattr(torch, spec.dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "const":
        return torch.full(spec.shape, spec.scale, dtype=dtype, device=device)
    std = 0.02 if spec.init == "embed" else spec.scale * spec.fan_in_scale()
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(std).to(dtype)


def init_tree(specs, generator: torch.Generator, dtype=torch.float32,
              device="cuda"):
    """Materialize real parameters from a spec tree on ``device``.

    Dict keys are visited in sorted order, so one generator seed gives one
    tree.  ``generator`` must live on ``device``.  Leaves that are not
    :class:`Spec` (a decode cache's host-side ``len``) are kept as they are.
    """
    if is_spec(specs):
        return _leaf_init(specs, generator, dtype, device)
    if isinstance(specs, dict):
        return {k: init_tree(specs[k], generator, dtype, device)
                for k in sorted(specs)}
    if isinstance(specs, (list, tuple)):
        return type(specs)(init_tree(s, generator, dtype, device)
                           for s in specs)
    return specs


def abstract_tree(specs, dtype=torch.bfloat16, device="meta"):
    """Empty stand-ins of each spec's shape and dtype on ``device``, with
    nothing drawn (on ``meta``, nothing allocated): the dry run's trees,
    the counterpart of the JAX package's ``abstract_tree``.  Walked as
    :func:`init_tree` walks, non-:class:`Spec` leaves kept as they are."""
    if is_spec(specs):
        dt = getattr(torch, specs.dtype) if specs.dtype else dtype
        return torch.empty(specs.shape, dtype=dt, device=device)
    if isinstance(specs, dict):
        return {k: abstract_tree(specs[k], dtype, device)
                for k in sorted(specs)}
    if isinstance(specs, (list, tuple)):
        return type(specs)(abstract_tree(s, dtype, device) for s in specs)
    return specs


def spec_leaves(specs):
    """All :class:`Spec` leaves of a tree, in :func:`init_tree` order."""
    if is_spec(specs):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    if isinstance(specs, (list, tuple)):
        return [s for x in specs for s in spec_leaves(x)]
    return []


def count_params(specs) -> int:
    return int(sum(math.prod(s.shape) for s in spec_leaves(specs)))
