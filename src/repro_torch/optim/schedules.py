"""Learning-rate schedules (multiplicative factors on the base lr) and
per-parameter-group learning rates.

The counterpart of the JAX package's ``repro/optim/schedules.py``; a
schedule maps the step (an int32 tensor) to a float32 factor.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.optim.optimizers import tree_map


def adapter_head_lr_tree(lora_like, lr: float,
                         head_lr: Optional[float] = None):
    """Per-leaf learning rates: adapter vs readout-head groups.

    Every leaf under the top-level ``"blocks"`` (and ``"prefix"``) subtrees
    — the LoRA adapters inside the block stack — gets ``lr``; everything
    else (pooler, classification head) gets ``head_lr`` (default: ``lr``).
    Leaves are Python floats, so with ``head_lr=None`` the update
    ``p - lr_leaf * g`` is the scalar ``p - lr * g``."""
    hl = lr if head_lr is None else head_lr
    if not isinstance(lora_like, dict):
        return tree_map(lambda _: lr, lora_like)
    return {k: tree_map(lambda _: lr if k in ("blocks", "prefix") else hl, v)
            for k, v in lora_like.items()}


def constant():
    return lambda step: torch.ones((), dtype=torch.float32,
                                   device=step.device)


def cosine_decay(total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(step.to(torch.float32) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return final_frac + (1.0 - final_frac) * cos
    return f


def warmup_cosine(warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    cd = cosine_decay(max(total_steps - warmup_steps, 1), final_frac)

    def f(step):
        s = step.to(torch.float32)
        warm = s / max(warmup_steps, 1)
        return torch.where(s < warmup_steps, warm, cd(step - warmup_steps))
    return f
