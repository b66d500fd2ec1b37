"""Helpers of the federation engine.

The JAX package's ``repro/federation/engine.py`` is the batched engine
(clients stacked on a leading axis, ``vmap``-ed steps, one compiled round
per configuration).  The port has its tree-kind test,
:func:`is_client_map`, which the round loop uses; the engine itself waits
for ROADMAP.md, queue 1, item 3b.
"""
from __future__ import annotations

import numpy as np


def is_client_map(theta) -> bool:
    """True when ``theta`` is a {client-id: tree} map (integer keys —
    Python or numpy ints) rather than a single LoRA tree (whose dict
    nodes have string keys)."""
    return isinstance(theta, dict) and bool(theta) and \
        all(isinstance(k, (int, np.integer)) and not isinstance(k, bool)
            for k in theta)
