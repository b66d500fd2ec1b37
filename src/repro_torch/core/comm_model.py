"""Communication volume / latency model (ELSA §III.B.4, Eqs. 22–24).

The counterpart of the JAX package's ``repro/core/comm_model.py``, with
the same float arithmetic.  :func:`comm_config_from` derives a
:class:`CommConfig` from the *actual* artifacts of a federation — the
model config, the count-sketch plan, and the LoRA parameter tree —
instead of hand-typed constants, so the byte counts used by the
event-driven runtime track whatever shapes the run really transmits.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.params import spec_leaves
from repro_torch.optim.optimizers import tree_leaves


@dataclasses.dataclass(frozen=True)
class CommConfig:
    t_rounds: int            # t: client-edge rounds per global aggregation
    bytes_per_param: float   # zeta (4 for fp32)
    seq_len: int             # mu: tokens per input
    d_hidden: int            # D^hidden
    rho: float               # sketch compression ratio
    lora_bytes: int          # |theta^LoRA| per edge->cloud upload


def lora_tree_bytes(lora, bytes_per_param: Optional[float] = None) -> int:
    """Serialized size of a LoRA tree: tensor leaves use their own dtype;
    a tree of :class:`~repro_torch.models.params.Spec` leaves uses
    ``bytes_per_param``."""
    specs = spec_leaves(lora)
    if specs:
        return sum(int(np.prod(s.shape) * (bytes_per_param or 4.0))
                   for s in specs)
    return sum(int(t.numel()) * t.element_size() for t in tree_leaves(lora))


def comm_config_from(cfg, fed, plan=None, *, lora=None,
                     seq_len: Optional[int] = None,
                     num_classes: Optional[int] = None) -> CommConfig:
    """Derive the Eq. 22–24 constants from real run artifacts.

    - ``d_hidden`` = the model's hidden width (what actually crosses the
      split boundary before sketching);
    - ``rho`` = the *effective* compression ratio of ``plan``
      (``D / (Y·Z)``), 1.0 when no sketch plan is used;
    - ``bytes_per_param`` from the config's activation dtype (activations
      are what Eq. 22's zeta multiplies);
    - ``lora_bytes`` from the actual LoRA tree when given, else from the
      model's LoRA parameter specs at the param dtype;
    - ``seq_len``/``t_rounds`` from the federation config (``fed.seq_len``
      may be overridden per task via ``seq_len=``).

    ``fed`` is any object with ``t_rounds``/``seq_len``/``num_classes``
    attributes (a :class:`~repro_torch.federation.simulation.FedConfig`).

    Model shapes come from the
    :class:`~repro_torch.models.split_api.SplitModel`
    adapter of ``cfg`` — the LoRA upload is priced off ``lora_specs`` and
    the boundary width off ``activation_shape``, so any registered
    architecture (encoder or causal LM) gets correct Eq. 22–24 constants.
    """
    from repro_torch.models.split_api import split_model_for

    model = split_model_for(cfg)
    zeta = float(getattr(torch, cfg.activation_dtype).itemsize)
    rho = float(plan.rho) if plan is not None else 1.0
    if lora is None:
        lora = model.lora_specs(num_classes
                                or getattr(fed, "num_classes", 2))
    lb = lora_tree_bytes(lora, getattr(torch, cfg.param_dtype).itemsize)
    return CommConfig(
        t_rounds=int(fed.t_rounds), bytes_per_param=zeta,
        seq_len=int(seq_len if seq_len is not None
                    else getattr(fed, "seq_len", cfg.max_position_embeddings)),
        d_hidden=int(model.activation_shape(1, 1)[-1]), rho=rho,
        lora_bytes=lb)


def round_volume_bytes(cc: CommConfig, batch_sizes_per_edge: Dict[int, List[float]],
                       n_edges: int) -> float:
    """Eq. 22: C_g = 2 t ζ μ D / ρ * Σ_k Σ_n B_n  +  K |θ_LoRA|."""
    total_b = sum(sum(bs) for bs in batch_sizes_per_edge.values())
    activ = 2.0 * cc.t_rounds * cc.bytes_per_param * cc.seq_len \
        * cc.d_hidden / cc.rho * total_b
    return activ + n_edges * cc.lora_bytes


def client_comm_time(cc: CommConfig, batch_size: float,
                     bandwidth_bytes_per_s: float) -> float:
    """Eq. 23: T_{g,n} = 2 t B_n μ ζ D / ρ / B_n^bw."""
    vol = 2.0 * cc.t_rounds * batch_size * cc.seq_len \
        * cc.bytes_per_param * cc.d_hidden / cc.rho
    return vol / max(bandwidth_bytes_per_s, 1e-9)


def total_comm_time(cc: CommConfig, batch_sizes: Sequence[float],
                    bandwidths: Sequence[float], n_global_rounds: int
                    ) -> float:
    """Eq. 24: T ≈ G * max_n T_{g,n} (the straggler bound)."""
    per_client = [client_comm_time(cc, b, bw)
                  for b, bw in zip(batch_sizes, bandwidths)]
    return n_global_rounds * max(per_client)
