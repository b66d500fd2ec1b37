"""Mixture-of-Experts FFN (GShard/Switch-style capacity-bounded dispatch).

The counterpart of the JAX package's ``repro/models/moe.py``: the router
runs in fp32, each token takes its top-k experts with renormalised gates,
and tokens are dispatched by scatter/gather over an ``(E·C + 1, D)`` buffer
(capacity C per expert; the last row is the overflow "dump" row, which is
discarded), so the expert products are dense batched matmuls with no
per-token control flow.  They are plain ``torch.bmm``, as the JAX package
leaves its einsums to XLA.

Load-balance auxiliary loss follows Switch Transformer:
``aux = E * sum_e fraction_tokens_e * mean_router_prob_e``.

The top-k is a stable descending sort: ``jax.lax.top_k`` takes the lower
expert index first among equal probabilities, and the selection order sets
the capacity slots (the running count over the flattened (T·k) order),
which tokens are dropped and the aux loss's first choice.  ``torch.topk``
breaks ties in no fixed order.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.common import activation
from repro_torch.models.params import Spec


def moe_specs(cfg):
    m = cfg.moe
    d, f, e = cfg.d_model, m.expert_d_ff or cfg.d_ff, m.num_experts
    p = {
        "router": Spec((d, e), ("embed", "experts")),
        "w_gate": Spec((e, d, f), ("experts", "embed", "mlp")),
        "w_up": Spec((e, d, f), ("experts", "embed", "mlp")),
        "w_down": Spec((e, f, d), ("experts", "mlp", "embed")),
    }
    if m.num_shared_experts:
        fs = f * m.num_shared_experts
        p["shared"] = {
            "w_gate": Spec((d, fs), ("embed", "mlp")),
            "w_up": Spec((d, fs), ("embed", "mlp")),
            "w_down": Spec((fs, d), ("mlp", "embed")),
        }
    return p


def _capacity(m, n_tokens: int) -> int:
    c = int(m.capacity_factor * m.experts_per_token * n_tokens / m.num_experts)
    return max(8, ((c + 7) // 8) * 8)


def route(cfg, router, xt):
    """xt (T, D) -> ``(probs (T, E), gates (T, k), sel (T, k), keep (T·k,),
    slot (T·k,))``: the fp32 router, the stable top-k with renormalised
    gates, and each (token, choice)'s row of the dispatch buffer (``E·C``,
    the dump row, when its expert is full)."""
    m = cfg.moe
    k, E = m.experts_per_token, m.num_experts
    C = _capacity(m, xt.shape[0])
    logits = xt.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, -1)                         # (T, E)
    gates, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, sel = gates[:, :k], sel[:, :k]                     # (T, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    flat_e = sel.reshape(-1)                                  # (T*k,)
    oh = torch.nn.functional.one_hot(flat_e, E)               # (T*k, E)
    pos_in_e = ((torch.cumsum(oh, 0) - oh) * oh).sum(-1)      # (T*k,)
    keep = pos_in_e < C
    slot = torch.where(keep, flat_e * C + pos_in_e,
                       torch.full_like(flat_e, E * C))        # overflow->dump
    return probs, gates, sel, keep, slot


def moe_apply(cfg, p, x, *, return_aux: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (B, S, D) -> (B, S, D), aux_loss (scalar fp32)."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    k, E = m.experts_per_token, m.num_experts
    C = _capacity(m, T)
    xt = x.reshape(T, D)
    probs, gates, sel, keep, slot = route(cfg, p["router"], xt)

    # every slot but the dump row takes exactly one token, so the sum is a
    # placement
    x_rep = xt.repeat_interleave(k, dim=0)                    # (T*k, D)
    buf = x.new_zeros((E * C + 1, D)).index_add(0, slot, x_rep)
    buf = buf[:-1].reshape(E, C, D)

    g = activation(cfg.act, torch.bmm(buf, p["w_gate"].to(x.dtype)))
    u = torch.bmm(buf, p["w_up"].to(x.dtype))
    eo = torch.bmm(g * u, p["w_down"].to(x.dtype))
    eo = torch.cat([eo.reshape(E * C, D), x.new_zeros((1, D))])

    out_rep = eo[slot] * keep[:, None].to(x.dtype)            # (T*k, D)
    out = (out_rep.reshape(T, k, D) * gates[..., None].to(x.dtype)).sum(1)

    if "shared" in p:
        sp = p["shared"]
        sg = activation(cfg.act, xt @ sp["w_gate"].to(x.dtype))
        out = out + (sg * (xt @ sp["w_up"].to(x.dtype))) @ \
            sp["w_down"].to(x.dtype)

    aux = None
    if return_aux:
        frac = torch.nn.functional.one_hot(sel[:, 0], E).to(
            torch.float32).mean(0)
        mean_prob = probs.mean(0)
        aux = E * torch.sum(frac * mean_prob) * m.aux_loss_weight
    return out.reshape(B, S, D), aux
