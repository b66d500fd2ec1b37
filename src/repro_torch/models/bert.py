"""BERT-base encoder — the paper's own model (§IV.A).

Post-LN encoder with token/position/segment embeddings, [CLS] pooler, and a
pluggable classification head.  Exposes both sequence representations (for
ELSA's behavioral fingerprints, Eq. 4) and per-layer split execution (for
the tripartite split training, §III.B.2): ``run_blocks(lo, hi)`` runs
blocks [lo, hi) so Part 1 / Part 2 / Part 3 of the split are literal slices
of the same parameter tree.

The counterpart of the JAX package's ``repro/models/bert.py``; ``blocks``
is a list of per-layer dicts (the JAX package stacks them).  Attention is
non-causal flash attention (:func:`repro_torch.models.common.attn_apply`
without a cache), with no key mask: as in the JAX package, ``mask_valid``
only zeroes the block outputs of invalid positions.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import common
from repro_torch.models.common import apply_mlp, apply_norm, attn_apply, stack_specs
from repro_torch.models.params import Spec


def bert_specs(cfg, num_classes: int = 2):
    d = cfg.d_model
    block = {"attn": common.attn_specs(cfg),
             "ln1": common.norm_specs("layernorm", d),
             "mlp": common.mlp_specs(cfg),
             "ln2": common.norm_specs("layernorm", d)}
    frozen = {
        "embed": Spec((cfg.padded_vocab, d), ("vocab", "embed"), "embed"),
        "pos": Spec((cfg.max_position_embeddings, d), (None, "embed"), "embed"),
        "seg": Spec((2, d), (None, "embed"), "embed"),
        "ln_embed": common.norm_specs("layernorm", d),
        "blocks": stack_specs(cfg.num_layers, block),
    }
    lora = {"blocks": stack_specs(cfg.num_layers,
                                  {"attn": common.attn_lora_specs(cfg)})}
    # task head is trainable (paper: output layer trainable, negligible size)
    lora["pooler"] = {"w": Spec((d, d), ("embed", None)),
                      "b": Spec((d,), (None,), "zeros")}
    lora["head"] = {"w": Spec((d, num_classes), ("embed", None)),
                    "b": Spec((num_classes,), (None,), "zeros")}
    return {"frozen": frozen, "lora": lora}


def embed(cfg, params, tokens, segments=None):
    S = tokens.shape[1]
    x = params["embed"][tokens]
    x = x + params["pos"][:S][None]
    if segments is not None:
        x = x + params["seg"][segments]
    return apply_norm("layernorm", params["ln_embed"], x.to(cfg.adtype()))


def block_apply(cfg, p, lp, x, *, mask_valid: Optional[torch.Tensor] = None):
    """Post-LN BERT block.  mask_valid: (B, S) bool; zeroes the output of
    invalid positions (attention itself takes no key mask)."""
    positions = torch.arange(x.shape[1], device=x.device)
    h, _ = attn_apply(cfg, p["attn"], lp["attn"] if lp else None, x,
                      positions=positions, causal=False)
    x = apply_norm("layernorm", p["ln1"], x + h)
    f = apply_mlp(cfg, p["mlp"], x)
    x = apply_norm("layernorm", p["ln2"], x + f)
    if mask_valid is not None:
        x = x * mask_valid[..., None].to(x.dtype)
    return x


def run_blocks(cfg, params, lora, x, lo: int, hi: int,
               mask_valid: Optional[torch.Tensor] = None):
    """Run encoder blocks [lo, hi) — the split-learning building block.
    Layer ``i`` for ``i in range(lo, hi)``, indexed as the JAX package
    indexes its stacked leaves (so a negative index wraps the same way)."""
    for i in range(lo, hi):
        lp = lora["blocks"][i] if lora else None
        x = block_apply(cfg, params["blocks"][i], lp, x,
                        mask_valid=mask_valid)
    return x


def bert_forward(cfg, params, lora, tokens, segments=None, mask_valid=None,
                 **_):
    """Full encoder -> (sequence_output, cls_embedding, logits)."""
    frozen = params
    x = embed(cfg, frozen, tokens, segments)
    x = run_blocks(cfg, frozen, lora, x, 0, cfg.num_layers, mask_valid)
    cls = x[:, 0, :]
    logits = None
    if lora is not None and "head" in lora:
        pooled = torch.tanh(cls @ lora["pooler"]["w"].to(cls.dtype)
                            + lora["pooler"]["b"].to(cls.dtype))
        logits = pooled @ lora["head"]["w"].to(cls.dtype) \
            + lora["head"]["b"].to(cls.dtype)
    return x, cls, logits
