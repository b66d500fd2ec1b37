"""Decoder-only LM, dense family (llama/qwen/olmo): specs, the training
forward (with ELSA's split channel), the decode cache and the single-token
decode step.

The counterpart of the JAX package's ``repro/models/transformer.py``.  The
JAX layer ``scan`` over stacked blocks becomes a Python loop over a list of
per-layer parameter dicts, and ``jax.checkpoint`` of the scan body becomes
``torch.utils.checkpoint`` of each block.  MoE, MLA and the dense prefix
layers wait for later slices (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import common
from repro_torch.models.common import apply_mlp, apply_norm, stack_specs
from repro_torch.models.params import Spec


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def _require_dense(cfg):
    if cfg.moe or cfg.mla or cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: only the dense family is ported (MoE/MLA wait in "
            f"ROADMAP.md, queue 1)")


def _one_block_specs(cfg):
    return {"ln1": common.norm_specs(cfg.norm, cfg.d_model),
            "ln2": common.norm_specs(cfg.norm, cfg.d_model),
            "attn": common.attn_specs(cfg),
            "mlp": common.mlp_specs(cfg)}


def _one_block_lora_specs(cfg):
    return {"attn": common.attn_lora_specs(cfg)}


def lm_specs(cfg):
    _require_dense(cfg)
    frozen = {
        "embed": Spec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), "embed"),
        "blocks": stack_specs(cfg.num_layers, _one_block_specs(cfg)),
        "final_norm": common.norm_specs(cfg.norm, cfg.d_model),
    }
    if not cfg.tie_embeddings:
        frozen["head"] = Spec((cfg.d_model, cfg.padded_vocab), ("embed", "vocab"))
    lora = {"blocks": stack_specs(cfg.num_layers, _one_block_lora_specs(cfg))}
    return {"frozen": frozen, "lora": lora}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _block_apply(cfg, p, lp, x, *, positions, cache=None, window=0,
                 chunk=2048):
    xn = apply_norm(cfg.norm, p["ln1"], x)
    h, new_cache = common.attn_apply(
        cfg, p["attn"], lp["attn"] if lp else None, xn,
        positions=positions, cache=cache, window=window, chunk=chunk)
    x = x + h
    xn = apply_norm(cfg.norm, p["ln2"], x)
    return x + apply_mlp(cfg, p["mlp"], xn), new_cache


def _block_out(cfg, p, lp, x, **opts):
    return _block_apply(cfg, p, lp, x, **opts)[0]


def _run_blocks(cfg, frozen, lora, x, lo, hi, *, positions, window, chunk,
                remat):
    """Blocks ``frozen["blocks"][lo:hi]`` in order (Python slicing, as the
    JAX package slices its stacked leaves); with ``remat`` each block's
    activations are recomputed in the backward instead of kept."""
    blocks = frozen["blocks"][lo:hi]
    lblocks = lora["blocks"][lo:hi] if lora else [None] * len(blocks)
    for p, lp in zip(blocks, lblocks):
        body = functools.partial(_block_out, cfg, p, lp, positions=positions,
                                 window=window, chunk=chunk)
        x = (checkpoint(body, x, use_reentrant=False, preserve_rng_state=False)
             if remat else body(x))
    return x


def run_block_range(cfg, frozen, lora, x, lo: int, hi: int, *,
                    positions=None, window=0, chunk=2048, remat=False):
    """Decoder blocks ``[lo, hi)`` — the causal-LM split-learning building
    block.  Returns the transformed activations."""
    if lo == hi:
        return x
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    return _run_blocks(cfg, frozen, lora, x, lo, hi, positions=positions,
                       window=window, chunk=chunk, remat=remat)


def lm_forward(cfg, params, lora, tokens, *, window=0, chunk=2048,
               remat=True, boundaries=None, channel=None):
    """tokens: (B, S) -> logits (B, S, padded_vocab), aux loss.

    ``boundaries=(b1, b2)`` + ``channel`` enable ELSA's tripartite split:
    the layer stack is cut at blocks b1 and b1+b2 (Part 1 / Part 2 /
    Part 3) and activations crossing each cut pass through ``channel``
    (SS-OP ∘ sketch ∘ decode ∘ SS-OPᵀ).  The channel stays outside the
    rematerialized blocks, as in the JAX package.
    """
    _require_dense(cfg)
    frozen = params
    S = tokens.shape[1]
    x = frozen["embed"][tokens].to(cfg.adtype())
    positions = torch.arange(S, device=x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    seg = dict(positions=positions, window=window, chunk=chunk, remat=remat)
    n = cfg.num_layers
    if boundaries and channel is not None:
        b1, b2 = boundaries
        x = _run_blocks(cfg, frozen, lora, x, 0, b1, **seg)
        x = channel(x)                           # client -> edge cut
        x = _run_blocks(cfg, frozen, lora, x, b1, b1 + b2, **seg)
        x = channel(x)                           # edge -> client cut
        x = _run_blocks(cfg, frozen, lora, x, b1 + b2, n, **seg)
    else:
        x = _run_blocks(cfg, frozen, lora, x, 0, n, **seg)
    x = apply_norm(cfg.norm, frozen["final_norm"], x)
    head = frozen.get("head", None)
    logits = (x @ frozen["embed"].T.to(x.dtype) if head is None
              else x @ head.to(x.dtype))
    return logits, aux_total


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def lm_cache_specs(cfg, batch: int, seq_len: int):
    """Per-layer decode cache.  ``len`` is the write cursor, a host int
    (the JAX package keeps a device scalar), so a step never syncs on it;
    :func:`repro_torch.models.params.init_tree` keeps it as it is."""
    _require_dense(cfg)
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    window = cfg.sliding_window
    ring = bool(window) and seq_len > window
    s_cache = window if ring else seq_len
    one = {"k": Spec((batch, s_cache, kv, hd), ("batch", None, "kv_heads", None)),
           "v": Spec((batch, s_cache, kv, hd), ("batch", None, "kv_heads", None)),
           "len": 0}
    if ring:
        one["pos"] = Spec((s_cache,), (None,), "const", -1e9, "int32")
    return {"blocks": stack_specs(cfg.num_layers, one)}


def lm_decode_step(cfg, params, lora, cache, tokens, *, window=0, chunk=4096):
    """tokens: (B, 1) -> (logits (B, 1, padded_vocab), new_cache).

    The cache's tensors are updated in place (see ``common.attn_apply``).
    """
    frozen = params
    x = frozen["embed"][tokens].to(cfg.adtype())
    new_blocks = []
    for i, (p, c) in enumerate(zip(frozen["blocks"], cache["blocks"])):
        lp = lora["blocks"][i] if lora else None
        pos = c["len"] + torch.arange(1, device=x.device)
        x, nc = _block_apply(cfg, p, lp, x, positions=pos, cache=c,
                             window=window, chunk=chunk)
        new_blocks.append(nc)
    x = apply_norm(cfg.norm, frozen["final_norm"], x)
    head = frozen.get("head", None)
    logits = (x @ frozen["embed"].T.to(x.dtype) if head is None
              else x @ head.to(x.dtype))
    return logits, {"blocks": new_blocks}
