"""Decoder-only LM covering the dense (llama/qwen/olmo) and MoE
(grok / deepseek-v2-with-MLA) families: specs, the training forward (with
ELSA's split channel), the decode cache and the single-token decode step.

The counterpart of the JAX package's ``repro/models/transformer.py``.  The
JAX layer ``scan`` over stacked blocks becomes a Python loop over a list of
per-layer parameter dicts, and ``jax.checkpoint`` of the scan body becomes
``torch.utils.checkpoint`` of each block.  MoE models may carry leading
dense layers (deepseek's first layer, ``prefix``), run in front of the
blocks and never checkpointed, as the JAX package unrolls them in front of
its scan.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import common
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import apply_mlp, apply_norm, stack_specs
from repro_torch.models.params import Spec


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def _one_block_specs(cfg, *, use_moe: bool, d_ff: Optional[int] = None):
    p = {"ln1": common.norm_specs(cfg.norm, cfg.d_model),
         "ln2": common.norm_specs(cfg.norm, cfg.d_model)}
    p["attn"] = mla_lib.mla_specs(cfg) if cfg.mla else common.attn_specs(cfg)
    if use_moe:
        p["moe"] = moe_lib.moe_specs(cfg)
    else:
        p["mlp"] = common.mlp_specs(cfg, d_ff)
    return p


def _one_block_lora_specs(cfg):
    return {"attn": (mla_lib.mla_lora_specs(cfg) if cfg.mla
                     else common.attn_lora_specs(cfg))}


def _n_prefix(cfg) -> int:
    return cfg.moe.first_dense_layers if cfg.moe else 0


def lm_specs(cfg):
    n_prefix = _n_prefix(cfg)
    n_scan = cfg.num_layers - n_prefix
    frozen = {
        "embed": Spec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), "embed"),
        "blocks": stack_specs(n_scan, _one_block_specs(
            cfg, use_moe=cfg.moe is not None)),
        "final_norm": common.norm_specs(cfg.norm, cfg.d_model),
    }
    if n_prefix:
        frozen["prefix"] = [
            _one_block_specs(cfg, use_moe=False, d_ff=cfg.moe.dense_d_ff)
            for _ in range(n_prefix)]
    if not cfg.tie_embeddings:
        frozen["head"] = Spec((cfg.d_model, cfg.padded_vocab), ("embed", "vocab"))
    lora = {"blocks": stack_specs(n_scan, _one_block_lora_specs(cfg))}
    if n_prefix:
        lora["prefix"] = [_one_block_lora_specs(cfg) for _ in range(n_prefix)]
    return {"frozen": frozen, "lora": lora}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _block_apply(cfg, p, lp, x, *, positions, cache=None, window=0,
                 chunk=2048, use_moe=False):
    """One block -> ``(x, new_cache, aux)``; ``aux`` is the MoE block's
    load-balance loss (None for a dense block: the JAX package adds a zero
    there)."""
    aux = None
    xn = apply_norm(cfg.norm, p["ln1"], x)
    la = lp["attn"] if lp else None
    if cfg.mla:
        if cache is not None:
            h, new_cache = mla_lib.mla_decode(cfg, p["attn"], la, xn, cache)
        else:
            h = mla_lib.mla_full(cfg, p["attn"], la, xn, positions=positions,
                                 chunk=chunk)
            new_cache = None
    else:
        h, new_cache = common.attn_apply(
            cfg, p["attn"], la, xn, positions=positions, cache=cache,
            window=window, chunk=chunk)
    x = x + h
    xn = apply_norm(cfg.norm, p["ln2"], x)
    if use_moe:
        f, aux = moe_lib.moe_apply(cfg, p["moe"], xn)
    else:
        f = apply_mlp(cfg, p["mlp"], xn)
    return x + f, new_cache, aux


def _block_out(cfg, p, lp, x, **opts):
    y, _, aux = _block_apply(cfg, p, lp, x, **opts)
    return y, aux


def _run_blocks(cfg, frozen, lora, x, lo, hi, *, positions, window, chunk,
                remat, use_moe=False, key="blocks"):
    """Blocks ``frozen[key][lo:hi]`` in order (Python slicing, as the JAX
    package slices its stacked leaves) -> ``(x, aux)``, ``aux`` the sum of
    the MoE blocks' load-balance losses (None without MoE blocks); with
    ``remat`` each block's activations are recomputed in the backward
    instead of kept."""
    blocks = frozen[key][lo:hi]
    lblocks = lora[key][lo:hi] if lora else [None] * len(blocks)
    aux = None
    for p, lp in zip(blocks, lblocks):
        body = functools.partial(_block_out, cfg, p, lp, positions=positions,
                                 window=window, chunk=chunk, use_moe=use_moe)
        out = (checkpoint(body, x, use_reentrant=False,
                          preserve_rng_state=False)
               if remat else body(x))
        x, a = out
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def run_block_range(cfg, frozen, lora, x, lo: int, hi: int, *,
                    positions=None, window=0, chunk=2048, remat=False):
    """Decoder blocks ``[lo, hi)`` of the stacked (non-prefix, non-MoE)
    layers — the causal-LM split-learning building block.  Returns the
    transformed activations."""
    if lo == hi:
        return x
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    return _run_blocks(cfg, frozen, lora, x, lo, hi, positions=positions,
                       window=window, chunk=chunk, remat=remat)[0]


def lm_forward(cfg, params, lora, tokens, *, window=0, chunk=2048,
               remat=True, boundaries=None, channel=None):
    """tokens: (B, S) -> logits (B, S, padded_vocab), aux loss.

    ``boundaries=(b1, b2)`` + ``channel`` enable ELSA's tripartite split:
    the layer stack is cut at blocks b1 and b1+b2 (Part 1 / Part 2 /
    Part 3) and activations crossing each cut pass through ``channel``
    (SS-OP ∘ sketch ∘ decode ∘ SS-OPᵀ).  The channel stays outside the
    rematerialized blocks, as in the JAX package.  The cuts count the
    non-prefix blocks; the prefix layers run first, not checkpointed.
    """
    frozen = params
    S = tokens.shape[1]
    x = frozen["embed"][tokens].to(cfg.adtype())
    positions = torch.arange(S, device=x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    n_prefix = _n_prefix(cfg)
    if n_prefix:
        x, _ = _run_blocks(cfg, frozen, lora, x, 0, n_prefix,
                           positions=positions, window=window, chunk=chunk,
                           remat=False, key="prefix")
    seg = dict(positions=positions, window=window, chunk=chunk, remat=remat,
               use_moe=cfg.moe is not None)
    n = cfg.num_layers - n_prefix
    if boundaries and channel is not None:
        b1, b2 = boundaries
        cuts = ((0, b1), (b1, b1 + b2), (b1 + b2, n))
    else:
        cuts = ((0, n),)
    for i, (lo, hi) in enumerate(cuts):
        if i:
            x = channel(x)       # client -> edge, then edge -> client cut
        x, aux = _run_blocks(cfg, frozen, lora, x, lo, hi, **seg)
        if aux is not None:
            aux_total = aux_total + aux
    x = apply_norm(cfg.norm, frozen["final_norm"], x)
    head = frozen.get("head", None)
    logits = (x @ frozen["embed"].T.to(x.dtype) if head is None
              else x @ head.to(x.dtype))
    return logits, aux_total


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def lm_cache_specs(cfg, batch: int, seq_len: int):
    """Per-layer decode cache: k/v (plain or ring), or MLA's latent
    ``c_kv`` and ``k_rope``; the prefix layers' under ``"prefix"``.
    ``len`` is the write cursor, a host int (the JAX package keeps a device
    scalar), so a step never syncs on it;
    :func:`repro_torch.models.params.init_tree` keeps it as it is."""
    n_prefix = _n_prefix(cfg)
    n_scan = cfg.num_layers - n_prefix
    if cfg.mla:
        a = cfg.mla
        one = {"c_kv": Spec((batch, seq_len, a.kv_lora_rank),
                            ("batch", None, None)),
               "k_rope": Spec((batch, seq_len, a.rope_head_dim),
                              ("batch", None, None)),
               "len": 0}
    else:
        kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        window = cfg.sliding_window
        ring = bool(window) and seq_len > window
        s_cache = window if ring else seq_len
        one = {"k": Spec((batch, s_cache, kv, hd),
                         ("batch", None, "kv_heads", None)),
               "v": Spec((batch, s_cache, kv, hd),
                         ("batch", None, "kv_heads", None)),
               "len": 0}
        if ring:
            one["pos"] = Spec((s_cache,), (None,), "const", -1e9, "int32")
    caches = {"blocks": stack_specs(n_scan, one)}
    if n_prefix:
        caches["prefix"] = stack_specs(n_prefix, one)
    return caches


def lm_decode_step(cfg, params, lora, cache, tokens, *, window=0, chunk=4096):
    """tokens: (B, 1) -> (logits (B, 1, padded_vocab), new_cache).

    The cache's tensors are updated in place (see ``common.attn_apply``).
    """
    frozen = params
    x = frozen["embed"][tokens].to(cfg.adtype())
    new_cache = {}
    for key, use_moe in (("prefix", False), ("blocks", cfg.moe is not None)):
        if key not in cache:
            continue
        new_cache[key] = []
        for i, (p, c) in enumerate(zip(frozen[key], cache[key])):
            lp = lora[key][i] if lora else None
            pos = c["len"] + torch.arange(1, device=x.device)
            x, nc, _ = _block_apply(cfg, p, lp, x, positions=pos, cache=c,
                                    window=window, chunk=chunk,
                                    use_moe=use_moe)
            new_cache[key].append(nc)
    x = apply_norm(cfg.norm, frozen["final_norm"], x)
    head = frozen.get("head", None)
    logits = (x @ frozen["embed"].T.to(x.dtype) if head is None
              else x @ head.to(x.dtype))
    return logits, new_cache
