"""DeepSeek-V2 Multi-head Latent Attention (MLA) [arXiv:2405.04434].

The counterpart of the JAX package's ``repro/models/mla.py``.  Prefill and
training use the expanded form, whose attention (q·k over 128 nope + 64
rope dims, v 128) is :func:`repro_torch.models.common.gqa_attention`, and so
on a CUDA tensor the flash kernel at (Dqk, Dv) = (192, 128).  Decode uses
the *absorbed* form: queries are projected into the compressed latent
space, so the cache holds only (c_kv, k_rope) — kv_lora_rank + rope_dim per
token, shared by all heads — and attention runs MQA-style over the latent
cache on the einsum path, as in the JAX package.

The LoRA adapters on the query and output paths are plain products here,
as they are einsums outside any Pallas kernel in the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import apply_norm, gqa_attention, rope
from repro_torch.models.params import Spec


def mla_specs(cfg):
    a = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk = a.nope_head_dim + a.rope_head_dim
    p = {
        "w_dq": Spec((d, a.q_lora_rank), ("embed", "lora_r")),
        "q_norm": {"scale": Spec((a.q_lora_rank,), (None,), "ones")},
        "w_uq": Spec((a.q_lora_rank, h, qk), ("lora_r", "heads", None)),
        "w_dkv": Spec((d, a.kv_lora_rank + a.rope_head_dim), ("embed", None)),
        "kv_norm": {"scale": Spec((a.kv_lora_rank,), (None,), "ones")},
        "w_uk": Spec((a.kv_lora_rank, h, a.nope_head_dim), (None, "heads", None)),
        "w_uv": Spec((a.kv_lora_rank, h, a.v_head_dim), (None, "heads", None)),
        "wo": Spec((h, a.v_head_dim, d), ("heads", None, "embed")),
    }
    return p


def mla_lora_specs(cfg):
    """LoRA adapters on the MLA query/output paths."""
    a, r = cfg.mla, cfg.lora.rank
    d, h = cfg.d_model, cfg.num_heads
    qk = a.nope_head_dim + a.rope_head_dim
    out = {}
    if "q" in cfg.lora.targets:
        out["q_a"] = Spec((d, r), ("embed", "lora_r"))
        out["q_b"] = Spec((r, h, qk), ("lora_r", "heads", None), "zeros")
    if "o" in cfg.lora.targets:
        out["o_a"] = Spec((h, a.v_head_dim, r), ("heads", None, "lora_r"))
        out["o_b"] = Spec((r, d), ("lora_r", "embed"), "zeros")
    return out


def _queries(cfg, p, lp, x, positions):
    a = cfg.mla
    ls = cfg.lora.alpha / cfg.lora.rank
    cq = apply_norm("rmsnorm", p["q_norm"], x @ p["w_dq"].to(x.dtype))
    q = torch.einsum("bsr,rhe->bshe", cq, p["w_uq"].to(x.dtype))
    if lp is not None and "q_a" in lp:
        t = x @ lp["q_a"].to(x.dtype)
        q = q + torch.einsum("bsr,rhe->bshe", t, lp["q_b"].to(x.dtype)) * ls
    q_nope = q[..., : a.nope_head_dim]
    q_rope = rope(q[..., a.nope_head_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def _out(cfg, p, lp, o, x):
    ls = cfg.lora.alpha / cfg.lora.rank
    y = torch.einsum("bshe,hed->bsd", o, p["wo"].to(o.dtype))
    if lp is not None and "o_a" in lp:
        t = torch.einsum("bshe,her->bsr", o, lp["o_a"].to(o.dtype))
        y = y + (t @ lp["o_b"].to(o.dtype)) * ls
    return y


def _latent(cfg, p, x, positions):
    """x -> (c_kv (B, S, R) normalised, k_rope (B, S, 1, rope))."""
    a = cfg.mla
    dkv = x @ p["w_dkv"].to(x.dtype)
    c_kv = apply_norm("rmsnorm", p["kv_norm"], dkv[..., : a.kv_lora_rank])
    k_rope = rope(dkv[..., None, a.kv_lora_rank:], positions, cfg.rope_theta)
    return c_kv, k_rope


def mla_full(cfg, p, lp, x, *, positions, chunk=2048):
    """Train/prefill path (expanded keys/values, causal).  q, k and v are
    made contiguous for the flash kernel, which reads whole 16-byte pieces
    of rows (k's rope half is k_rope broadcast over the heads)."""
    a = cfg.mla
    q_nope, q_rope = _queries(cfg, p, lp, x, positions)
    c_kv, k_rope = _latent(cfg, p, x, positions)

    k_nope = torch.einsum("bsr,rhe->bshe", c_kv, p["w_uk"].to(x.dtype))
    v = torch.einsum("bsr,rhe->bshe", c_kv, p["w_uv"].to(x.dtype))

    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope.expand(k_nope.shape[:-1]
                                         + (a.rope_head_dim,))], -1)
    o = gqa_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                      causal=True, q_offset=0, chunk=chunk)
    return _out(cfg, p, lp, o, x)


def mla_decode(cfg, p, lp, x, cache, *, chunk=4096):
    """Absorbed decode: the cache holds (c_kv, k_rope); MQA over the latent.

    As ``common.attn_apply`` does with k/v, the cache's ``c_kv`` and
    ``k_rope`` are written IN PLACE at the cursor ``cache["len"]`` (a host
    int, the write clamped as ``lax.dynamic_update_slice`` clamps it); the
    returned cache holds the same tensors and the advanced cursor."""
    a = cfg.mla
    S1 = x.shape[1]  # 1
    cur = cache["len"]
    positions = cur + torch.arange(S1, device=x.device)
    q_nope, q_rope = _queries(cfg, p, lp, x, positions)
    c_kv_new, k_rope_new = _latent(cfg, p, x, positions)

    ck, cr = cache["c_kv"], cache["k_rope"]
    idx = max(0, min(cur, ck.shape[1] - S1))
    ck[:, idx:idx + S1] = c_kv_new.to(ck.dtype)
    cr[:, idx:idx + S1] = k_rope_new[:, :, 0, :].to(cr.dtype)

    # absorb W_uk into q:  score = <W_uk^T q_nope, c_kv> + <q_rope, k_rope>
    q_lat = torch.einsum("bshe,rhe->bshr", q_nope, p["w_uk"].to(x.dtype))
    q_eff = torch.cat([q_lat, q_rope], -1)                   # (B,1,H,R+rope)
    k_eff = torch.cat([ck, cr], -1)[:, :, None, :]           # (B,S,1,R+rope)

    o_lat = gqa_attention(q_eff, k_eff, ck[:, :, None, :], causal=True,
                          q_offset=cur, kv_valid=cur + S1, chunk=chunk,
                          scale=(a.nope_head_dim + a.rope_head_dim) ** -0.5)
    # project the latent attention output through W_uv per head
    o = torch.einsum("bshr,rhe->bshe", o_lat, p["w_uv"].to(x.dtype))
    new_cache = {"c_kv": ck, "k_rope": cr, "len": cur + S1}
    return _out(cfg, p, lp, o, x), new_cache
