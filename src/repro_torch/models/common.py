"""Shared model primitives: norms, rotary, GQA attention (direct + chunked
online-softmax decode), MLPs, LoRA projections, spec builders.

The counterpart of the JAX package's ``repro/models/common.py``, with the
same layouts at every public function (``wq`` is (D, H, hd), ``wo`` is
(H, hd, D), activations are (B, S, H, hd)) so that tests compare like with
like.  The q/k/v/o projections go through the fused LoRA wrapper
(:func:`repro_torch.kernels.lora.ops.lora_matmul`): on a CUDA tensor that
is the hand-written kernel.  The cache-free attention (training and
prefill) is flash attention (:func:`repro_torch.kernels.flash_attention.ops.
flash_attention`): on a CUDA tensor the hand-written kernel, with the
memory-lean backward of the JAX package's custom VJP ``_chunked_attn``.
Decode attention over a cache stays on the einsum path, as in the JAX
package.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (NEG_INF, attend_mask,
                                                     attention_ref)
from repro_torch.kernels.lora.ops import lora_matmul
from repro_torch.models.params import Spec


# ---------------------------------------------------------------------------
# spec helpers
# ---------------------------------------------------------------------------

def stack_specs(n: int, tree):
    """``n`` per-layer copies of a block's spec tree (the JAX package
    stacks them on a leading 'layers' axis for ``lax.scan``; the port runs
    a Python loop over a list of layers)."""
    return [tree for _ in range(n)]


def norm_specs(kind: str, d: int):
    if kind == "rmsnorm":
        return {"scale": Spec((d,), ("embed",), "ones")}
    if kind == "layernorm":
        return {"scale": Spec((d,), ("embed",), "ones"),
                "bias": Spec((d,), ("embed",), "zeros")}
    if kind == "nonparametric":
        return {}
    raise ValueError(kind)


def attn_specs(cfg):
    """q/k/v/o projection specs (+ optional bias)."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": Spec((d, h, hd), ("embed", "heads", None)),
        "wk": Spec((d, kv, hd), ("embed", "kv_heads", None)),
        "wv": Spec((d, kv, hd), ("embed", "kv_heads", None)),
        "wo": Spec((h, hd, d), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = Spec((h, hd), ("heads", None), "zeros")
        p["bk"] = Spec((kv, hd), ("kv_heads", None), "zeros")
        p["bv"] = Spec((kv, hd), ("kv_heads", None), "zeros")
    return p


def attn_lora_specs(cfg):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    r = cfg.lora.rank
    out = {}
    dims = {"q": (h, hd), "k": (kv, hd), "v": (kv, hd), "o": (d,)}
    for t in cfg.lora.targets:
        if t not in dims:
            continue
        if t == "o":
            out[f"{t}_a"] = Spec((h, hd, r), ("heads", None, "lora_r"))
            out[f"{t}_b"] = Spec((r, d), ("lora_r", "embed"), "zeros")
        else:
            n, e = dims[t]
            out[f"{t}_a"] = Spec((d, r), ("embed", "lora_r"))
            out[f"{t}_b"] = Spec((r, n, e), ("lora_r", "kv_heads" if t in ("k", "v") else "heads", None), "zeros")
    return out


def mlp_specs(cfg, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.norm == "layernorm":   # classic 2-matrix MLP
        return {"w_in": Spec((d, f), ("embed", "mlp")),
                "b_in": Spec((f,), ("mlp",), "zeros"),
                "w_out": Spec((f, d), ("mlp", "embed")),
                "b_out": Spec((d,), ("embed",), "zeros")}
    return {"w_gate": Spec((d, f), ("embed", "mlp")),
            "w_up": Spec((d, f), ("embed", "mlp")),
            "w_down": Spec((f, d), ("mlp", "embed"))}


# ---------------------------------------------------------------------------
# norms / activations / rotary
# ---------------------------------------------------------------------------

def _acc_dtype(x):
    """Accumulation dtype: at least f32, f64 inputs stay f64."""
    return torch.promote_types(x.dtype, torch.float32)


def apply_norm(kind: str, p, x, eps: float = 1e-5):
    xf = x.to(_acc_dtype(x))
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (y * p["scale"].to(xf.dtype)).to(x.dtype)
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * p["scale"].to(xf.dtype) + p["bias"].to(xf.dtype)
    return y.to(x.dtype)


def activation(kind: str, x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


def rope(x, positions, theta: float):
    """x: (..., S, n, head_dim); positions: (..., S) integer."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., None].to(torch.float32) * freqs     # (...,S,half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# LoRA projections (through the fused kernel)
# ---------------------------------------------------------------------------

def _adapter(lp, target: str, k: int, o: int, like):
    """The target's adapter as the kernel's (K, r) and (r, O) matrices; an
    empty rank-0 pair when the target has none."""
    a = lp.get(f"{target}_a") if lp is not None else None
    if a is None:
        return like.new_zeros((k, 0)), like.new_zeros((0, o))
    b = lp[f"{target}_b"]
    r = a.shape[-1]
    return (a.reshape(k, r).to(like.dtype).contiguous(),
            b.reshape(r, o).to(like.dtype).contiguous())


def project(p, lp, x, target: str, lora_scale: float):
    """Fused frozen projection + LoRA adapter for q/k/v:
    (..., D) -> (..., n, e)."""
    w = p[f"w{target}"]
    d, n, e = w.shape
    a, b = _adapter(lp, target, d, n * e, x)
    y = lora_matmul(x.reshape(-1, d).contiguous(),
                    w.reshape(d, n * e).to(x.dtype).contiguous(), a, b,
                    lora_scale)
    y = y.reshape(x.shape[:-1] + (n, e))
    if f"b{target}" in p:
        y = y + p[f"b{target}"].to(x.dtype)
    return y


def out_project(p, lp, att, x_shape_dtype, lora_scale: float):
    """(..., H, hd) -> (..., D) through the fused LoRA kernel."""
    h, hd, d = p["wo"].shape
    a, b = _adapter(lp, "o", h * hd, d, att)
    y = lora_matmul(att.reshape(-1, h * hd).contiguous(),
                    p["wo"].reshape(h * hd, d).to(att.dtype).contiguous(),
                    a, b, lora_scale)
    return y.reshape(att.shape[:-2] + (d,))


# ---------------------------------------------------------------------------
# attention core
# ---------------------------------------------------------------------------

def gqa_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                  kv_offset=0, kv_valid=None, chunk=2048, use_flash=False,
                  scale=None, k_positions=None):
    """Grouped-query attention.

    q: (B, Sq, H, Dh); k, v: (B, Sk, KV, Dh).  ``q_offset`` is the absolute
    position of q[:,0]; ``kv_valid`` masks cache slots >= current length;
    ``k_positions`` (Sk,) gives each slot's absolute position (ring cache).

    The cache-free case (q_offset and kv_offset 0, no ``kv_valid``, no
    ``k_positions``: what :func:`attn_apply` passes without a cache) is
    :func:`~repro_torch.kernels.flash_attention.ops.flash_attention`, for
    any Sk: on the card it always runs the hand-written kernel, whatever
    ``use_flash`` says (the flag is accepted for the JAX package's
    signature, where it selects the Pallas kernel), and its backward never
    keeps an (Sq, Sk) tensor.  Decode over a cache runs the einsum path:
    direct for Sk <= chunk; beyond it, the online softmax over kv chunks of
    flash attention's plain version
    (:func:`~repro_torch.kernels.flash_attention.ref.attention_ref`).  Its
    products are plain ``torch.einsum``: the JAX package leaves them to XLA
    too.
    """
    if (kv_valid is None and k_positions is None and q_offset == 0
            and kv_offset == 0):
        return flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)
    if k.shape[1] > chunk:
        if k.shape[1] % chunk:
            raise ValueError(f"Sk={k.shape[1]} not divisible by "
                             f"chunk={chunk}")
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale, chunk=chunk, q_offset=q_offset,
                             kv_offset=kv_offset, kv_valid=kv_valid,
                             k_positions=k_positions)[0]
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    Dv = v.shape[-1]
    scale = Dh ** -0.5 if scale is None else scale
    qr = q.reshape(B, Sq, KV, G, Dh)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = (k_positions if k_positions is not None
             else kv_offset + torch.arange(Sk, device=q.device))
    acc_dt = _acc_dtype(q)
    s = torch.einsum("bqkgd,bskd->bkgqs", qr.to(acc_dt),
                     k.to(acc_dt)) * scale
    m = attend_mask(q_pos, k_pos, causal=causal, window=window,
                    kv_valid=kv_valid)
    s = torch.where(m, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v)
    return o.reshape(B, Sq, H, Dv)


def apply_mlp(cfg, p, x, d_ff: Optional[int] = None):
    """Plain products, as the JAX package leaves them to XLA."""
    if "w_in" in p:
        h = activation(cfg.act, x @ p["w_in"].to(x.dtype) + p["b_in"].to(x.dtype))
        return h @ p["w_out"].to(x.dtype) + p["b_out"].to(x.dtype)
    g = activation(cfg.act, x @ p["w_gate"].to(x.dtype))
    return (g * (x @ p["w_up"].to(x.dtype))) @ p["w_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# self-attention sublayer
# ---------------------------------------------------------------------------

def attn_apply(cfg, p, lp, x, *, positions, cache=None, window=0,
               causal=True, chunk=2048):
    """Self-attention sublayer.  Without ``cache`` (train/prefill):
    attention over the sequence itself, positions from 0; returns
    ``(out, None)``.  With ``cache`` (decode): k/v are written at the
    cursor ``cache["len"]`` (a host int) and attention runs over the cache.

    The cache's ``k``/``v`` (and ring ``pos``) tensors are updated IN PLACE,
    where the JAX package returns updated copies: the returned cache holds
    the same tensors and the advanced cursor.
    """
    ls = cfg.lora.alpha / cfg.lora.rank
    q = project(p, lp, x, "q", ls)
    k = project(p, lp, x, "k", ls)
    v = project(p, lp, x, "v", ls)
    if cfg.max_position_embeddings == 0:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if cache is None:
        o = gqa_attention(q, k, v, causal=causal, window=window, q_offset=0,
                          chunk=chunk)
        return out_project(p, lp, o, x, ls), None
    ck, cv, cur = cache["k"], cache["v"], cache["len"]
    S = q.shape[1]
    ring = "pos" in cache          # windowed ring-buffer cache
    idx = cur % ck.shape[1] if ring else cur
    # lax.dynamic_update_slice clamps the start so the update fits
    idx = max(0, min(idx, ck.shape[1] - S))
    ck[:, idx:idx + S] = k.to(ck.dtype)
    cv[:, idx:idx + S] = v.to(cv.dtype)
    if ring:
        pos = cache["pos"]
        pos[idx:idx + S] = cur + torch.arange(S, dtype=pos.dtype,
                                              device=pos.device)
        o = gqa_attention(q, ck, cv, causal=True, window=window,
                          q_offset=cur, k_positions=pos, chunk=chunk)
        new_cache = {"k": ck, "v": cv, "pos": pos, "len": cur + S}
    else:
        o = gqa_attention(q, ck, cv, causal=True, window=window,
                          q_offset=cur, kv_valid=cur + S, chunk=chunk)
        new_cache = {"k": ck, "v": cv, "len": cur + S}
    return out_project(p, lp, o, x, ls), new_cache
