"""Shared model primitives: norms, rotary, GQA attention (direct + chunked
online-softmax decode), MLPs, LoRA projections, spec builders.

The counterpart of the JAX package's ``repro/models/common.py``, with the
same layouts at every public function (``wq`` is (D, H, hd), ``wo`` is
(H, hd, D), activations are (B, S, H, hd)) so that tests compare like with
like.  The q/k/v/o projections go through the fused LoRA wrapper
(:func:`repro_torch.kernels.lora.ops.lora_matmul`): on a CUDA tensor that
is the hand-written kernel.  Training differentiates the chunked
attention by autograd through its online-softmax loop, which gives the
gradient of the JAX package's custom VJP ``_chunked_attn``; that VJP's
memory-lean backward, and the flash-attention kernel, are still to port
(ROADMAP.md, queue 2).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.lora.ops import lora_matmul
from repro_torch.models.params import Spec

NEG_INF = -1e30


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

def _mask(q_pos, k_pos, *, causal: bool, window: int, kv_valid=None):
    """q_pos (Sq,), k_pos (Sk,) -> bool (Sq, Sk), True = attend."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    if kv_valid is not None:
        m &= k_pos[None, :] < kv_valid
    return m


def _chunked_attn_fwd_core(qr, ks, vs, kpos_chunks, q_pos, *, causal,
                           window, kv_valid, scale):
    """Online-softmax forward over kv chunks.

    qr: (B,Sq,KV,G,Dh); ks/vs: (nc, B, C, KV, Dh); returns (o, m, l) with
    o (B,KV,G,Sq,Dv) and m/l (B,KV,G,Sq) in the accumulation dtype.
    """
    B, Sq, KV, G, Dh = qr.shape
    Dv = vs.shape[-1]
    acc_dt = _acc_dtype(qr)
    dev = qr.device
    m_run = torch.full((B, KV, G, Sq), NEG_INF, dtype=acc_dt, device=dev)
    l_run = torch.zeros((B, KV, G, Sq), dtype=acc_dt, device=dev)
    acc = torch.zeros((B, KV, G, Sq, Dv), dtype=acc_dt, device=dev)
    qf = qr.to(acc_dt)
    for kc, vc, k_pos in zip(ks, vs, kpos_chunks):
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kc.to(acc_dt)) * scale
        msk = _mask(q_pos, k_pos, causal=causal, window=window,
                    kv_valid=kv_valid)
        s = torch.where(msk, s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.to(vc.dtype), vc).to(acc_dt)
        m_run = m_new
    o = acc / l_run.clamp_min(1e-30)[..., None]
    return o, m_run, l_run


def gqa_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                  kv_offset=0, kv_valid=None, chunk=2048, use_flash=False,
                  scale=None, k_positions=None):
    """Grouped-query attention with online-softmax kv chunking.

    q: (B, Sq, H, Dh); k, v: (B, Sk, KV, Dh).  ``q_offset`` is the absolute
    position of q[:,0]; ``kv_valid`` masks cache slots >= current length;
    ``k_positions`` (Sk,) gives each slot's absolute position (ring cache).
    Never materializes an (Sq, Sk) tensor when Sk > chunk.  The products
    are plain ``torch.einsum``: the JAX package leaves them to XLA too.
    """
    if use_flash:
        raise NotImplementedError(
            "use_flash: the flash-attention kernel "
            "(repro/kernels/flash_attention) is not ported yet (ROADMAP.md, "
            "queue 2: TPU kernels to port, flash attention)")
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    Dv = v.shape[-1]
    scale = Dh ** -0.5 if scale is None else scale
    qr = q.reshape(B, Sq, KV, G, Dh)
    q_pos = q_offset + torch.arange(Sq, device=q.device)

    if Sk <= chunk:
        k_pos = (k_positions if k_positions is not None
                 else kv_offset + torch.arange(Sk, device=q.device))
        acc_dt = _acc_dtype(q)
        s = torch.einsum("bqkgd,bskd->bkgqs", qr.to(acc_dt),
                         k.to(acc_dt)) * scale
        m = _mask(q_pos, k_pos, causal=causal, window=window,
                  kv_valid=kv_valid)
        s = torch.where(m, s, NEG_INF)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.einsum("bkgqs,bskd->bqkgd", p, v)
        return o.reshape(B, Sq, H, Dv)

    if Sk % chunk:
        raise ValueError(f"Sk={Sk} not divisible by chunk={chunk}")
    n_chunks = Sk // chunk
    ks = k.reshape(B, n_chunks, chunk, KV, k.shape[-1]).transpose(0, 1)
    vs = v.reshape(B, n_chunks, chunk, KV, Dv).transpose(0, 1)
    if k_positions is not None:
        kpos_chunks = k_positions.reshape(n_chunks, chunk)
    else:
        kpos_chunks = (kv_offset + torch.arange(Sk, device=q.device)
                       ).reshape(n_chunks, chunk)
    o, _, _ = _chunked_attn_fwd_core(
        qr, ks, vs, kpos_chunks, q_pos, causal=causal, window=window,
        kv_valid=kv_valid, scale=scale)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv).to(q.dtype)


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
