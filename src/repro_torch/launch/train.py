"""Step builders and the LoRA fine-tuning CLI.

``make_train_step`` builds the LoRA fine-tuning step (frozen backbone, the
paper's adapter-only optimization): loss -> grads over the LoRA tree ->
AdamW, optionally through ELSA's tripartite split channel.
``make_serve_step`` builds the single-token decode step.

The counterpart of the JAX package's ``repro/launch/train.py``.  Its
per-pod LoRA replicas, cloud sync and sharding assembly wait for the
multi-GPU slice (ROADMAP.md, queue 8).

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --full --elsa
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.sketch import SketchPlan
from repro_torch.core.split_training import Channel, loss_and_grad
from repro_torch.core.ssop import SSOP
from repro_torch.models import zoo
from repro_torch.optim import AdamW
from repro_torch.optim.optimizers import tree_map

SSOP_RANK = 16
SKETCH_ROWS = 3
SKETCH_RHO = 2.1


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def elsa_boundaries(cfg) -> tuple:
    """Default tripartite split for an arch: p = min(p_max, L//4),
    o_fix = 2 (ELSA §III.B.2 with the paper's p_max=6)."""
    n = cfg.num_layers - (cfg.moe.first_dense_layers if cfg.moe else 0)
    p = max(1, min(6, n // 4))
    o = 2
    return (p, n - p - o)


def elsa_channel_specs(cfg, *, r: int = SSOP_RANK, y: int = SKETCH_ROWS,
                       rho: float = SKETCH_RHO):
    """The channel parameters' shapes and dtypes, ``{name: (shape,
    dtype)}``, and the sketch's bucket count Z."""
    d = cfg.d_model
    z = max(8, int(d / (rho * y)))
    return {
        "u": ((d, r), "float32"),
        "v": ((r, r), "float32"),
        "bucket": ((y, d), "int32"),
        "sign": ((y, d), "float32"),
    }, z


def make_train_step(cfg: ArchConfig, *, optimizer: Optional[AdamW] = None,
                    window: int = 0, chunk: int = 2048,
                    per_pod_lora: bool = False, use_flash: bool = False,
                    num_microbatches: int = 1, elsa_z: int = 0):
    """LoRA fine-tuning step ``(frozen, lora, opt_state, batch) ->
    (new_lora, new_opt_state, loss)``.  ``num_microbatches > 1`` runs
    gradient accumulation over microbatch slices of the batch.

    If the batch carries a ``'_channel'`` entry (u, v, bucket, sign) and
    ``elsa_z`` is set, the ELSA tripartite split channel is applied at the
    Eq. 8-9 boundaries inside the layer stack.  The channel is built from
    those tensors on every call, as the JAX package builds it inside its
    step; the sketch's plan (its inverse and packed indices) too, unless the
    entry also carries it as ``plan``, as the launcher's does, which builds
    it once for all its steps.

    ``use_flash`` is accepted and changes nothing, as in the JAX package
    (which takes the flag and does not pass it on): the port's cache-free
    attention is flash attention, so on the card every training step runs
    the flash kernel (:func:`repro_torch.models.common.gqa_attention`)."""
    if per_pod_lora:
        raise NotImplementedError(
            "per_pod_lora: per-pod LoRA replicas need the multi-GPU engine "
            "(ROADMAP.md, queue 8)")
    model = zoo.get_model(cfg)
    opt = optimizer or AdamW(lr=1e-4)

    def single_loss(frozen, lp, batch, channel_params=None):
        fwd = dict(window=window, chunk=chunk, remat=True)
        if channel_params is not None and cfg.family in ("dense", "moe"):
            plan = channel_params.get("plan")
            if plan is None:
                plan = SketchPlan(channel_params["bucket"],
                                  channel_params["sign"], elsa_z)
            ch = Channel(SSOP(channel_params["u"], channel_params["v"]), plan)
            fwd.update(boundaries=elsa_boundaries(cfg), channel=ch)
        logits, aux = model.forward(cfg, frozen, lp, batch, **fwd)
        return zoo.loss_fn(cfg, logits, batch["tokens"], aux)

    def value_and_grad(frozen, lora, batch, channel_params):
        return loss_and_grad(
            lambda lp: single_loss(frozen, lp, batch, channel_params), lora)

    def step(frozen, lora, opt_state, batch):
        batch = dict(batch)
        channel_params = batch.pop("_channel", None)
        nm = num_microbatches
        if nm <= 1:
            loss, grads = value_and_grad(frozen, lora, batch, channel_params)
        else:
            # microbatch i takes rows i, i + nm, i + 2 nm, ... (the JAX
            # package's (B/nm, nm) reshape then swap)
            g_sum = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), lora)
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(nm):
                mb = {k: v[i::nm] for k, v in batch.items()}
                l, g = value_and_grad(frozen, lora, mb, channel_params)
                g_sum = tree_map(lambda a, b: a + b.to(a.dtype), g_sum, g)
                loss = loss + l
            grads = tree_map(lambda g: g / nm, g_sum)
            loss = loss / nm
        with torch.no_grad():
            new_lora, new_opt = opt.update(lora, grads, opt_state)
        return new_lora, new_opt, loss

    return step


def make_serve_step(cfg: ArchConfig, *, window: int = 0, chunk: int = 4096):
    """Greedy single-token decode step against a KV cache:
    ``(frozen, lora, cache, {"tokens": (B, 1)}) -> (next (B,), cache)``."""
    model = zoo.get_model(cfg)

    @torch.inference_mode()
    def serve_step(frozen, lora, cache, batch):
        logits, new_cache = model.decode_step(cfg, frozen, lora, cache,
                                              batch, window=window,
                                              chunk=chunk)
        nxt = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)
        return nxt.to(torch.int32), new_cache

    return serve_step


# ---------------------------------------------------------------------------
# the launcher's channel and data
# ---------------------------------------------------------------------------

def channel_params(cfg, z: int, device="cuda"):
    """The launcher's ELSA channel: ``v``, ``bucket`` and ``sign`` from
    ``numpy.random.default_rng(42)`` by the JAX launcher's own calls (so
    they are bit-identical to its); ``u`` from a ``torch.Generator`` seeded
    42, orthonormalized by QR.  The JAX launcher draws ``u`` from
    ``jax.random``, which PyTorch cannot replay: tests carry its ``u``
    across instead."""
    rng = np.random.default_rng(42)
    q_, _ = np.linalg.qr(rng.standard_normal((SSOP_RANK, SSOP_RANK)))
    bucket = rng.integers(0, z, (SKETCH_ROWS, cfg.d_model)).astype(np.int32)
    sign = rng.choice([-1.0, 1.0], (SKETCH_ROWS, cfg.d_model)
                      ).astype(np.float32)
    gen = torch.Generator(device=device).manual_seed(42)
    u = torch.linalg.qr(torch.randn((cfg.d_model, SSOP_RANK), generator=gen,
                                    device=device))[0]
    return {"u": u,
            "v": torch.from_numpy(q_.astype(np.float32)).to(device),
            "bucket": torch.from_numpy(bucket).to(device),
            "sign": torch.from_numpy(sign).to(device)}


def batch_stream(cfg, batch: int, seq: int, device="cuda"):
    """The launcher's synthetic LM stream (structured bigram-ish data so the
    loss can fall), drawn from ``numpy.random.default_rng(0)`` by the JAX
    launcher's own calls: yields ``{"tokens": (batch, seq) int64}``."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, cfg.vocab_size, size=(64,))
    while True:
        starts = rng.integers(0, 64, size=(batch,))
        toks = np.stack([np.roll(base, -s)[:seq] for s in starts])
        noise = rng.integers(0, cfg.vocab_size, toks.shape)
        mask = rng.random(toks.shape) < 0.1
        yield {"tokens": torch.from_numpy(np.where(mask, noise, toks)
                                          ).to(device)}


# ---------------------------------------------------------------------------
# CLI: single-device LoRA fine-tuning on synthetic LM data
# ---------------------------------------------------------------------------

def _main(argv=None):
    """Returns ``{"losses": [(step, loss)], "step_s": [s per step],
    "lora": the trained LoRA tree}`` for the steps it logged; each logged
    step ends in a device sync.  ``--ckpt PATH`` writes the trained tree
    with ``save_state(PATH, params={"lora": lora}, step=steps)``, in the
    port's layout (``"blocks"`` a list of per-layer dicts)."""
    import argparse
    import time

    from repro_torch.checkpoint import save_state
    from repro_torch.configs import ASSIGNED, get_config
    from repro_torch.models.params import count_params, init_tree

    ap = argparse.ArgumentParser(
        description="LoRA fine-tune an assigned arch on synthetic LM data")
    ap.add_argument("--arch", default="olmo-1b", choices=ASSIGNED)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--full", action="store_true",
                    help="full-size config (needs the card)")
    ap.add_argument("--elsa", action="store_true",
                    help="train through the ELSA tripartite split channel")
    ap.add_argument("--ckpt", default="",
                    help="write the trained LoRA tree here (save_state)")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    model = zoo.get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    tree = init_tree(model.specs(cfg), gen, cfg.dtype(), device)
    frozen, lora = tree["frozen"], tree["lora"]
    n_frozen = count_params(model.specs(cfg)["frozen"])
    n_lora = count_params(model.specs(cfg)["lora"])
    print(f"{args.arch}{'' if args.full else ' (reduced)'}: "
          f"{n_frozen/1e6:.1f}M frozen + {n_lora/1e6:.2f}M LoRA params")

    opt = AdamW(lr=args.lr)
    opt_state = opt.init(lora)
    elsa_z = 0
    ch = None
    if args.elsa and cfg.family in ("dense", "moe"):
        _, elsa_z = elsa_channel_specs(cfg)
        ch = channel_params(cfg, elsa_z, device)
        ch["plan"] = SketchPlan(ch["bucket"], ch["sign"], elsa_z)
    step = make_train_step(cfg, optimizer=opt, elsa_z=elsa_z)
    batches = batch_stream(cfg, args.batch, args.seq, device)

    out = {"losses": [], "step_s": []}
    t0 = time.time()
    for i in range(args.steps):
        t_step = time.time()
        batch = next(batches)
        if ch is not None:
            batch["_channel"] = ch
        lora, opt_state, loss = step(frozen, lora, opt_state, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            loss = float(loss)                 # syncs with the device
            out["losses"].append((i, loss))
            out["step_s"].append(time.time() - t_step)
            print(f"step {i:5d}  loss {loss:.4f}  "
                  f"({(time.time()-t0):.1f}s)", flush=True)
    out["lora"] = lora
    if args.ckpt:
        save_state(args.ckpt, params={"lora": lora}, step=args.steps)
        print(f"saved LoRA checkpoint -> {args.ckpt}")
    return out


if __name__ == "__main__":
    _main()
