"""Batched serving entry point: prefill-free greedy decode against a KV cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --full

The same CLI as the JAX package's ``repro/launch/serve.py`` plus
``--device`` (default ``cuda``).  Without ``--full`` the config is reduced;
weights are random, drawn from a seeded ``torch.Generator`` on the device.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ASSIGNED, get_config
from repro_torch.launch.train import make_serve_step
from repro_torch.models import zoo
from repro_torch.models.params import init_tree


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=ASSIGNED)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    model = zoo.get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_tree(model.specs(cfg), gen, cfg.dtype(), device)
    cache = init_tree(model.cache_specs(cfg, args.batch, args.cache_len),
                      gen, cfg.dtype(), device)
    serve = make_serve_step(cfg, window=cfg.sliding_window)

    tok = torch.randint(0, cfg.vocab_size, (args.batch, 1), generator=gen,
                        device=device)
    # warmup (builds the kernels on CUDA)
    nxt, cache = serve(params["frozen"], params["lora"], cache,
                       {"tokens": tok})
    _sync(device)
    t0 = time.time()
    for _ in range(args.steps):
        nxt, cache = serve(params["frozen"], params["lora"], cache,
                           {"tokens": nxt[:, None].long()})
    _sync(device)
    dt = time.time() - t0
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else str(device))
    print(f"{args.arch}: {args.steps} decode steps x batch {args.batch} "
          f"in {dt:.2f}s -> {args.steps * args.batch / dt:.1f} tok/s "
          f"({where}, reduced={not args.full})")


if __name__ == "__main__":
    main()
