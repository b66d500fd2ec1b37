"""Step builders.  The port has the serving step only: the LoRA training
step and the sharding assembly of the JAX package's
``repro/launch/train.py`` wait for the training slices (ROADMAP.md)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import zoo


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
