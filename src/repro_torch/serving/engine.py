"""Batched generation engine over the zoo decode path.

The counterpart of the JAX package's ``repro/serving/engine.py``, with the
same behaviour: tick-synchronous static batching, requests admitted a full
batch at a time at a tick boundary (left-aligned, prompts consumed
token-by-token through the same step that decodes, "piggyback prefill"),
greedy argmax, EOS / max-new-token termination per slot, one uniform cache
cursor for the batch, adapter hot-swap and throughput accounting.

The engine runs on ``device`` (default ``"cuda"``); the CPU only when the
caller passes ``device="cpu"``.  The cache cursor is a host int, and the
cache tensors are written in place by the decode step.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import telemetry as tm
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.train import make_serve_step
from repro_torch.models import zoo
from repro_torch.models.params import init_tree


@dataclasses.dataclass
class GenerationRequest:
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # filled by the engine
    request_id: int = -1
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    submitted_at: float = 0.0
    finished_at: float = 0.0


class ServingEngine:
    """batch_size requests generate in lock-step; next batch starts when
    every slot finishes (static batching)."""

    def __init__(self, cfg: ArchConfig, params=None, *, batch_size: int = 4,
                 max_len: int = 128, seed: int = 0, greedy: bool = True,
                 device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = zoo.get_model(cfg)
        self.batch_size = batch_size
        self.max_len = max_len
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_tree(self.model.specs(cfg), gen, cfg.dtype(),
                               self.device)
        self.frozen, self.lora = params["frozen"], params["lora"]
        self.queue: deque = deque()
        self._next_id = 0
        self.stats = {"requests": 0, "tokens": 0, "ticks": 0,
                      "decode_s": 0.0}
        self._step = make_serve_step(cfg, window=cfg.sliding_window)

    # ------------------------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int = 16,
               eos_id: Optional[int] = None) -> GenerationRequest:
        req = GenerationRequest(prompt=list(prompt),
                                max_new_tokens=max_new_tokens,
                                eos_id=eos_id, request_id=self._next_id,
                                submitted_at=time.time())
        self._next_id += 1
        self.queue.append(req)
        return req

    def swap_adapter(self, lora) -> None:
        """Hot-swap the serving LoRA (e.g. after a cloud fusion) between
        batches; the next tick decodes with the new adapter."""
        self.lora = lora
        tm.inc("serving.adapter_swaps", 1)

    def _fresh_cache(self):
        # every cache leaf is zeros/const: the generator draws nothing
        gen = torch.Generator(device=self.device).manual_seed(1)
        return init_tree(self.model.cache_specs(self.cfg, self.batch_size,
                                                self.max_len),
                         gen, self.cfg.dtype(), self.device)

    # ------------------------------------------------------------------
    def run_batch(self) -> List[GenerationRequest]:
        """Admit up to batch_size queued requests and run them to
        completion.  Returns the finished requests."""
        batch: List[GenerationRequest] = []
        while self.queue and len(batch) < self.batch_size:
            batch.append(self.queue.popleft())
        if not batch:
            return []
        b = self.batch_size
        cache = self._fresh_cache()

        prompts = [r.prompt for r in batch]
        max_prompt = max(len(p) for p in prompts)
        max_new = max(r.max_new_tokens for r in batch)
        horizon = min(max_prompt + max_new, self.max_len)

        tok = np.zeros((b, 1), np.int64)
        for i, p in enumerate(prompts):
            tok[i, 0] = p[0]
        active = np.array([i < len(batch) for i in range(b)])

        t0 = time.time()
        for t in range(1, horizon):
            nxt, cache = self._step(self.frozen, self.lora, cache,
                                    {"tokens": torch.from_numpy(tok).to(
                                        self.device)})
            nxt = nxt.cpu().numpy()
            self.stats["ticks"] += 1
            for i, r in enumerate(batch):
                if not active[i]:
                    continue
                if t < len(r.prompt):
                    tok[i, 0] = r.prompt[t]           # still consuming prompt
                else:
                    gen = int(nxt[i])
                    r.output.append(gen)
                    self.stats["tokens"] += 1
                    tok[i, 0] = gen
                    if ((r.eos_id is not None and gen == r.eos_id)
                            or len(r.output) >= r.max_new_tokens):
                        r.done = True
                        r.finished_at = time.time()
                        active[i] = False
            if not active[: len(batch)].any():
                break
        self.stats["decode_s"] += time.time() - t0
        for r in batch:
            if not r.done:
                r.done = True
                r.finished_at = time.time()
            self.stats["requests"] += 1
        if tm.enabled():
            for r in batch:
                tm.observe("serving.request_s",
                           max(r.finished_at - r.submitted_at, 0.0))
            tm.inc("serving.requests", len(batch))
            tm.inc("serving.tokens",
                   sum(len(r.output) for r in batch))
        return batch

    def run_until_drained(self) -> List[GenerationRequest]:
        out: List[GenerationRequest] = []
        while self.queue:
            out.extend(self.run_batch())
        return out

    # ------------------------------------------------------------------
    def throughput(self) -> Dict[str, float]:
        dt = max(self.stats["decode_s"], 1e-9)
        return {"tokens_per_s": self.stats["tokens"] / dt,
                "requests": float(self.stats["requests"]),
                "ticks": float(self.stats["ticks"])}
