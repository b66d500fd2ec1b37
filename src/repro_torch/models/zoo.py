"""Model-zoo interface of the port: :func:`get_model` gives a family's
``specs``, ``forward``, ``cache_specs`` and ``decode_step``, and the losses
(:func:`loss_fn`, :func:`per_example_ce`, :func:`classification_loss`).

The counterpart of the JAX package's ``repro/models/zoo.py`` for the dense
and MoE families (both through ``models/transformer.py``), the encoder's
specs (bert-base), and its :func:`input_specs`.  The
hybrid, ssm, audio and vlm families wait for later slices (ROADMAP.md,
queue 1).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import bert, transformer


class Model(NamedTuple):
    specs: Callable              # cfg -> {'frozen': SpecTree, 'lora': SpecTree}
    forward: Optional[Callable]  # (cfg, frozen, lora, batch, **opts)
    cache_specs: Optional[Callable]   # (cfg, batch, seq_len) -> SpecTree
    decode_step: Optional[Callable]   # (cfg, frozen, lora, cache, batch, **opts)


def _lm_forward(cfg, frozen, lora, batch, **opts):
    return transformer.lm_forward(cfg, frozen, lora, batch["tokens"], **opts)


def _lm_decode(cfg, frozen, lora, cache, batch, **opts):
    return transformer.lm_decode_step(cfg, frozen, lora, cache,
                                      batch["tokens"], **opts)


_LM = Model(transformer.lm_specs, _lm_forward, transformer.lm_cache_specs,
            _lm_decode)
# the encoder's entry gives its specs (the roofline's parameter count); it
# trains through its split model (models/split_api.py) and has no decode
_FAMILIES = {"dense": _LM, "moe": _LM,
             "encoder": Model(bert.bert_specs, None, None, None)}


def get_model(cfg: ArchConfig) -> Model:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (ROADMAP.md, "
            f"queue 1: modules to port)")
    return _FAMILIES[cfg.family]


def input_specs(cfg: ArchConfig, shape: InputShape,
                device="meta") -> Dict[str, torch.Tensor]:
    """The model inputs of (arch, input shape) as empty tensors on
    ``device``: ``tokens`` (B, S) for train and prefill, (B, 1) for decode
    (one new token against a seq_len cache).  Tokens are int64, as the
    port's entry points take them, where the JAX package's are int32: a dry
    run's input bytes are twice JAX's for that reason."""
    if cfg.family in ("vlm", "audio"):
        raise NotImplementedError(
            f"input_specs: the {cfg.family} family is not ported yet "
            f"(ROADMAP.md, queue 1 item 10)")
    seq = shape.seq_len if shape.kind in ("train", "prefill") else 1
    return {"tokens": torch.empty((shape.global_batch, seq),
                                  dtype=torch.int64, device=device)}


def loss_fn(cfg: ArchConfig, logits, tokens, aux=None):
    """Next-token cross entropy with padded-vocab masking: the columns past
    ``vocab_size`` get -1e30 before the logsumexp.  In float32, as the JAX
    package's ``loss_fn`` is."""
    V = cfg.vocab_size
    logits = logits[:, :-1, :].to(torch.float32)
    targets = tokens[:, 1:].long()
    vp = logits.shape[-1]
    if vp > V:
        neg = torch.where(torch.arange(vp, device=logits.device) < V,
                          0.0, -1e30).to(torch.float32)
        logits = logits + neg
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    loss = torch.mean(lse - gold)
    if aux is not None:
        loss = loss + aux.to(torch.float32)
    return loss


def per_example_ce(logits, labels):
    """Per-example cross-entropy (..., C) -> (...); accumulates in at
    least f32 (f64 stays f64 for x64 parity runs)."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - gold


def classification_loss(logits, labels):
    return torch.mean(per_example_ce(logits, labels))
