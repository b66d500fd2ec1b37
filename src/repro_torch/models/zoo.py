"""Model-zoo interface of the port: :func:`get_model` gives a family's
``specs``, ``cache_specs`` and ``decode_step``.

The counterpart of the JAX package's ``repro/models/zoo.py`` for the dense
family.  Its ``forward`` (training/prefill) and every other family wait for
later slices (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


class Model(NamedTuple):
    specs: Callable              # cfg -> {'frozen': SpecTree, 'lora': SpecTree}
    cache_specs: Callable        # (cfg, batch, seq_len) -> SpecTree
    decode_step: Callable        # (cfg, frozen, lora, cache, batch, **opts)


def _lm_decode(cfg, frozen, lora, cache, batch, **opts):
    return transformer.lm_decode_step(cfg, frozen, lora, cache,
                                      batch["tokens"], **opts)


_FAMILIES = {
    "dense": Model(transformer.lm_specs, transformer.lm_cache_specs,
                   _lm_decode),
}


def get_model(cfg: ArchConfig) -> Model:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (ROADMAP.md, "
            f"queue 1: modules to port)")
    return _FAMILIES[cfg.family]
