"""Config registry: public ``--arch`` ids -> ArchConfig.

The port registers the architectures whose paths it has ported so far.
Every other id of the JAX package's registry raises ``KeyError`` naming
the ROADMAP queue that brings it over.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, InputShape, INPUT_SHAPES  # noqa: F401
from repro_torch.configs import (bert_base, deepseek_v2_236b, grok_1_314b,
                                  llama3_8b, olmo_1b, qwen1_5_4b, qwen2_5_3b)

REGISTRY = {
    "llama3-8b": llama3_8b.CONFIG,
    "qwen2.5-3b": qwen2_5_3b.CONFIG,
    "olmo-1b": olmo_1b.CONFIG,
    "qwen1.5-4b": qwen1_5_4b.CONFIG,
    "grok-1-314b": grok_1_314b.CONFIG,
    "deepseek-v2-236b": deepseek_v2_236b.CONFIG,
    # the paper's own model
    "bert-base": bert_base.CONFIG,
}

ASSIGNED = [k for k in REGISTRY if k != "bert-base"]


def get_config(arch: str) -> ArchConfig:
    if arch not in REGISTRY:
        raise KeyError(
            f"arch {arch!r} is not ported yet (ROADMAP.md, queue 1: "
            f"modules to port); ported: {sorted(REGISTRY)}")
    return REGISTRY[arch]
