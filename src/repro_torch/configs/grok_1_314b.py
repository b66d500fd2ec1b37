"""Grok-1-314B [hf:xai-org/grok-1] — MoE, 8 experts top-2.

64 layers, d_model=6144, 48 heads (GQA kv=8), expert d_ff=32768,
vocab=131072, every block is MoE.  The same values as the JAX package's
``repro/configs/grok_1_314b.py``.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    act="gelu",
    moe=MoEConfig(num_experts=8, experts_per_token=2, expert_d_ff=32768,
                  every=1, capacity_factor=1.25),
    supports_long_context=False,  # full attention; long_500k skipped
    source="hf:xai-org/grok-1 model card",
)
