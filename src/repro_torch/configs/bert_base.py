"""BERT-base-uncased — the paper's own LLM (§IV.A: 12 blocks, hidden 768,
12 heads, ~110M params).  Encoder-only: no decode shapes.
"""
from repro_torch.configs.base import ArchConfig, LoRAConfig

CONFIG = ArchConfig(
    name="bert-base",
    family="encoder",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=30522,
    norm="layernorm",
    act="gelu",
    max_position_embeddings=512,
    lora=LoRAConfig(rank=8, alpha=16.0, targets=("q", "v")),
    supports_long_context=False,
    source="ELSA paper §IV.A (BERT-base-uncased)",
)
