"""Qwen2.5-3B [hf:Qwen/Qwen2.5-0.5B arch pattern, 3B scale per assignment].

36 layers, d_model=2048, 16 heads (GQA kv=2), d_ff=11008, vocab=151936,
QKV bias.  The same values as the JAX package's
``repro/configs/qwen2_5_3b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    sliding_window=8192,
    supports_long_context=True,
    source="hf:Qwen/Qwen2.5-0.5B (arch pattern), 3B scale per assignment",
)
