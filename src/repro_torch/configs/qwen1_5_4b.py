"""Qwen1.5-4B [hf:Qwen/Qwen1.5-0.5B arch pattern, 4B scale per assignment].

40 layers, d_model=2560, 20 heads (MHA: kv=20), d_ff=6912, vocab=151936,
QKV bias.  The same values as the JAX package's
``repro/configs/qwen1_5_4b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    sliding_window=8192,
    supports_long_context=True,
    source="hf:Qwen/Qwen1.5-0.5B (arch pattern), 4B scale per assignment",
)
