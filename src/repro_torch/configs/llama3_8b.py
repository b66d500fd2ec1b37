"""Llama-3-8B [arXiv:2407.21783] — dense GQA decoder, 128k vocab.

32 layers, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=128256.
The same values as the JAX package's ``repro/configs/llama3_8b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    sliding_window=8192,          # used only for the long_500k shape
    supports_long_context=True,
    source="arXiv:2407.21783 (Llama 3), 8B configuration",
)
