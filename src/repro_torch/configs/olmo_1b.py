"""OLMo-1B [arXiv:2402.00838] — dense decoder with non-parametric LayerNorm.

16 layers, d_model=2048, 16 heads (MHA: kv=16), d_ff=8192, vocab=50304,
tied embeddings.  The same values as the JAX package's
``repro/configs/olmo_1b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm="nonparametric",
    tie_embeddings=True,
    sliding_window=8192,
    supports_long_context=True,
    source="arXiv:2402.00838 (OLMo), 1B configuration",
)
