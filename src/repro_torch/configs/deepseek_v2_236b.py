"""DeepSeek-V2-236B [arXiv:2405.04434] — MLA + fine-grained MoE.

60 layers, d_model=5120, 128 heads via multi-head latent attention
(kv_lora_rank=512, q_lora_rank=1536, rope 64 + nope 128, v 128),
160 routed experts top-6 + 2 shared experts, expert d_ff=1536,
vocab=102400; first block uses a dense FFN (d_ff 12288).  The same values
as the JAX package's ``repro/configs/deepseek_v2_236b.py``.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,        # MLA: heads share one latent; kept for bookkeeping
    d_ff=1536,
    vocab_size=102400,
    head_dim=128,
    moe=MoEConfig(num_experts=160, experts_per_token=6, num_shared_experts=2,
                  expert_d_ff=1536, every=1, first_dense_layers=1,
                  dense_d_ff=12288, capacity_factor=1.25),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
    supports_long_context=False,  # full attention; long_500k skipped
    source="arXiv:2405.04434 (DeepSeek-V2)",
)
