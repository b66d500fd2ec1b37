"""Architecture + run configuration for the PyTorch port.

The dataclasses are the JAX package's (``repro/configs/base.py``) field for
field, so ``reduced()`` gives the same shapes in both packages; only
``dtype()``/``adtype()`` return ``torch.dtype``.  ``MoEConfig`` and
``MLAConfig`` are read by the MoE family (``models/moe.py``,
``models/mla.py``); ``SSMConfig`` is data only here: no module of the port
reads it yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# ---------------------------------------------------------------------------
# Input shapes (assigned).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Architecture configuration.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    num_shared_experts: int = 0
    expert_d_ff: int = 0          # d_ff per expert
    every: int = 1                # MoE layer period (1 = every block)
    first_dense_layers: int = 0   # leading dense blocks (deepseek-v2)
    dense_d_ff: int = 0           # d_ff of the dense blocks when first_dense>0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    # xLSTM
    slstm_every: int = 8          # one sLSTM block per this many blocks
    proj_factor: float = 2.0      # mLSTM up-projection factor
    conv_kernel: int = 4
    # mamba (jamba)
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 -> ceil(d_model/16)
    chunk: int = 128              # chunkwise-parallel scan chunk


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 32.0
    # projection names that receive adapters
    targets: Tuple[str, ...] = ("q", "k", "v", "o")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio | encoder
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0             # 0 -> d_model // num_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"         # rmsnorm | layernorm | nonparametric
    act: str = "silu"             # silu | gelu
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    max_position_embeddings: int = 0   # 0 -> rotary (no table); >0 -> learned table

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    lora: LoRAConfig = dataclasses.field(default_factory=LoRAConfig)

    # hybrid / vlm / audio structure
    attn_every: int = 1           # jamba: attention layer period (others: 1)
    cross_attn_every: int = 0     # vlm: cross-attn layer period (0 = none)
    encoder_layers: int = 0       # audio enc-dec
    num_vision_tokens: int = 1024 # stubbed frontend output length (vlm)
    num_audio_frames: int = 1500  # stubbed frontend output length (audio)

    sliding_window: int = 0       # 0 = full attention; >0 enables windowed attn
    supports_long_context: bool = False  # may run long_500k

    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"

    # citation for the config values
    source: str = ""

    # ---------------- derived -------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so it shards on a 16-way axis."""
        return ((self.vocab_size + 255) // 256) * 256

    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def adtype(self) -> torch.dtype:
        return getattr(torch, self.activation_dtype)

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ---------------- reduced variant for CPU smoke tests ---------------------
    def reduced(self) -> "ArchConfig":
        """Same family, tiny dimensions: 2 layers, d_model<=512, <=4 experts."""
        d_model = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = max(1, min(self.num_kv_heads, heads))
        # keep the GQA ratio representative
        if self.num_kv_heads < self.num_heads:
            kv = max(1, heads // min(self.q_per_kv, heads))
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                experts_per_token=min(self.moe.experts_per_token, 2),
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                expert_d_ff=min(self.moe.expert_d_ff, 128) if self.moe.expert_d_ff else 0,
                every=min(self.moe.every, 2),
                first_dense_layers=min(self.moe.first_dense_layers, 1),
                dense_d_ff=min(self.moe.dense_d_ff, 256) if self.moe.dense_d_ff else 0,
            )
        mla = None
        if self.mla is not None:
            mla = MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                            rope_head_dim=16, nope_head_dim=32, v_head_dim=32)
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, d_state=8, chunk=16)
        # period-structured families keep 2 (reduced) periods
        attn_every = min(self.attn_every, 2) if self.family == "hybrid" else 1
        cross_every = 2 if self.cross_attn_every else 0
        if ssm is not None and self.family == "ssm":
            ssm = dataclasses.replace(ssm, slstm_every=2)
        if self.family == "hybrid":
            n_layers = 2 * attn_every
        elif self.family == "vlm":
            n_layers = 2 * cross_every
        elif self.family == "ssm":
            n_layers = 2 * ssm.slstm_every
        else:
            n_layers = 2
        return dataclasses.replace(
            self,
            num_layers=n_layers,
            attn_every=attn_every,
            cross_attn_every=cross_every,
            encoder_layers=min(self.encoder_layers, 2),
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=0 if self.head_dim == 0 else min(self.head_dim, d_model // heads),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 1024),
            moe=moe, mla=mla, ssm=ssm,
            lora=dataclasses.replace(self.lora, rank=4, alpha=8.0),
            num_vision_tokens=min(self.num_vision_tokens, 16),
            num_audio_frames=min(self.num_audio_frames, 24),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            param_dtype="float32",
            activation_dtype="float32",
            max_position_embeddings=(min(self.max_position_embeddings, 512)
                                     if self.max_position_embeddings else 0),
        )

    def layer_kinds(self) -> list:
        """Per-layer block kinds, e.g. ['mamba','attn',...] for hybrids."""
        kinds = []
        for i in range(self.num_layers):
            if self.family == "ssm":
                kinds.append("slstm" if (self.ssm and self.ssm.slstm_every
                                         and i % self.ssm.slstm_every == self.ssm.slstm_every - 1)
                             else "mlstm")
            elif self.family == "hybrid":
                kinds.append("attn" if i % self.attn_every == self.attn_every // 2
                             else "mamba")
            elif self.family == "vlm":
                kinds.append("cross" if (self.cross_attn_every and
                                         i % self.cross_attn_every == self.cross_attn_every - 1)
                             else "attn")
            else:
                kinds.append("attn")
        return kinds
