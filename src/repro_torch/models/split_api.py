"""Model-agnostic split-federation API: the ``SplitModel`` protocol.

ELSA's splitting, sketching, and aggregation (§III.B.2, Eqs. 7–9) are
defined over an abstract M-block model: an embedding, a stack of blocks
cut at ``(p, p+q)``, and a task head.  Every split-federation consumer
(:mod:`repro_torch.core.split_training`, the
:class:`~repro_torch.federation.simulation.Federation` harness) dispatches
on this protocol.

The counterpart of the JAX package's ``repro/models/split_api.py``:

- ``specs(num_classes)`` / ``lora_specs(num_classes)`` — parameter Spec
  trees (``{"frozen": ..., "lora": ...}``);
- ``embed(frozen, tokens)`` — token ids -> block-stack activations;
- ``run_blocks(frozen, lora, x, lo, hi)`` — run blocks ``[lo, hi)``;
- ``head(frozen, lora, x)`` -> ``(repr, logits)``;
- ``per_example_loss(logits, batch)`` -> ``(B,)``;
- ``accuracy(logits, tokens, labels)`` — host-side eval metric;
- ``num_blocks`` / ``activation_shape`` / ``block_param_count`` /
  ``head_param_count`` / ``flops_per_token`` — the shape and 6ND cost
  facts.

Adapters: :class:`BertSplitModel` (the paper's encoder, classification
readout at [CLS]) and :class:`CausalLMSplitModel` (any dense decoder-only
LM of the port's registry, llama/qwen/olmo-style, with a next-token-CE
task).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.configs import REGISTRY as ARCH_REGISTRY, get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.models import bert as bert_mod
from repro_torch.models import transformer
from repro_torch.models.common import apply_norm
from repro_torch.models.params import count_params
from repro_torch.models.zoo import per_example_ce


# ---------------------------------------------------------------------------
# the protocol
# ---------------------------------------------------------------------------

class SplitModel:
    """Abstract M-block model the split-federation machinery runs on.

    Subclasses adapt one architecture family; instances are stateless
    wrappers around an :class:`ArchConfig` (parameters are always passed
    in, never held)."""

    #: "classification" (labels readout) or "causal-lm" (next-token CE)
    task: str = "classification"

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg

    @property
    def name(self) -> str:
        return self.cfg.name

    @property
    def num_blocks(self) -> int:
        """Number of splittable blocks (Eq. 7's M)."""
        return self.cfg.num_layers

    # -- parameters ---------------------------------------------------------
    def specs(self, num_classes: int = 2):
        """{"frozen": SpecTree, "lora": SpecTree} for this model."""
        raise NotImplementedError

    def lora_specs(self, num_classes: int = 2):
        """The trainable (uplinked) LoRA subtree."""
        return self.specs(num_classes)["lora"]

    # -- split execution ----------------------------------------------------
    def embed(self, frozen, tokens):
        raise NotImplementedError

    def run_blocks(self, frozen, lora, x, lo: int, hi: int,
                   mask_valid=None):
        raise NotImplementedError

    def head(self, frozen, lora, x):
        """Block-stack output -> (pooled repr (B, D), task logits)."""
        raise NotImplementedError

    def forward(self, frozen, lora, tokens, mask_valid=None):
        """Full (unsplit) pass: embed -> all blocks -> head."""
        x = self.embed(frozen, tokens)
        x = self.run_blocks(frozen, lora, x, 0, self.num_blocks, mask_valid)
        return self.head(frozen, lora, x)

    def probe_repr(self, frozen, lora, tokens):
        """Pooled embedding of public probes (fingerprints, SS-OP)."""
        return self.forward(frozen, lora, tokens)[0]

    # -- task ---------------------------------------------------------------
    def per_example_loss(self, logits, batch):
        raise NotImplementedError

    def accuracy(self, logits, tokens, labels) -> float:
        raise NotImplementedError

    # -- shape / cost facts -------------------------------------------------
    def activation_shape(self, batch: int, seq: int):
        """Shape of an activation crossing a split boundary (pre-sketch)."""
        return (batch, seq, self.cfg.d_model)

    def block_param_count(self, num_classes: int = 2) -> float:
        """Per-block parameter count (frozen + LoRA), for 6ND FLOPs."""
        specs = self.specs(num_classes)
        total = float(count_params(specs["frozen"]["blocks"]))
        lora_blocks = specs["lora"].get("blocks")
        if lora_blocks is not None:
            total += float(count_params(lora_blocks))
        return total / self.num_blocks

    def head_param_count(self, num_classes: int = 2) -> float:
        raise NotImplementedError

    def flops_per_token(self, split=None, num_classes: int = 2) -> float:
        """6ND training FLOPs per token; a tripartite ``split`` counts only
        the client-side parts (Part 1's ``p`` + Part 3's ``o`` blocks plus
        the head)."""
        blk = self.block_param_count(num_classes)
        head = self.head_param_count(num_classes)
        n_blocks = (self.num_blocks if split is None
                    else split.p + split.o)
        return 6.0 * (n_blocks * blk + head)


# ---------------------------------------------------------------------------
# adapters
# ---------------------------------------------------------------------------

class BertSplitModel(SplitModel):
    """The paper's own model (§IV.A): post-LN encoder, [CLS] pooler +
    classification head (both trainable alongside the LoRA adapters).

    ``pooling`` selects the readout: ``"cls"`` (position 0 through the tanh
    pooler, the paper's convention) or ``"mean"`` (mean over positions
    straight into a zero-initialised linear classifier)."""

    task = "classification"

    def __init__(self, cfg: ArchConfig, pooling: str = "cls"):
        if pooling not in ("cls", "mean"):
            raise ValueError(f"unknown pooling {pooling!r}")
        super().__init__(cfg)
        self.pooling = pooling

    def with_pooling(self, pooling: str) -> "BertSplitModel":
        return type(self)(self.cfg, pooling)

    def specs(self, num_classes: int = 2):
        specs = bert_mod.bert_specs(self.cfg, num_classes)
        if self.pooling == "mean":
            # zero-init the linear classifier of the mean-pool readout
            w = specs["lora"]["head"]["w"]
            specs["lora"]["head"]["w"] = w._replace(init="zeros")
        return specs

    def embed(self, frozen, tokens):
        return bert_mod.embed(self.cfg, frozen, tokens)

    def run_blocks(self, frozen, lora, x, lo: int, hi: int,
                   mask_valid=None):
        return bert_mod.run_blocks(self.cfg, frozen, lora, x, lo, hi,
                                   mask_valid)

    def head(self, frozen, lora, x):
        if self.pooling == "mean":
            src = x.mean(dim=1)
            logits = src @ lora["head"]["w"].to(src.dtype) \
                + lora["head"]["b"].to(src.dtype)
            return src, logits
        cls = x[:, 0, :]
        pooled = torch.tanh(cls @ lora["pooler"]["w"].to(cls.dtype)
                            + lora["pooler"]["b"].to(cls.dtype))
        logits = pooled @ lora["head"]["w"].to(cls.dtype) \
            + lora["head"]["b"].to(cls.dtype)
        return cls, logits

    def per_example_loss(self, logits, batch):
        return per_example_ce(logits, batch["labels"])

    def accuracy(self, logits, tokens, labels) -> float:
        pred = torch.argmax(logits, -1).cpu().numpy()
        return float((pred == np.asarray(labels)).mean())

    def head_param_count(self, num_classes: int = 2) -> float:
        lora = self.lora_specs(num_classes)
        return float(count_params(lora["pooler"])
                     + count_params(lora["head"]))


class CausalLMSplitModel(SplitModel):
    """Dense decoder-only causal LM (llama/qwen/olmo-style configs).

    The task head is the (frozen) vocab projection; the per-example loss
    is mean next-token CE with padded-vocab masking, and the pooled
    representation for fingerprints is the mean final hidden state.  MoE
    and prefix-structured decoders are rejected: their layer stacks are
    not uniform block slices."""

    task = "causal-lm"

    def __init__(self, cfg: ArchConfig):
        if cfg.family != "dense" or cfg.moe is not None:
            raise ValueError(
                f"CausalLMSplitModel needs a dense non-MoE decoder config; "
                f"got family={cfg.family!r} moe={cfg.moe is not None}")
        super().__init__(cfg)

    def specs(self, num_classes: int = 2):
        del num_classes   # LM head is the vocab projection, not a classifier
        return transformer.lm_specs(self.cfg)

    def embed(self, frozen, tokens):
        return frozen["embed"][tokens].to(self.cfg.adtype())

    def run_blocks(self, frozen, lora, x, lo: int, hi: int,
                   mask_valid=None):
        x = transformer.run_block_range(self.cfg, frozen, lora, x, lo, hi)
        if mask_valid is not None:
            x = x * mask_valid[..., None].to(x.dtype)
        return x

    def head(self, frozen, lora, x):
        x = apply_norm(self.cfg.norm, frozen["final_norm"], x)
        head = frozen.get("head", None)
        logits = (x @ frozen["embed"].T.to(x.dtype) if head is None
                  else x @ head.to(x.dtype))
        return x.mean(dim=1), logits

    def per_example_loss(self, logits, batch):
        tokens = batch["tokens"]
        lg = logits[:, :-1, :].to(torch.promote_types(logits.dtype,
                                                      torch.float32))
        vp, V = lg.shape[-1], self.cfg.vocab_size
        if vp > V:
            lg = lg + torch.where(
                torch.arange(vp, device=lg.device) < V, 0.0, -1e30
            ).to(lg.dtype)
        targets = tokens[:, 1:].to(torch.int64)
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, targets[..., None])[..., 0]
        return torch.mean(lse - gold, dim=-1)

    def accuracy(self, logits, tokens, labels) -> float:
        del labels                       # next-token top-1, not class labels
        # argmax on the device: (B, S) ints cross, not (B, S, vocab) floats
        pred = torch.argmax(logits[:, :-1, :self.cfg.vocab_size],
                            -1).cpu().numpy()
        targets = np.asarray(tokens)[:, 1:]
        return float((pred == targets).mean())

    def head_param_count(self, num_classes: int = 2) -> float:
        frozen = self.specs()["frozen"]
        total = float(count_params(frozen["final_norm"]))
        if "head" in frozen:
            total += float(count_params(frozen["head"]))
        else:                            # tied embeddings: output reuses embed
            total += float(np.prod(frozen["embed"].shape))
        return total


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

#: family -> adapter class, consulted by :func:`split_model_for`.
FAMILY_ADAPTERS: Dict[str, Callable[[ArchConfig], "SplitModel"]] = {}


def register_family_adapter(family: str,
                            adapter: Callable[[ArchConfig], "SplitModel"]
                            ) -> None:
    FAMILY_ADAPTERS[family] = adapter


def _adapter_for(cfg: ArchConfig):
    adapter = FAMILY_ADAPTERS.get(cfg.family)
    if adapter is None:
        raise NotImplementedError(
            f"no SplitModel adapter for arch {cfg.name!r} (family "
            f"{cfg.family!r}); subclass SplitModel and add it with "
            f"register_family_adapter({cfg.family!r}, <adapter>)")
    return adapter


register_family_adapter("encoder", BertSplitModel)
register_family_adapter("dense", CausalLMSplitModel)


@lru_cache(maxsize=None)
def split_model_for(cfg: ArchConfig) -> SplitModel:
    """Adapt an existing ``ArchConfig`` (cached per config)."""
    return _adapter_for(cfg)(cfg)


def as_split_model(obj: Union[SplitModel, ArchConfig]) -> SplitModel:
    """SplitModel passthrough / ArchConfig adaptation."""
    return obj if isinstance(obj, SplitModel) else split_model_for(obj)


#: name -> arch id in repro_torch.configs.REGISTRY, or a factory
#: (num_layers=None, dtype=None, **overrides) -> SplitModel
_REGISTRY: Dict[str, Union[str, Callable[..., SplitModel]]] = {}


def register_split_model(name: str,
                         target: Union[str, Callable[..., SplitModel],
                                       None] = None) -> None:
    """Register ``name`` for :func:`get_split_model`.

    ``target`` is an arch id from ``repro_torch.configs.REGISTRY``
    (defaults to ``name``) or a callable ``(num_layers=None, dtype=None,
    **overrides) -> SplitModel`` for custom adapters (a full-width model,
    for one)."""
    _REGISTRY[name] = target if target is not None else name


def available_split_models():
    return sorted(_REGISTRY)


def get_split_model(name: str, *, num_layers: Optional[int] = None,
                    dtype: Optional[str] = None, reduced: bool = True,
                    pooling: Optional[str] = None,
                    **overrides) -> SplitModel:
    """Resolve a registered architecture name to a ``SplitModel``.

    By default the arch config is ``reduced()`` (the federation runs
    reduced models, as in the JAX package) and then overridden with
    ``num_layers`` / ``dtype`` / any ``ArchConfig.with_`` keyword.
    ``pooling`` selects a readout variant on adapters that support one."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown split model {name!r}; registered: "
                       f"{available_split_models()}")
    target = _REGISTRY[name]
    if callable(target):
        m = target(num_layers=num_layers, dtype=dtype, **overrides)
    else:
        cfg = get_config(target)
        if reduced:
            cfg = cfg.reduced()
        kw = dict(overrides)
        if num_layers is not None:
            kw["num_layers"] = num_layers
        if dtype is not None:
            kw.setdefault("param_dtype", dtype)
            kw.setdefault("activation_dtype", dtype)
        if kw:
            cfg = cfg.with_(**kw)
        m = split_model_for(cfg)
    if pooling is not None:
        if not hasattr(m, "with_pooling"):
            raise ValueError(
                f"model {name!r} ({type(m).__name__}) has no pooling "
                "options; pooling= only applies to the encoder family")
        m = m.with_pooling(pooling)
    return m


# every ported config with a family adapter is registered, as in the JAX
# package
for _arch, _cfg in ARCH_REGISTRY.items():
    if _cfg.family == "encoder" or (_cfg.family == "dense"
                                    and _cfg.moe is None):
        register_split_model(_arch)
del _arch, _cfg
