"""Synthetic non-IID text corpora (classification and causal-LM tasks).

Public NLP datasets are unavailable offline; we generate class-conditional
token sequences (each class has a distinct unigram distribution over a
vocab segment, plus shared background tokens) so models genuinely learn the
task, and reproduce the paper's heterogeneity controls:

- label skew: Dirichlet(alpha) class proportions per client (§IV.A),
- quantity skew: |D_n| ∝ chi_n = (n+1)/Omega_k (§IV.A),
- unreliable clients: label poisoning on a chosen subset (§IV.A).

The same corpora serve two tasks, matching the two ``SplitModel`` task
kinds (:mod:`repro_torch.models.split_api`):

- ``task_kind="classification"`` (encoders): predict the class label;
  unreliable clients get a fraction of labels randomly flipped;
- ``task_kind="causal-lm"`` (decoder-only LMs): next-token prediction —
  the class-conditional unigram structure is what makes the text
  learnable; unreliable clients get a fraction of their *sequences*
  scrambled to uniform-random tokens (labels never enter the LM loss,
  so label flips would be invisible there).

The JAX package's ``repro/data/synthetic.py``, copied so that the port
imports nothing of ``repro``: numpy only, the same calls in the same
order, so every array comes out bit-equal.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticTaskConfig:
    vocab_size: int = 1024
    num_classes: int = 4
    seq_len: int = 32
    class_sharpness: float = 4.0   # how peaked each class's distribution is
    background_frac: float = 0.5   # fraction of positions drawn iid uniform
    cls_token: int = -1            # >= 0: pin this token at position 0 (a
                                   # [CLS] convention — the classification
                                   # head reads position 0, so a constant
                                   # token there makes the readout position
                                   # carry attention-mixed sequence signal
                                   # instead of a random token's embedding)
    seed: int = 0


@dataclasses.dataclass
class ClientData:
    tokens: np.ndarray             # (n, S) int32
    labels: np.ndarray             # (n,) int32
    poisoned: bool = False


def make_task(cfg: SyntheticTaskConfig):
    """Returns class-conditional unigram distributions (C, V)."""
    rng = np.random.default_rng(cfg.seed)
    logits = rng.normal(0.0, 1.0, (cfg.num_classes, cfg.vocab_size))
    # make classes separable: boost a class-specific segment
    seg = cfg.vocab_size // cfg.num_classes
    for c in range(cfg.num_classes):
        logits[c, c * seg:(c + 1) * seg] += cfg.class_sharpness
    p = np.exp(logits - logits.max(1, keepdims=True))
    return p / p.sum(1, keepdims=True)


def sample_examples(cfg: SyntheticTaskConfig, class_p: np.ndarray,
                    labels: np.ndarray, rng) -> np.ndarray:
    """Sample token sequences for given labels."""
    n = len(labels)
    out = np.empty((n, cfg.seq_len), np.int32)
    n_bg = int(cfg.seq_len * cfg.background_frac)
    for i, c in enumerate(labels):
        sig = rng.choice(cfg.vocab_size, size=cfg.seq_len - n_bg,
                         p=class_p[c])
        bg = rng.integers(0, cfg.vocab_size, size=n_bg)
        seq = np.concatenate([sig, bg])
        rng.shuffle(seq)
        out[i] = seq
    if cfg.cls_token >= 0:
        out[:, 0] = cfg.cls_token
    return out


def dirichlet_partition(num_clients: int, num_classes: int, alpha: float,
                        seed: int = 0) -> np.ndarray:
    """Per-client class proportions ~ Dir(alpha): (N, C)."""
    rng = np.random.default_rng(seed)
    return rng.dirichlet([alpha] * num_classes, size=num_clients)


def quantity_skew(num_clients: int, total: int,
                  edge_of_client: Optional[List[int]] = None) -> np.ndarray:
    """|D_n| ∝ chi_n = (n+1)/Omega (§IV.A quantity skew)."""
    w = np.arange(1, num_clients + 1, dtype=np.float64)
    w = w / w.sum()
    sizes = np.maximum((w * total).astype(np.int64), 8)
    return sizes


def poison_labels(labels: np.ndarray, frac: float, num_classes: int,
                  rng) -> np.ndarray:
    """Randomly relabel a fraction of examples (unreliable clients)."""
    labels = labels.copy()
    n = len(labels)
    idx = rng.choice(n, size=int(frac * n), replace=False)
    labels[idx] = rng.integers(0, num_classes, size=len(idx))
    return labels


def poison_tokens(tokens: np.ndarray, frac: float, vocab_size: int,
                  rng) -> np.ndarray:
    """Scramble a fraction of sequences to uniform-random tokens — the
    causal-LM analogue of label poisoning (unreliable *text*, since
    labels never enter the next-token loss)."""
    tokens = tokens.copy()
    n = len(tokens)
    idx = rng.choice(n, size=int(frac * n), replace=False)
    tokens[idx] = rng.integers(0, vocab_size,
                               size=(len(idx), tokens.shape[1]))
    return tokens


def make_federation_data(cfg: SyntheticTaskConfig, num_clients: int,
                         total_examples: int, alpha: float,
                         poisoned_clients: Tuple[int, ...] = (),
                         poison_frac: float = 0.5,
                         seed: int = 0,
                         task_kind: str = "classification"
                         ) -> Dict[int, ClientData]:
    """Full §IV.A data generation: Dirichlet label skew + quantity skew +
    poisoning.  ``task_kind`` selects how unreliable clients corrupt
    their data: label flips ("classification") or sequence scrambles
    ("causal-lm"); the underlying corpora are identical."""
    rng = np.random.default_rng(seed)
    class_p = make_task(cfg)
    props = dirichlet_partition(num_clients, cfg.num_classes, alpha, seed + 1)
    sizes = quantity_skew(num_clients, total_examples)
    out = {}
    for n in range(num_clients):
        labels = rng.choice(cfg.num_classes, size=sizes[n], p=props[n])
        tokens = sample_examples(cfg, class_p, labels, rng)
        if n in poisoned_clients:
            if task_kind == "causal-lm":
                tokens = poison_tokens(tokens, poison_frac, cfg.vocab_size,
                                       rng)
            else:
                labels = poison_labels(labels, poison_frac,
                                       cfg.num_classes, rng)
        out[n] = ClientData(tokens=tokens, labels=labels.astype(np.int32),
                            poisoned=n in poisoned_clients)
    return out


def make_test_set(cfg: SyntheticTaskConfig, n: int, seed: int = 99):
    rng = np.random.default_rng(seed)
    class_p = make_task(cfg)
    labels = rng.integers(0, cfg.num_classes, size=n)
    tokens = sample_examples(cfg, class_p, labels, rng)
    return tokens, labels.astype(np.int32)
