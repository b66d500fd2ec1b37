"""Public probe set (ELSA §III.B.1 Step 1).

The cloud distributes Q *public* inputs to all clients as a common
behavioral reference.  Offline we sample label-free sequences from the
mixture of all class distributions (a stand-in for GLUE/TREC/SQuAD dev
samples); privacy is preserved since the probes carry no client data.

The JAX package's ``repro/data/probe.py``, copied (numpy only, bit-equal).
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import SyntheticTaskConfig, make_task


def make_probe_set(cfg: SyntheticTaskConfig, q: int, seed: int = 1234
                   ) -> np.ndarray:
    """(Q, S) int32 probe token sequences."""
    rng = np.random.default_rng(seed)
    class_p = make_task(cfg)
    mix = class_p.mean(0)
    out = np.empty((q, cfg.seq_len), np.int32)
    for i in range(q):
        out[i] = rng.choice(cfg.vocab_size, size=cfg.seq_len, p=mix)
    return out
