"""Optimizers over dict/list trees of tensors: AdamW and global-norm
clipping (the rest of the JAX package's ``repro/optim`` comes with the
federation slice, ROADMAP.md queue 1)."""
from repro_torch.optim.optimizers import (AdamW, Optimizer,  # noqa: F401
                                          clip_by_global_norm, global_norm)
