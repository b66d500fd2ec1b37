"""Optimizers over dict/list trees of tensors: AdamW, SGD, FedProx,
FedAdam/FedAMS server optimizers, global-norm clipping, LR schedules and
per-group learning rates (the JAX package's ``repro/optim``)."""
from repro_torch.optim.optimizers import (AdamW, SGD, FedAdam, FedProx,  # noqa: F401
                                          FedAMS, Optimizer,
                                          clip_by_global_norm,
                                          fedprox_gradient, global_norm)
from repro_torch.optim.schedules import (adapter_head_lr_tree,  # noqa: F401
                                         constant, cosine_decay,
                                         warmup_cosine)
