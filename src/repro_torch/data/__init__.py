"""Synthetic non-IID client data, the public probe set and the batch
pipeline (numpy only; bit-equal to the JAX package's ``repro/data``)."""
from repro_torch.data.synthetic import (SyntheticTaskConfig, make_task,  # noqa: F401
                                        dirichlet_partition, quantity_skew,
                                        poison_labels, ClientData)
from repro_torch.data.probe import make_probe_set  # noqa: F401
from repro_torch.data.pipeline import batch_iterator  # noqa: F401
