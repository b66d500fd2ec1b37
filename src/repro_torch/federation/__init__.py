"""The ELSA federation harness: :class:`Federation` and :class:`FedConfig`
(``backend="batched"``, the default, and the sequential
``backend="reference"``), the batched engine and the edge topology."""
from repro_torch.federation.simulation import FedConfig, Federation  # noqa: F401
