"""The ELSA federation harness: :class:`Federation` and :class:`FedConfig`
(sequential ``backend="reference"``), the edge topology and the engine's
helpers."""
from repro_torch.federation.simulation import FedConfig, Federation  # noqa: F401
