"""Population-scale client registry (the counterpart of the JAX package's
``repro/population``).

The federation machinery (:mod:`repro_torch.federation`,
:mod:`repro_torch.runtime`) operates on a fixed set of
``FedConfig.n_clients`` *slots*: topology, splits, engine buckets, edge
groups, channels and the trust ledger are all slot-indexed.  This package
decouples the *registered population* from those slots:

- :class:`~repro_torch.population.registry.ClientRegistry` holds every
  registered client's durable state (LoRA adapter delta, trust /
  staleness EMAs, cluster + edge assignment, availability cursor,
  data-seed, batch-stream cursor) in preallocated numpy columns on the
  host, so 10^5–10^6 clients cost megabytes;
- :class:`~repro_torch.population.sampler.CohortSampler` materializes
  each round's active cohort as a gather of registry rows into the slots
  and writes round outcomes back via scatter, so per-round cost scales
  with the cohort size, not the population size;
- :class:`~repro_torch.population.runtime.PopulationRuntime` binds the
  two to a live :class:`~repro_torch.federation.simulation.Federation`:
  it swaps per-round client identity under the slots (data, batch
  streams, FedAvg weights, trust, SS-OP channels) while the engine and
  its kernels run unchanged.

``Federation.run(..., population=PopulationConfig(registered=N))`` (and
the sync/deadline/async runtime schedulers) activate it; with
``registered == n_clients`` the binding is bit-inert — the identity
cohort draws no RNG and the history matches the run without it exactly.
"""
from repro_torch.population.registry import ClientRegistry
from repro_torch.population.sampler import (AvailabilityCursors,
                                            CohortSampler, PopulationConfig)
from repro_torch.population.runtime import PopulationRuntime

__all__ = ["ClientRegistry", "CohortSampler", "AvailabilityCursors",
           "PopulationConfig", "PopulationRuntime"]
