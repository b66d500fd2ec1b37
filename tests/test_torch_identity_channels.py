"""Identity-keyed SS-OP channels and trust attribution in the port, the
counterparts of ``tests/test_identity_channels.py``, held against the JAX
package where it computes the same thing.

The privacy rotation and the trust EMA must follow the registered
*identity*, never the federation slot it happens to execute in:

1. a client's rotation is invariant under arbitrary slot assignments (a
   seeded sweep, and a hypothesis sweep where hypothesis is installed),
   and equals the JAX package's ``V_n`` bit for bit over the port's
   shared basis;
2. two identities streaming through one slot get distinct rotations; a
   returning identity gets its original channel bit-exactly after LRU
   eviction; the cache's hits, misses and evictions reach telemetry;
3. a verdict for an update that completes after a cohort swap lands on
   the pinned dispatch-time identity (the deadline ``screen_cohort`` path
   and the async per-arrival path, and whole scheduler runs).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.ssop import client_seed as jax_client_seed
from repro.core.ssop import random_orthogonal as jax_random_orthogonal
from repro.population import PopulationConfig as JaxPopulationConfig
from repro.population.sampler import CohortSampler as JaxSampler
from repro.population.registry import ClientRegistry as JaxRegistry
from repro_torch import telemetry as tm
from repro_torch.core.ssop import client_seed
from repro_torch.federation import FedConfig, Federation
from repro_torch.population import PopulationConfig, PopulationRuntime
from repro_torch.runtime import RuntimeConfig

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:       # no hypothesis here: the seeded sweep only
    HAVE_HYPOTHESIS = False

CHAN = dict(n_clients=4, n_edges=2, alpha=5.0, poisoned=(),
            total_examples=200, probe_q=8, local_warmup_steps=1,
            layers=4, t_rounds=1, batch_size=8, seed=0, seq_len=16,
            num_classes=4, use_channel=True)
REGISTERED = 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch ops on one CPU thread (see
    ``tests/test_torch_federation.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _telemetry_off():
    tm.disable()
    yield
    tm.disable()


@pytest.fixture(scope="module")
def fed():
    return Federation(FedConfig(**CHAN), device="cpu")


def _pop(fed, **kw):
    kw.setdefault("registered", REGISTERED)
    pop = PopulationRuntime(fed, PopulationConfig(**kw))
    fed._bind_population(pop)
    return pop


def _install(pop, assignment):
    """Arbitrary cohort schedule: put ``assignment[s]`` in slot ``s``."""
    pop.slot_to_id = np.asarray(assignment, np.int64)
    pop._id_to_slot = {int(c): s for s, c in enumerate(assignment)}


def _jax_v(fed, cid):
    return np.asarray(jax_random_orthogonal(
        fed.fed.ssop_r, jax_client_seed("elsa-salt", int(cid))))


def _assert_rotation_is_identity_keyed(fed, pop, assignment):
    ref_u = fed._reference_basis()
    _install(pop, assignment)
    for slot, cid in enumerate(assignment):
        ch = fed.channel_for(slot, None)
        np.testing.assert_array_equal(ch.ssop.v.numpy(), _jax_v(fed, cid))
        assert torch.equal(ch.ssop.u, ref_u)
        assert ch.plan is fed.plan


def test_rotation_invariant_under_slot_assignment_seeded_sweep(fed):
    pop = _pop(fed)
    rng = np.random.default_rng(7)
    for _ in range(25):
        assignment = rng.choice(REGISTERED, size=CHAN["n_clients"],
                                replace=False)
        _assert_rotation_is_identity_keyed(fed, pop, assignment)
    assert client_seed("elsa-salt", 19) == jax_client_seed("elsa-salt", 19)


if HAVE_HYPOTHESIS:
    @settings(max_examples=30, deadline=None)
    @given(st.lists(st.integers(0, REGISTERED - 1),
                    min_size=CHAN["n_clients"],
                    max_size=CHAN["n_clients"], unique=True))
    def test_rotation_invariant_under_slot_assignment_hypothesis(
            fed, assignment):
        _assert_rotation_is_identity_keyed(fed, _pop(fed), assignment)


def test_identities_sharing_a_slot_get_distinct_rotations(fed):
    pop = _pop(fed)
    _install(pop, [3, 1, 2, 0])
    round0 = fed.channel_for(0, None)
    _install(pop, [19, 1, 2, 0])          # slot 0 swaps 3 -> 19
    round1 = fed.channel_for(0, None)
    assert not torch.equal(round0.ssop.v, round1.ssop.v)
    assert torch.equal(round0.ssop.u, round1.ssop.u)
    np.testing.assert_array_equal(round0.ssop.v.numpy(), _jax_v(fed, 3))
    np.testing.assert_array_equal(round1.ssop.v.numpy(), _jax_v(fed, 19))


def test_returning_identity_rotation_bit_exact_after_eviction(fed):
    pop = _pop(fed, channel_cache=4)
    first = pop.channel_for_id(20)
    want = (first.ssop.u.clone(), first.ssop.v.clone())
    for cid in (5, 6, 7, 8, 9):           # cap 4: 20 falls off the LRU
        pop.channel_for_id(cid)
    assert 20 not in pop._channels
    again = pop.channel_for_id(20)
    assert again is not first             # regenerated, not cached
    assert torch.equal(again.ssop.u, want[0])
    assert torch.equal(again.ssop.v, want[1])


def test_channels_off_give_the_empty_channel():
    fed = Federation(FedConfig(**dict(CHAN, use_channel=False)),
                     device="cpu")
    pop = _pop(fed)
    ch = pop.channel_for_id(7)
    assert ch.ssop is None and ch.plan is None and not pop._channels
    fed_nossop = Federation(FedConfig(**dict(CHAN, use_ssop=False)),
                            device="cpu")
    ch = _pop(fed_nossop).channel_for_id(7)
    assert ch.ssop is None and ch.plan is fed_nossop.plan


def test_channel_cache_telemetry_gauges(fed):
    with tm.session() as tel:
        pop = _pop(fed, channel_cache=4)
        for cid in (0, 1, 2, 3, 0, 9):    # 5 misses, 1 hit, 1 eviction
            pop.channel_for_id(cid)
        pop._round_ids = pop.slot_to_id
        pop.end_round(0)
    assert tel.gauge("population.channel_cache_size") == 4
    assert tel.gauge("population.channel_cache_hits") == 1
    assert tel.gauge("population.channel_cache_misses") == 5
    assert tel.gauge("population.channel_cache_evictions") == 1
    assert list(pop._channels) == [2, 3, 0, 9]


# ---------------------------------------------------------------------------
# straggler trust attribution
# ---------------------------------------------------------------------------

def _swap_out(pop, straggler, start=1):
    """Advance the (deterministic) cohort schedule until the straggler
    is out of the cohort entirely; returns the new slot-0 occupant."""
    r = start
    while straggler in {int(c) for c in pop.slot_to_id}:
        pop.begin_round(r)
        r += 1
    return int(pop.slot_to_id[0])


def _screened_pop(seed=2):
    fed = Federation(FedConfig(**CHAN, screen=True), device="cpu")
    pop = _pop(fed, seed=seed)
    pop.begin_round(0)
    # the JAX sampler draws the same cohort for round 0
    jax_ids = JaxSampler(JaxRegistry(REGISTERED), JaxPopulationConfig(
        registered=REGISTERED, seed=seed)).sample(0, CHAN["n_clients"])
    np.testing.assert_array_equal(pop.slot_to_id, jax_ids)
    return fed, pop


def test_straggler_verdict_lands_on_pinned_identity_deadline_path():
    """The deadline write-back path: ``screen_cohort`` on a sender slot
    resolves the verdict to the pinned dispatch-time identity."""
    fed, pop = _screened_pop()
    straggler = pop.pin(0)                # dispatched from round 0's cohort
    newcomer = _swap_out(pop, straggler)  # cohort swapped mid-flight
    assert newcomer != straggler and pop.pinned(0) == straggler
    kept, _ = fed.screen_cohort([0], [fed.lora0], [1.0], fed.lora0)
    assert len(kept) == 1                 # zero-delta update passes
    reg = pop.registry
    assert reg.screen_passes[straggler] == 1
    assert reg.screen_passes[newcomer] == 0
    assert reg.screen_fails[newcomer] == 0
    assert fed.screen_log[-1].clients == [straggler]


def test_straggler_verdict_lands_on_pinned_identity_async_path():
    """The async per-arrival path: ``record_trust(pinned_id, ok)`` hits
    the straggler's registry row, not the slot ledger of the new
    occupant."""
    fed, pop = _screened_pop()
    straggler = pop.pin(0)
    newcomer = _swap_out(pop, straggler)
    assert newcomer != straggler
    pop.record_trust(pop.pinned(0), False)   # nonfinite arrival, say
    reg = pop.registry
    beta = fed.trust_ledger.beta
    assert reg.screen_fails[straggler] == 1
    np.testing.assert_allclose(reg.trust[straggler], beta * 1.0)
    assert reg.trust[newcomer] == 1.0
    assert reg.screen_fails[newcomer] == 0
    assert fed.trust_ledger.scores[0] == 1.0


def test_in_cohort_verdict_mirrors_ledger_and_registry():
    fed, pop = _screened_pop()
    cid = int(pop.slot_to_id[2])
    pop.record_trust(cid, False)
    assert pop.registry.trust[cid] == fed.trust_ledger.scores[2]
    assert pop.registry.trust[cid] < 1.0
    assert pop.registry.screen_fails[cid] == 1
    assert pop.trust_weight(cid) == pop.ledger_view.weight(cid) \
        == fed.trust_ledger.scores[2]
    assert pop.ledger_view.scores is pop.registry.trust
    assert pop.ledger_view.beta == fed.trust_ledger.beta


@pytest.mark.parametrize("policy", ["deadline", "async"])
def test_scheduler_verdicts_attributed_to_dispatched_ids(policy):
    """Every identity carrying a screening verdict after a deadline or
    async run was dispatched (pinned) at some point, and the async path
    counts its verdicts in telemetry."""
    fed = Federation(FedConfig(**CHAN, screen=True), device="cpu")
    pop = _pop(fed, registered=16, seed=1)
    pins = []
    orig_pin = pop.pin
    pop.pin = lambda slot: (pins.append(orig_pin(slot)), pins[-1])[1]
    with tm.session() as tel:
        h = fed.run("fedavg", global_rounds=2, steps_per_round=2,
                    runtime=RuntimeConfig(policy=policy), population=pop)
    assert np.isfinite(h["loss"]).all()
    reg = pop.registry
    judged = reg.screen_passes + reg.screen_fails
    assert judged.sum() > 0
    assert set(np.flatnonzero(judged)) <= set(pins)
    assert set(pins) - set(range(CHAN["n_clients"]))   # newcomers trained
    counts = tel.counters_by_name("screening.verdicts")
    assert sum(counts.values()) == judged.sum()
    for leaf in jax.tree_util.tree_leaves(fed.last_theta):
        assert torch.isfinite(leaf).all()
