"""Availability masks and adaptive budgets in the port against the JAX
reference: ``mask_selector`` / ``mask_async_selector`` with the re-sample's
draw replayed, ``AdaptiveBudgets`` / ``AdaptiveMu`` on the same
observations; the sync flat and hierarchical federations under an
availability trace and the hierarchical ``adaptive`` selector's budget
series are in ``test_torch_availability_fed.py`` (same draws and
tolerances).

Draws: the reference's masked selector draws its inner Gumbel row from the
round key ``sk`` and the re-sample's from ``fold_in(sk, 1)``; the port takes
them as the named rows ``gumbel`` and ``remask``. A hierarchical round
splits ``sk`` into one key per edge (edge e's rows from ``split(sk, E)[e]``
and ``fold_in`` of it), and the outer stage draws ``gumbel(fold_in(sk, E),
(E,))``. The reference's per-edge selectors draw under ``jax.jit`` and its
segmented ``heterosel_pallas`` stage draws eagerly; the rows are drawn the
same way here (``test_torch_async.hier_draws``). The reference's Pallas
kernel runs in interpret mode. Host data comes from the same
``np.random.default_rng(seed)`` in both packages.

Tolerances: masks, histories and budgets equal; probabilities 1e-6; the
controllers (numpy in both packages) exactly; accuracy within 2/N_test and
train loss within rtol 1e-3. The federations (K = 12, 4 rounds, lr 0.05)
take one local step, as ``test_torch_hierarchy.py`` does and for its reason
(queue 3 (d)): the reference's f32 GroupNorm gradient on the CPU is up to
3 % off in the early blocks, and at two steps the flat run's round-3 train
loss drifted 2.8e-3 relative from the reference's while every cohort still
agreed. Measured at one step: gaps of at most 8.6e-5 relative.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import FedConfig as JaxFedConfig
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_variant as jax_smoke_variant
from repro.core import adaptive as jadaptive
from repro.core import selection as jselection
from repro.data import make_vision_data as jax_make_vision_data
from repro.fed import availability as javail
from repro.models import build_model as jax_build_model
from repro_torch.configs.base import FedConfig
from repro_torch.configs.registry import get_config, smoke_variant
from repro_torch.convert import params_from_jax
from repro_torch.core import adaptive, selection
from repro_torch.data import make_vision_data
from repro_torch.fed import AvailabilityTrace, SystemProfile, availability
from repro_torch.models import build_model

from test_torch_async import round_draws
from test_torch_selectors import states
from test_torch_slice import jax_compile_cache  # noqa: F401  (autouse fixture)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ROUNDS = 4
EDGES = 3
FED_KW = dict(num_clients=12, participation=0.5, rounds=ROUNDS, local_epochs=1,
              local_batch=8, lr=0.05, mu=0.1, dirichlet_alpha=0.1, seed=0)
DATA_KW = dict(train_per_class=24, test_per_class=8, noise=0.3)
STEPS = 1


def trace():
    return AvailabilityTrace(12, p_stay_online=0.7, p_come_online=0.5, seed=4).masks(ROUNDS)


def test_trace_and_profile_match_reference():
    for cls, jcls, kw in ((AvailabilityTrace, javail.AvailabilityTrace,
                           dict(p_stay_online=0.3, p_come_online=0.2)),
                          (AvailabilityTrace, javail.AvailabilityTrace, {})):
        np.testing.assert_array_equal(cls(20, seed=5, **kw).masks(30),
                                      jcls(20, seed=5, **kw).masks(30))
    ours, ref = SystemProfile(16, sigma=0.7, seed=2), javail.SystemProfile(16, sigma=0.7, seed=2)
    np.testing.assert_array_equal(ours.speeds(), ref.speeds())
    mask = np.arange(16) % 3 == 0
    assert ours.round_time(mask) == ref.round_time(mask)


# ---------------------------------------------------------------------------
# The masked selectors
# ---------------------------------------------------------------------------

MASKED = ["heterosel", "heterosel_pallas", "power_of_choice", "oort", "random", "adaptive"]


@pytest.mark.parametrize("name", MASKED)
@pytest.mark.parametrize("flavour", ["sync", "async"])
def test_masked_selector_matches_reference(name, flavour):
    k, m, rounds = 40, 8, 3
    sj, st = states(k, seed=2, rounds=3)
    avail = np.random.default_rng(9).uniform(size=(rounds, k)) < 0.6
    avail[2, :] = False
    avail[2, :5] = True                   # fewer online than m: a short round
    stale = np.random.default_rng(1).uniform(0, 5, k).astype(np.float32)
    jcfg, cfg = jselection.SelectorConfig(num_selected=m), selection.SelectorConfig(num_selected=m)
    if flavour == "sync":
        fj = javail.mask_selector(jselection.make_selector(name, jcfg), jnp.asarray(avail), m)
        ft = availability.mask_selector(selection.make_selector(name, cfg), avail, m)
        extra_j, extra_t = (), ()
    else:
        fj = javail.mask_async_selector(jselection.make_async_selector(name, jcfg),
                                        jnp.asarray(avail), m)
        ft = availability.mask_async_selector(selection.make_async_selector(name, cfg),
                                              avail, m)
        extra_j, extra_t = (jnp.asarray(stale),), (torch.from_numpy(stale),)
    for t in range(rounds):
        key = jax.random.PRNGKey(10 + t)
        mask_j, probs_j = fj(key, sj, jnp.int32(t), *extra_j)
        mask_t, probs_t = ft(round_draws(name, key, k, remask=True), st, t, *extra_t)
        np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
        np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j), rtol=1e-6,
                                   atol=1e-7)
        assert not (mask_t.numpy() & ~avail[t]).any()
    assert int(mask_t.sum()) <= 5


def test_masked_selector_needs_the_remask_draw():
    _, st = states(12, seed=0, rounds=1)
    f = availability.mask_selector(selection.make_selector("heterosel",
                                                           selection.SelectorConfig(4)),
                                   np.ones((1, 12), bool), 4)
    with pytest.raises(ValueError, match="remask"):
        f(torch.zeros(12), st, 0)


# ---------------------------------------------------------------------------
# The controllers (numpy in both packages)
# ---------------------------------------------------------------------------


def test_apportion_matches_reference():
    rng = np.random.default_rng(0)
    for _ in range(50):
        e = int(rng.integers(1, 8))
        caps = rng.integers(0, 6, e)
        w = rng.uniform(0, 3, e) * (rng.uniform(size=e) > 0.2)
        total = int(rng.integers(0, 20))
        np.testing.assert_array_equal(adaptive.apportion(total, w, caps),
                                      jadaptive.apportion(total, w, caps))


def test_adaptive_budgets_match_reference():
    sizes = np.asarray([4, 5, 3, 6])
    ours, ref = adaptive.AdaptiveBudgets(7, sizes), jadaptive.AdaptiveBudgets(7, sizes)
    np.testing.assert_array_equal(ours.budgets(), ref.budgets())
    rng = np.random.default_rng(3)
    for _ in range(12):
        util = rng.uniform(0.1, 3.0, 4)
        util[rng.uniform(size=4) < 0.3] = np.nan
        np.testing.assert_array_equal(ours.observe_round(util), ref.observe_round(util))
        np.testing.assert_array_equal(ours.utilities, ref.utilities)
    back = adaptive.AdaptiveBudgets(7, sizes)
    back.load_state_dict(ours.state_dict())
    np.testing.assert_array_equal(back.budgets(), ours.budgets())


def test_adaptive_mu_matches_reference():
    ours = adaptive.AdaptiveMu(local_steps=4, local_lr=0.05)
    ref = jadaptive.AdaptiveMu(local_steps=4, local_lr=0.05)
    rng = np.random.default_rng(8)
    for r in range(15):
        sq = rng.uniform(0, 2, 6) * (rng.uniform(size=6) > 0.2)
        assert ours.observe_round(sq, 15 - r) == ref.observe_round(sq, 15 - r)
    assert (ours._g_sq, ours._b_sq, ours._dist_sq) == (ref._g_sq, ref._b_sq, ref._dist_sq)


# ---------------------------------------------------------------------------
# Federations
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setups():
    jfed = JaxFedConfig(**FED_KW)
    jmodel = jax_build_model(dataclasses.replace(
        jax_smoke_variant(jax_get_config("resnet18-cifar10")), d_model=8))
    jdata = jax_make_vision_data(jfed, **DATA_KW)
    fed = FedConfig(**FED_KW)
    model = build_model(dataclasses.replace(
        smoke_variant(get_config("resnet18-cifar10")), d_model=8))
    data = make_vision_data(fed, **DATA_KW)
    params = params_from_jax(jax.tree.map(
        np.array, jmodel.init_params(jax.random.PRNGKey(fed.seed + 1))))
    return (jfed, jmodel, jdata), (fed, model, data), params


# Hierarchical cases: (selector, E, edges per round, availability trace).
