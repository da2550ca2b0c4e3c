"""The scenario layer, the lazy and drifting data, and the ``filtered``
selectors of the port against the JAX reference, and the port's
``production_features`` example on the CPU.

Data are numpy in both packages, so lazy and drifting federations, their
batches and the host stream after them are bitwise equal; so are the
scenarios' availability masks and speed profiles. The ``filtered:<base>``
selectors (every base in ``FILTER_BASES``, sync and async) are held to the
reference over a six-round selection history on the same draws: the base's
row, and the pool re-sample's ``gumbel(fold_in(key, 1))``, which the port
takes as the ``"pool"`` draw; masks equal, probabilities within 1e-6. The
engine path of both (``filtered`` under the ``drift`` scenario, its lazy
data through the batched executor's stacked path and its drift hook) is
the reference federation ``test_torch_obs.py`` holds the port to.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import FedConfig as JaxFedConfig
from repro.core import selection as jselection
from repro.core import state as jstate
from repro.data import synthetic as jsynth
from repro.fed import scenarios as jscen
from repro_torch.configs.base import FedConfig
from repro_torch.configs.registry import get_config, smoke_variant
from repro_torch.core import selection, state
from repro_torch.data import synthetic as tsynth
from repro_torch.fed import (AsyncConfig, FederatedSpec, HierarchyConfig, LabelDriftHook,
                             make_scenario, scenarios)
from repro_torch.models import build_model
from test_torch_slice import jax_compile_cache  # noqa: F401  (autouse fixture)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8), k)


# ---------------------------------------------------------------------------
# Lazy and drifting data
# ---------------------------------------------------------------------------


def test_lazy_vision_data_matches_reference_bitwise():
    fed = FedConfig(num_clients=64, dirichlet_alpha=0.1, seed=3)
    jfed = JaxFedConfig(num_clients=64, dirichlet_alpha=0.1, seed=3)
    kw = dict(image_size=16, test_per_class=4, noise=0.5)
    a, b = jsynth.make_lazy_vision_data(jfed, **kw), tsynth.make_lazy_vision_data(fed, **kw)
    for f in ("templates", "label_dists", "label_js", "test_images", "test_labels"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x.view(np.uint8), y.view(np.uint8)), f
    assert b.num_clients == 64 and b.noise == a.noise
    assert_batches_equal(b.eval_batch(), a.eval_batch())
    rj, rt = np.random.default_rng(7), np.random.default_rng(7)
    assert_batches_equal(b.client_batches(5, 2, 4, rt), a.client_batches(5, 2, 4, rj))
    sel = np.asarray([0, 9, 33, 63])
    assert_batches_equal(b.stacked_client_batches(sel, 2, 3, rt),
                         a.stacked_client_batches(sel, 2, 3, rj))
    assert rt.bit_generator.state == rj.bit_generator.state


def test_drifting_data_matches_reference_bitwise():
    fed = FedConfig(num_clients=12, dirichlet_alpha=0.1, seed=1)
    jfed = JaxFedConfig(num_clients=12, dirichlet_alpha=0.1, seed=1)
    kw = dict(drift_period=4, drift_shift=3, image_size=8, test_per_class=2)
    a, b = jsynth.make_drifting_vision_data(jfed, **kw), tsynth.make_drifting_vision_data(
        fed, **kw)
    assert isinstance(b, tsynth.LazyVisionFedData)
    np.testing.assert_array_equal(b.label_js, a.label_js)
    rj, rt = np.random.default_rng(0), np.random.default_rng(0)
    for t in (0, 3, 4, 9, 17):
        a.set_round(t)
        b.set_round(t)
        assert b.current_shift() == a.current_shift()
        np.testing.assert_array_equal(b.current_label_dists(), a.current_label_dists())
        assert_batches_equal(b.stacked_client_batches(np.arange(12), 1, 4, rt),
                             a.stacked_client_batches(np.arange(12), 1, 4, rj))
    assert b.current_shift() == (17 // 4 * 3) % 10
    with pytest.raises(ValueError, match="drift_period"):
        tsynth.make_drifting_vision_data(fed, drift_period=0)


# ---------------------------------------------------------------------------
# Scenarios
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(jscen.SCENARIOS))
def test_scenarios_match_reference_bitwise(name):
    assert scenarios.SCENARIOS == jscen.SCENARIOS
    fed = FedConfig(num_clients=10, rounds=7, dirichlet_alpha=0.1, seed=2)
    jfed = JaxFedConfig(num_clients=10, rounds=7, dirichlet_alpha=0.1, seed=2)
    over = dict(seed=4, drift_period=2)
    a = jscen.make_scenario(name, **over).build(jfed, data_kwargs=dict(image_size=8))
    b = make_scenario(name, **over).build(fed, data_kwargs=dict(image_size=8))
    assert b.config.needs_clock == a.config.needs_clock == (name == "stragglers")
    assert sorted(b.spec_kwargs()) == sorted(a.spec_kwargs())
    if a.availability is not None:
        np.testing.assert_array_equal(b.availability, a.availability)
        assert b.availability.shape == (7, 10)
    if a.system is not None:
        np.testing.assert_array_equal(b.system.speeds(), a.system.speeds())
    assert [type(h).__name__ for h in b.hooks] == [type(h).__name__ for h in a.hooks]
    if name == "drift":
        np.testing.assert_array_equal(b.data.label_dists, a.data.label_dists)
        np.testing.assert_array_equal(b.data.test_images, a.data.test_images)
        assert (b.data.drift_period, b.data.drift_shift) == (2, 3)
        hook = b.hooks[0]
        assert hook.priority == 5 and hook.data is b.data
    else:
        assert b.data is None and a.data is None


def test_scenario_refusals():
    with pytest.raises(ValueError, match="unknown scenario"):
        make_scenario("meteor")
    fed = FedConfig(num_clients=4)
    plain = tsynth.make_vision_data(fed, train_per_class=2, test_per_class=1, image_size=8)
    with pytest.raises(ValueError, match="drift-capable"):
        make_scenario("drift").build(fed, data=plain)
    with pytest.raises(TypeError, match="set_round"):
        LabelDriftHook(plain)
    assert make_scenario("churn").build(fed, data=plain).data is plain


# ---------------------------------------------------------------------------
# The filtered selectors
# ---------------------------------------------------------------------------

K, M = 40, 6


def gumbel_row(key, k):
    return torch.from_numpy(np.array(jax.random.gumbel(key, (k,), jnp.float32)))


def filtered_draws(key, k):
    """The port's draws for the reference's ``filtered`` selector on ``key``:
    a row for the base (whose cohort is discarded) and the pool re-sample's
    ``gumbel(fold_in(key, 1))``."""
    return {"gumbel": gumbel_row(key, k), "pool": gumbel_row(jax.random.fold_in(key, 1), k)}


@pytest.mark.parametrize("flavour", ["sync", "async"])
@pytest.mark.parametrize("base", list(selection.FILTER_BASES))
def test_filtered_selector_history_matches_reference(base, flavour):
    """Six rounds: each round's cohort from both packages on the same draws,
    then the same observations for it folded into both states, so each round
    selects on the state the earlier cohorts made."""
    assert selection.FILTER_BASES == jselection.FILTER_BASES
    name = f"filtered:{base}"
    cfg = selection.SelectorConfig(num_selected=M)
    jcfg = jselection.SelectorConfig(num_selected=M)
    speeds = np.random.default_rng(5).uniform(0.3, 1.6, K).astype(np.float32)
    kw_t, kw_j = ({"speeds": torch.from_numpy(speeds)}, {"speeds": jnp.asarray(speeds)}) \
        if base == "oort" else ({}, {})
    if flavour == "sync":
        fj = jselection.make_selector(name, jcfg, **kw_j)
        ft = selection.make_selector(name, cfg, **kw_t)
    else:
        fj = jselection.make_async_selector(name, jcfg, **kw_j)
        ft = selection.make_async_selector(name, cfg, **kw_t)
    rng = np.random.default_rng(11)
    js = rng.uniform(0, 0.69, K).astype(np.float32)
    sj = jstate.init_client_state(K, jnp.asarray(js))
    st = state.init_client_state(K, js, device="cpu")
    key = jax.random.PRNGKey(3)
    history = []
    for t in range(6):
        key, sk = jax.random.split(key)
        draws = filtered_draws(sk, K)
        if flavour == "sync":
            mj, pj = fj(sk, sj, jnp.int32(t))
            mt, pt = ft(draws, st, t)
        else:
            stale = rng.uniform(-1, 12, K).astype(np.float32)
            mj, pj = fj(sk, sj, jnp.int32(t), jnp.asarray(stale))
            mt, pt = ft(draws, st, t, torch.from_numpy(stale))
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj), f"round {t}")
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6, atol=1e-6)
        assert int(mt.sum()) == M
        pool = selection.filter_pool(st, cfg)
        assert not (mt & ~pool).any()  # the cohort never leaves the pool
        np.testing.assert_array_equal(pool.numpy(), np.asarray(jselection.filter_pool(sj, jcfg)))
        mask = mt.numpy()
        loss = rng.uniform(0.1, 4, K).astype(np.float32)
        sq = rng.uniform(0, 2, K).astype(np.float32)
        sj = jstate.update_client_state(sj, round_idx=jnp.int32(t),
                                        selected_mask=jnp.asarray(mask),
                                        observed_loss=jnp.asarray(loss),
                                        observed_sqnorm=jnp.asarray(sq))
        st = state.update_client_state(st, round_idx=t, selected_mask=torch.from_numpy(mask),
                                       observed_loss=torch.from_numpy(loss),
                                       observed_sqnorm=torch.from_numpy(sq))
        history.append(mask)
    assert len({tuple(h) for h in history}) > 1


def test_filter_helpers_and_refusals():
    for name in ("filtered", "filtered:oort", "oort", "heterosel"):
        assert selection.base_selector_name(name) == jselection.base_selector_name(name)
    for k, frac, m in ((40, 0.5, 6), (10, 0.1, 6), (12, 1.0, 3), (7, 0.3, 7)):
        cfg = selection.SelectorConfig(num_selected=m, filter_keep_frac=frac)
        jcfg = jselection.SelectorConfig(num_selected=m, filter_keep_frac=frac)
        assert selection.filter_pool_size(k, cfg) == jselection.filter_pool_size(k, jcfg)
    assert selection.selector_draws("filtered:random") == ("gumbel", "pool")
    assert "filtered" in selection.SELECTORS
    for bad in ("filtered:power_of_choice", "filtered:heterosel_pallas", "filtered:nope"):
        with pytest.raises(ValueError, match="cannot wrap"):
            selection.make_selector(bad, selection.SelectorConfig())
    with pytest.raises(ValueError, match="filtered:<base>"):
        selection.make_selector("nope", selection.SelectorConfig())


# ---------------------------------------------------------------------------
# Engines: port-only compositions
# ---------------------------------------------------------------------------

ROUNDS = 2
FED_KW = dict(num_clients=6, participation=0.5, rounds=ROUNDS, local_epochs=1,
              local_batch=8, lr=0.05, mu=0.1, dirichlet_alpha=0.1, seed=0)
DRIFT = dict(drift_period=1, seed=0)
DATA = dict(image_size=8, test_per_class=8)


def smoke_model():
    return build_model(dataclasses.replace(
        smoke_variant(get_config("resnet18-cifar10")), d_model=8, image_size=8))


@pytest.mark.parametrize("cell", ["async-stragglers", "hierarchical-churn"])
def test_scenarios_compose_with_the_engines(cell):
    """A scenario's pieces in the other engines, with a filtered selector:
    the churn trace keeps offline clients out, the stragglers' profile
    drives the async clock."""
    fed = FedConfig(**FED_KW)
    data = tsynth.make_lazy_vision_data(fed, **DATA)
    kw = dict(selector="filtered:random", steps_per_round=1, device="cpu")
    if cell == "async-stragglers":
        fed = dataclasses.replace(fed, round_policy="async")
        built = make_scenario("stragglers").build(fed, data=data)
        kw["async_cfg"] = AsyncConfig(deadline=1.0)
    else:
        fed = dataclasses.replace(fed, topology="hierarchical", edge_count=2)
        built = make_scenario("churn", seed=1).build(fed, data=data)
        kw["hier_cfg"] = HierarchyConfig()
    res = FederatedSpec(smoke_model(), fed, built.data, **kw,
                        **built.spec_kwargs()).build().run()
    assert res.selected_history.shape == (ROUNDS, fed.num_clients)
    if built.availability is not None:
        assert not (res.selected_history & ~built.availability).any()
    else:
        assert res.wall_clock is not None and np.all(np.diff(res.wall_clock) >= 0)


def test_production_features_example_runs_on_cpu(capsys):
    from repro_torch.examples import production_features

    results = production_features.main(["--rounds", "1", "--steps", "1", "--device", "cpu"])
    assert list(results) == ["baseline", "int8 (batched)", "topk10%+EF (seq)",
                             "churn+adaptive-mu", "fedavgm"]
    assert results["int8 (batched)"].wire_bytes > 0
    assert results["churn+adaptive-mu"].mu_history is not None
    out = capsys.readouterr().out
    assert "wire-compression" in out and "fedavgm" in out
