"""The paper's Table I comparators in the port against the reference:
Power-of-Choice and Oort on the same draws, FedAvgM's server momentum, the
theory closed forms, and the five selectors' histories on the quickstart
federation.

Draws: each reference selector splits the key it is given —
Power-of-Choice's candidates from ``gumbel(split(key)[0])`` and its jitter
from ``uniform(split(key)[1], 0, 1e-6)``, Oort's explore slots from
``gumbel(split(key)[1])`` — and the port takes those rows by name. Masks
are compared exactly, probabilities to 1e-6.
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
from repro.core import scoring as jscoring
from repro.core import selection as jselection
from repro.core import state as jstate
from repro.core import theory as jtheory
from repro.data import make_vision_data as jax_make_vision_data
from repro.fed import engine as jengine
from repro.fed import run_federated as jax_run_federated
from repro.fed import server as jserver
from repro.models import build_model as jax_build_model
from repro_torch.configs.base import FedConfig
from repro_torch.configs.registry import get_config, smoke_variant
from repro_torch.convert import params_from_jax
from repro_torch.core import scoring, selection, state, theory
from repro_torch.data import make_vision_data
from repro_torch.examples.paper_reproduction import METHODS, run_methods
from repro_torch.fed import engine, server
from repro_torch.models import build_model

K = 40


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def states(k, seed, rounds):
    """The same ClientState in both packages after ``rounds`` random rounds
    of observations (``rounds = 0``: fresh, nothing observed)."""
    rng = np.random.default_rng(seed)
    js = rng.uniform(0, 0.69, k).astype(np.float32)
    sj = jstate.init_client_state(k, jnp.asarray(js))
    st = state.init_client_state(k, js, device="cpu")
    for t in range(rounds):
        mask = rng.uniform(size=k) > 0.6
        loss = rng.uniform(0.1, 4, k).astype(np.float32)
        sq = rng.uniform(0, 2, k).astype(np.float32)
        sj = jstate.update_client_state(
            sj, round_idx=jnp.int32(t), selected_mask=jnp.asarray(mask),
            observed_loss=jnp.asarray(loss), observed_sqnorm=jnp.asarray(sq))
        st = state.update_client_state(
            st, round_idx=t, selected_mask=torch.from_numpy(mask),
            observed_loss=torch.from_numpy(loss), observed_sqnorm=torch.from_numpy(sq))
    return sj, st


def poc_draws(key, k):
    kc, kt = jax.random.split(key)
    return {"gumbel": torch.from_numpy(np.array(jax.random.gumbel(kc, (k,), jnp.float32))),
            "jitter": torch.from_numpy(np.array(
                jax.random.uniform(kt, (k,), jnp.float32, 0.0, 1e-6)))}


def oort_draws(key, k):
    _, ke = jax.random.split(key)
    return {"gumbel": torch.from_numpy(np.array(jax.random.gumbel(ke, (k,), jnp.float32)))}


DRAWS = {"power_of_choice": poc_draws, "oort": oort_draws}


def reference_round_draws(selector, seed, k, rounds):
    """Each round's draws as the reference engine hands its selector the
    key: ``key, sk = split(key)`` per round (``fed/engine.py:1211``)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(rounds):
        key, sk = jax.random.split(key)
        if selector in DRAWS:
            out.append(DRAWS[selector](sk, k))
        else:
            out.append(torch.from_numpy(np.array(jax.random.gumbel(sk, (k,), jnp.float32))))
    return out


def assert_same_selection(got, want):
    mask, probs = got
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(probs.numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rounds,t", [(0, 0), (3, 3), (6, 9)], ids=["round0", "mid", "late"])
@pytest.mark.parametrize("d", [0, 5], ids=["d=2m", "d=5"])
def test_power_of_choice_matches_reference(rounds, t, d):
    sj, st = states(K, seed=rounds + d, rounds=rounds)
    cfg = selection.SelectorConfig(num_selected=4, poc_candidates=d)
    jcfg = jselection.SelectorConfig(num_selected=4, poc_candidates=d)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = jselection.power_of_choice_select(key, sj, jnp.int32(t), sel_cfg=jcfg)
        got = selection.make_selector("power_of_choice", cfg)(poc_draws(key, K), st, t)
        assert_same_selection(got, want)
        assert int(got[0].sum()) == 4


def _speeds(k):
    return np.random.default_rng(7).uniform(0.3, 1.6, k).astype(np.float32)


@pytest.mark.parametrize("case", ["round0", "mid", "speeds", "override", "all-explored"])
def test_oort_matches_reference(case):
    rounds = {"round0": 0, "all-explored": 20}.get(case, 3)
    sj, st = states(K, seed=11, rounds=rounds)
    if case == "all-explored":
        assert bool((st.has_loss > 0).all())
    kw_j, kw_t = {}, {}
    if case == "speeds":
        kw_j["speeds"] = jnp.asarray(_speeds(K))
        kw_t["speeds"] = torch.from_numpy(_speeds(K))
    cfg = selection.SelectorConfig(num_selected=10, oort_explore_frac=0.3)
    jcfg = jselection.SelectorConfig(num_selected=10, oort_explore_frac=0.3)
    for seed in range(4):
        key = jax.random.PRNGKey(100 + seed)
        t = rounds + seed
        if case == "override":
            stale = np.random.default_rng(seed).uniform(-1, 150, K).astype(np.float32)
            want = jselection.oort_select(key, sj, jnp.int32(t), sel_cfg=jcfg,
                                          staleness_override=jnp.asarray(stale))
            got = selection.oort_select(oort_draws(key, K), st, t, sel_cfg=cfg,
                                        staleness_override=torch.from_numpy(stale))
        else:
            want = jselection.make_selector("oort", jcfg, **kw_j)(key, sj, jnp.int32(t))
            got = selection.make_selector("oort", cfg, **kw_t)(oort_draws(key, K), st, t)
        assert_same_selection(got, want)
        assert int(got[0].sum()) == 10


def test_named_draws_contract():
    """A selector that takes named rows says so; a bare row is the Gumbel
    row; the engine's default draws give each selector what it takes."""
    assert selection.selector_draws("power_of_choice") == ("gumbel", "jitter")
    assert selection.selector_draws("heterosel_pallas") == ("gumbel",)
    _, st = states(12, seed=0, rounds=0)
    cfg = selection.SelectorConfig(num_selected=3)
    with pytest.raises(ValueError, match="jitter"):
        selection.make_selector("power_of_choice", cfg)(torch.zeros(12), st, 0)
    gen = torch.Generator().manual_seed(0)
    row = selection.draw(gen, ("gumbel",), 12)
    assert torch.equal(row, selection.gumbel_noise(torch.Generator().manual_seed(0), 12))
    named = selection.draw(gen, ("gumbel", "jitter"), 12)
    assert set(named) == {"gumbel", "jitter"}
    assert bool((named["jitter"] >= 0).all()) and bool((named["jitter"] < 1e-6).all())
    assert selection.make_selector("oort", cfg)(row, st, 0)[0].sum() == 3
    with pytest.raises(ValueError, match="oort"):
        selection.make_selector("nope", cfg)


def test_server_momentum_matches_reference():
    rng = np.random.default_rng(3)
    shapes = {"w": (5, 7), "b": (7,), "h": (3, 4)}
    prev = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    prev["h"] = prev["h"].astype(jnp.bfloat16)
    mj, mt = jserver.ServerMomentum(beta=0.9), server.ServerMomentum(beta=0.9)
    gj = {k: jnp.asarray(v) for k, v in prev.items()}
    gt = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.bfloat16 if k == "h" else torch.float32) for k, v in prev.items()}
    for _ in range(3):
        avg = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        gj = mj.apply(gj, {k: jnp.asarray(v) for k, v in avg.items()})
        gt = mt.apply(gt, {k: torch.from_numpy(v) for k, v in avg.items()})
        for k in shapes:
            assert gt[k].dtype == (torch.bfloat16 if k == "h" else torch.float32)
            np.testing.assert_allclose(gt[k].float().numpy(),
                                       np.asarray(gj[k], np.float32), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(mt.velocity[k].numpy(), np.asarray(mj.velocity[k]),
                                       rtol=1e-6, atol=1e-6)
    # FedAvgM is the aggregator over the cohort's mean.
    agg_j, agg_t = jengine.FedAvgM(), engine.FedAvgM()
    assert agg_t.name == "fedavgm" and "fedavgm" in engine.AGGREGATORS
    stack = {k: rng.normal(size=(3, *s)).astype(np.float32) for k, s in shapes.items()}
    glob = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    for _ in range(3):
        cj = jengine.CohortUpdates(mean_loss=None, update_sqnorm=None,
                                   avg_params=jserver.fedavg_fused(
                                       {k: jnp.asarray(v) for k, v in stack.items()}))
        ct = engine.CohortUpdates(mean_loss=None, update_sqnorm=None,
                                  avg_params=server.fedavg_fused(
                                      {k: torch.from_numpy(v) for k, v in stack.items()}))
        out_j = agg_j.reduce({k: jnp.asarray(v) for k, v in glob.items()}, cj)
        out_t = agg_t.reduce({k: torch.from_numpy(v) for k, v in glob.items()}, ct)
        for k in shapes:
            np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                       rtol=1e-6, atol=1e-6)
        glob = {k: out_t[k].numpy() for k in shapes}
        stack = {k: v + 0.1 for k, v in stack.items()}


def test_theory_matches_reference():
    rng = np.random.default_rng(5)
    scfg, jscfg = scoring.HeteRoScoreConfig(), jscoring.HeteRoScoreConfig()
    assert scoring.score_bounds(scfg) == pytest.approx(jscoring.score_bounds(jscfg), abs=1e-7)
    stale = rng.integers(0, 40, 16).astype(np.int32)
    for t, m in ((0, 6), (50, 3), (400, 12)):
        got = theory.exploration_lower_bound(torch.from_numpy(stale), t,
                                             selection.SelectorConfig(num_selected=m), scfg)
        want = jtheory.exploration_lower_bound(jnp.asarray(stale), jnp.int32(t),
                                               jselection.SelectorConfig(num_selected=m),
                                               jscfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    args = (4, 0.05, 0.1, 2.5, 0.7)
    assert theory.fedprox_drift_bound(*args) == pytest.approx(
        jtheory.fedprox_drift_bound(*args), rel=1e-12)
    assert theory.optimal_mu(4, 0.05, 2.5, 0.7, 3.0) == pytest.approx(
        jtheory.optimal_mu(4, 0.05, 2.5, 0.7, 3.0), rel=1e-12)
    grads = rng.normal(size=(12, 30)).astype(np.float32)
    mask = rng.uniform(size=12) > 0.5
    np.testing.assert_allclose(
        float(theory.effective_heterogeneity(torch.from_numpy(grads), torch.from_numpy(mask))),
        float(jtheory.effective_heterogeneity(jnp.asarray(grads), jnp.asarray(mask))),
        rtol=1e-6)
    np.testing.assert_allclose(float(theory.population_heterogeneity(torch.from_numpy(grads))),
                               float(jtheory.population_heterogeneity(jnp.asarray(grads))),
                               rtol=1e-6)
    scores = rng.normal(size=20).astype(np.float32)
    np.testing.assert_allclose(float(theory.softmax_cv(torch.from_numpy(scores), 0.7)),
                               float(jtheory.softmax_cv(jnp.asarray(scores), 0.7)), rtol=1e-6)


# ---------------------------------------------------------------------------
# The five selectors on the quickstart federation (tests/test_torch_slice.py)
# ---------------------------------------------------------------------------

ROUNDS = 3
STEPS = 1
FED_KW = dict(num_clients=12, participation=0.5, rounds=ROUNDS, local_epochs=2,
              local_batch=16, lr=0.3, mu=0.1, dirichlet_alpha=0.1, seed=0)
DATA_KW = dict(train_per_class=48, test_per_class=16, noise=0.3)


def test_paper_selectors_match_reference_on_the_quickstart():
    """Each of the five selectors gives the reference's selection history
    over 3 rounds, on the reference's draws and initial weights; train loss
    within max(1e-3 relative, the reference's own batched-vs-sequential
    spread) (ROADMAP queue 3 (c)); accuracy within one eval sample. One
    local step per round, as the hierarchical parity test takes: the
    reference's f32 GroupNorm gradient of the d_model 8 net is up to 3 %
    off its f64 value (queue 3 (d)), and at lr 0.3 four steps a round carry
    that past the reference's own spread within two rounds for a cohort
    such as Oort's."""
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
    draws = {name: reference_round_draws(name, fed.seed, fed.num_clients, ROUNDS)
             for name in METHODS}
    got = run_methods(model, fed, data, device="cpu", steps_per_round=STEPS,
                      noise=lambda name: (lambda t, k: draws[name][t]), init_params=params)
    n_test = len(data.test_labels)
    for name in METHODS:
        ref = jax_run_federated(jmodel, jfed, jdata, selector=name, steps_per_round=STEPS,
                                client_execution="batched")
        spread = np.abs(ref.train_loss - jax_run_federated(
            jmodel, jfed, jdata, selector=name, steps_per_round=STEPS,
            client_execution="sequential").train_loss)
        res = got[name]
        np.testing.assert_array_equal(res.selected_history,
                                      np.asarray(ref.selected_history), err_msg=name)
        np.testing.assert_allclose(res.accuracy, ref.accuracy, atol=2.0 / n_test,
                                   err_msg=name)
        tol = np.maximum(1e-3 * np.abs(ref.train_loss), spread)
        assert np.all(np.abs(res.train_loss - ref.train_loss) <= tol), (
            name, res.train_loss, ref.train_loss, tol)
        assert res.labeled_summary().keys() == ref.labeled_summary().keys()


# ---------------------------------------------------------------------------
# The engines with the new selectors, aggregator and eval hook (port only)
# ---------------------------------------------------------------------------


def _small_run(**kw):
    from repro_torch.fed import run_federated

    fed = FedConfig(**dict(FED_KW, rounds=2), **kw.pop("fed_kw", {}))
    model = build_model(dataclasses.replace(
        smoke_variant(get_config("resnet18-cifar10")), d_model=8))
    data = make_vision_data(fed, **DATA_KW)
    return run_federated(model, fed, data, steps_per_round=1, device="cpu", **kw)


@pytest.mark.parametrize("selector", ["power_of_choice", "oort"])
def test_one_edge_hierarchy_is_the_flat_run(selector):
    """With E = 1 and every edge dispatched, the hierarchical engine hands
    the flat run's named draws to the selector: the same run bitwise. With
    an outer stage it refuses the selector, as the reference does."""
    from repro_torch.fed import HierarchyConfig

    flat = _small_run(selector=selector)
    hier = _small_run(selector=selector, fed_kw=dict(topology="hierarchical", edge_count=1))
    np.testing.assert_array_equal(hier.selected_history, flat.selected_history)
    for k, p in flat.params.items():
        assert torch.equal(hier.params[k], p), k
    with pytest.raises(ValueError, match="no edge-level analogue"):
        _small_run(selector=selector, fed_kw=dict(topology="hierarchical", edge_count=3),
                   hier_cfg=HierarchyConfig(edges_per_round=2))


def test_fedavgm_and_eval_fn_in_the_engine():
    """``aggregator='fedavgm'`` applies server momentum over the round means
    (its first round is FedAvg's bitwise: v_1 = w_0 − w̄_1); ``eval_fn``
    replaces the eval and names its metric 'metric'."""
    avg = _small_run(selector="random")
    mom = _small_run(selector="random", aggregator="fedavgm",
                     eval_fn=lambda model, params, batch: 0.25)
    np.testing.assert_array_equal(mom.selected_history, avg.selected_history)
    assert mom.metric_name == "metric" and list(mom.accuracy) == [0.25, 0.25]
    assert "peak_metric" in mom.labeled_summary()
    assert any(not torch.equal(mom.params[k], avg.params[k]) for k in avg.params)
