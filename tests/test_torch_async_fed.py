"""The asynchronous slice's smoke federations against the JAX reference
(the clock, latencies, FedBuff, the async selectors and the engine's
refusals are in ``test_torch_async.py``, whose module docstring gives
the draws, the hostile async profile and the tolerances): the flat async
run and the hierarchical async runs (``heterosel`` with the outer
stage's over-selection, ``adaptive`` with its budgets)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.fed import AsyncConfig as JaxAsyncConfig
from repro.fed import FederatedSpec as JaxSpec
from repro.fed import HierarchyConfig as JaxHierCfg
from repro_torch.fed import (AsyncConfig, AsyncFederatedEngine, FederatedSpec,
                             HierarchyConfig, edge_budgets, partition_edges)

from test_torch_slice import jax_compile_cache  # noqa: F401  (autouse fixture)
from test_torch_async import (ACFG_KW, BudgetLog, JaxBudgetLog, MULT, ROUNDS, STEPS,
                              hier_draws, one_torch_thread, reference_draws, setups)  # noqa: F401


@pytest.fixture(scope="module")
def reference_async(setups):
    """The reference's smoke async run, once per module."""
    jfed, jmodel, jdata = setups[0]
    return JaxSpec(jmodel, dataclasses.replace(jfed, round_policy="async"), jdata,
                   selector="heterosel", steps_per_round=STEPS, system=MULT,
                   async_cfg=JaxAsyncConfig(**ACFG_KW)).build().run()


def test_async_federation_matches_reference(setups, reference_async):
    _, (fed, model, data), params = setups
    ref = reference_async
    noise = reference_draws("heterosel", fed.seed, fed.num_clients, ROUNDS)
    engine = FederatedSpec(model, dataclasses.replace(fed, round_policy="async"), data,
                           selector="heterosel", steps_per_round=STEPS, system=MULT,
                           async_cfg=AsyncConfig(**ACFG_KW), device="cpu",
                           init_params=params, noise=lambda t, k: noise[t]).build()
    assert isinstance(engine, AsyncFederatedEngine) and engine.m_over == 5
    res = engine.run()
    np.testing.assert_array_equal(res.selected_history, np.asarray(ref.selected_history))
    np.testing.assert_array_equal(res.wall_clock, np.asarray(ref.wall_clock))
    np.testing.assert_array_equal(res.round_staleness, np.asarray(ref.round_staleness))
    assert engine.stragglers_carried > 0  # the profile carries updates over
    n_test = len(data.test_labels)
    np.testing.assert_allclose(res.accuracy, ref.accuracy, atol=2.0 / n_test)
    np.testing.assert_allclose(res.train_loss, ref.train_loss, rtol=1e-3)


HIER_ASYNC = {"heterosel": ("heterosel", 3, 1), "adaptive": ("adaptive", 2, 0)}


SERIES = ("cloud_uploads", "wall_clock", "round_staleness")


@pytest.fixture(scope="module")
def reference_hier_async(setups):
    """The reference's hierarchical async runs by case, each once per
    module: (result, per-round budgets, stragglers carried, dropped)."""
    jfed, jmodel, jdata = setups[0]
    runs = {}

    def run(case):
        if case not in runs:
            selector, edges, per_round = HIER_ASYNC[case]
            log = JaxBudgetLog()
            engine = JaxSpec(jmodel, dataclasses.replace(
                jfed, round_policy="async", topology="hierarchical", edge_count=edges),
                jdata, selector=selector, steps_per_round=STEPS, system=MULT,
                async_cfg=JaxAsyncConfig(**ACFG_KW), hooks=[log],
                hier_cfg=JaxHierCfg(edges_per_round=per_round)).build()
            res = engine.run()
            runs[case] = (res, log.budgets, engine.stragglers_carried, engine.updates_dropped)
        return runs[case]

    return run


@pytest.mark.parametrize("case", list(HIER_ASYNC))
def test_hierarchical_async_matches_reference(setups, reference_hier_async, case):
    """Edge over-selection, each edge's latency as its cohort's max, FedBuff
    over the edge deltas, and (under 'adaptive') the budgets retuned from
    the arrivals: the dispatch history, the upload, clock and staleness
    series, the straggler counts and the per-round budgets equal the
    reference's."""
    _, (fed, model, data), params = setups
    selector, edges, per_round = HIER_ASYNC[case]
    ref, ref_budgets, ref_carried, ref_dropped = reference_hier_async(case)
    sizes = partition_edges(data.label_js, edges).sizes
    draws = hier_draws(fed.seed, ROUNDS, sizes, outer=per_round > 0, remask=False)
    streams = set()

    def edge_noise(t, stream, n):
        streams.add(stream)
        return draws[t, stream]

    log = BudgetLog()
    engine = FederatedSpec(
        model, dataclasses.replace(fed, round_policy="async", topology="hierarchical",
                                   edge_count=edges),
        data, selector=selector, steps_per_round=STEPS, system=MULT,
        async_cfg=AsyncConfig(**ACFG_KW), hier_cfg=HierarchyConfig(edges_per_round=per_round),
        device="cpu", init_params=params, edge_noise=edge_noise, hooks=[log]).build()
    res = engine.run()
    np.testing.assert_array_equal(res.selected_history, np.asarray(ref.selected_history))
    for name in SERIES:
        np.testing.assert_array_equal(getattr(res, name), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(np.stack(log.budgets), np.stack(ref_budgets))
    assert (engine.stragglers_carried, engine.updates_dropped) == (ref_carried, ref_dropped)
    assert engine.stragglers_carried > 0  # straggler edges carry over
    if per_round:
        assert edges in streams  # the outer stage drew
    else:
        static = edge_budgets(fed.num_selected, sizes)
        assert any(not np.array_equal(b, static) for b in log.budgets), log.budgets
    n_test = len(data.test_labels)
    np.testing.assert_allclose(res.accuracy, ref.accuracy, atol=2.0 / n_test)
    np.testing.assert_allclose(res.train_loss, ref.train_loss, rtol=1e-3)
