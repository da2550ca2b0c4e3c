"""Availability traces through whole smoke federations against the JAX
reference (the traces, masked selectors and budget controllers themselves
are in ``test_torch_availability.py``, whose module docstring gives the
draws and tolerances): sync flat under a trace, and hierarchical under a
trace (per-edge masked selectors, the segmented ``heterosel_pallas``
re-sample) and under ``adaptive``'s budget controller."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.fed import FederatedSpec as JaxSpec
from repro.fed import HierarchyConfig as JaxHierCfg
from repro_torch.fed import FederatedSpec, HierarchyConfig, edge_budgets, partition_edges

from test_torch_async import BudgetLog, JaxBudgetLog, hier_draws, reference_draws
from test_torch_slice import jax_compile_cache  # noqa: F401  (autouse fixture)
from test_torch_availability import (ROUNDS, STEPS, one_torch_thread, setups, trace)  # noqa: F401


HIER_CASES = {"hierarchical": ("heterosel", 3, 2, True),
              "pallas": ("heterosel_pallas", 3, 2, True),
              "adaptive": ("adaptive", 4, 0, False)}


@pytest.fixture(scope="module")
def reference(setups):
    """Reference runs by case, each run once per module, the hierarchical
    ones with their per-round budgets."""
    jfed, jmodel, jdata = setups[0]
    runs = {}

    def run(case):
        if case not in runs:
            hooks = [JaxBudgetLog()]
            if case == "flat":
                spec = JaxSpec(jmodel, jfed, jdata, selector="heterosel",
                               steps_per_round=STEPS, availability=trace())
            else:
                selector, edges, per_round, avail = HIER_CASES[case]
                hfed = dataclasses.replace(jfed, topology="hierarchical", edge_count=edges)
                spec = JaxSpec(jmodel, hfed, jdata, selector=selector,
                               steps_per_round=STEPS, hooks=hooks,
                               hier_cfg=JaxHierCfg(edges_per_round=per_round),
                               availability=trace() if avail else None)
            runs[case] = (spec.build().run(), hooks[0].budgets)
        return runs[case]

    return run


def assert_matches(res, ref, data):
    np.testing.assert_array_equal(res.selected_history, np.asarray(ref.selected_history))
    n_test = len(data.test_labels)
    np.testing.assert_allclose(res.accuracy, ref.accuracy, atol=2.0 / n_test)
    np.testing.assert_allclose(res.train_loss, ref.train_loss, rtol=1e-3)


def test_sync_flat_with_availability_matches_reference(setups, reference):
    _, (fed, model, data), params = setups
    ref, _ = reference("flat")
    noise = reference_draws("heterosel", fed.seed, fed.num_clients, ROUNDS, remask=True)
    res = FederatedSpec(model, fed, data, selector="heterosel", steps_per_round=STEPS,
                        availability=trace(), device="cpu", init_params=params,
                        noise=lambda t, k: noise[t]).build().run()
    assert_matches(res, ref, data)
    assert not (res.selected_history & ~trace()).any()


@pytest.mark.parametrize("case", list(HIER_CASES))
def test_sync_hierarchical_matches_reference(setups, reference, case):
    """Availability through the inner stage (E = 3, outer stage on), by the
    per-edge masked selectors or by the segmented ``heterosel_pallas``
    stage's re-sample of K4's probabilities, or the ``adaptive`` selector's
    budget controller (E = 4): histories and the per-round budgets equal
    the reference's."""
    _, (fed, model, data), params = setups
    selector, edges, per_round, avail = HIER_CASES[case]
    ref, ref_budgets = reference(case)
    hfed = dataclasses.replace(fed, topology="hierarchical", edge_count=edges)
    sizes = partition_edges(data.label_js, edges).sizes
    draws = hier_draws(fed.seed, ROUNDS, sizes, outer=0 < per_round < edges, remask=avail,
                       jit_inner=selector != "heterosel_pallas")
    log = BudgetLog()
    res = FederatedSpec(model, hfed, data, selector=selector, steps_per_round=STEPS,
                        device="cpu", init_params=params,
                        hier_cfg=HierarchyConfig(edges_per_round=per_round),
                        availability=trace() if avail else None,
                        edge_noise=lambda t, s, n: draws[t, s], hooks=[log]).build().run()
    assert_matches(res, ref, data)
    np.testing.assert_array_equal(np.stack(log.budgets), np.stack(ref_budgets))
    if avail:
        assert not (res.selected_history & ~trace()).any()
    else:
        static = edge_budgets(fed.num_selected, sizes)
        assert any(not np.array_equal(b, static) for b in log.budgets), log.budgets
        assert all(b.sum() <= fed.num_selected for b in log.budgets)
