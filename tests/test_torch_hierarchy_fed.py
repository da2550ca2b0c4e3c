"""The hierarchical slice's whole runs against the JAX reference (E = 3,
3 rounds; the partition, budgets, pooled state, the E = 1 contract and the
refusals are in ``test_torch_hierarchy.py``, whose module docstring gives
the draws and tolerances), and the f64 account of why those runs take one
local step."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.fed import FederatedSpec as JaxSpec
from repro.fed import HierarchyConfig as JaxHierCfg
from repro_torch.convert import params_from_jax
from repro_torch.fed import HierarchyConfig, partition_edges, run_federated
from repro_torch.kernels import score_select as tss

from test_torch_slice import jax_compile_cache  # noqa: F401  (autouse fixture)
from test_torch_hierarchy import (EDGES, ROUNDS, STEPS, one_torch_thread,
                                  reference_edge_draws, setups)  # noqa: F401


@pytest.fixture(scope="module")
def reference(setups):
    """Reference hierarchical runs at E = 3, each run once per module."""
    jfed, jmodel, jdata = setups[0]
    hfed = dataclasses.replace(jfed, topology="hierarchical", edge_count=EDGES)
    runs = {}

    def run(selector, edges_per_round=0):
        k = (selector, edges_per_round)
        if k not in runs:
            runs[k] = JaxSpec(jmodel, hfed, jdata, selector=selector,
                              steps_per_round=STEPS, executor="batched",
                              hier_cfg=JaxHierCfg(edges_per_round=edges_per_round),
                              ).build().run()
        return runs[k]

    return run


@pytest.mark.parametrize("selector,edges_per_round", [
    ("heterosel", 0), ("heterosel_pallas", 0), ("heterosel", 2)])
def test_hierarchical_slice_matches_reference(setups, reference, selector,
                                              edges_per_round):
    _, (fed, model, data), params = setups
    hfed = dataclasses.replace(fed, topology="hierarchical", edge_count=EDGES)
    sizes = partition_edges(data.label_js, EDGES).sizes
    draws = reference_edge_draws(fed.seed, ROUNDS, sizes, outer=edges_per_round > 0,
                                 jit_inner=selector == "heterosel")
    tss.reset_launches()
    res = run_federated(model, hfed, data, selector=selector, steps_per_round=STEPS,
                        client_execution="batched", device="cpu", init_params=params,
                        hier_cfg=HierarchyConfig(edges_per_round=edges_per_round),
                        edge_noise=lambda t, s, n: torch.from_numpy(draws[t, s]))
    ref = reference(selector, edges_per_round=edges_per_round)
    np.testing.assert_array_equal(res.selected_history,
                                  np.asarray(ref.selected_history))
    np.testing.assert_array_equal(res.cloud_uploads, np.asarray(ref.cloud_uploads))
    want_uploads = edges_per_round or EDGES
    np.testing.assert_array_equal(res.cloud_uploads, np.full(ROUNDS, want_uploads))
    n_test = len(data.test_labels)
    np.testing.assert_allclose(res.accuracy, ref.accuracy, atol=2.0 / n_test)
    tol = 1e-3 * np.abs(ref.train_loss)
    assert np.all(np.abs(res.train_loss - ref.train_loss) <= tol), (
        res.train_loss, ref.train_loss, tol)
    for p in res.params.values():
        assert torch.isfinite(p).all()
    # On the CPU the segmented path runs K4's plain version: no launches.
    assert sum(tss.LAUNCHES.values()) == 0


def test_first_step_gradients_match_reference_in_f64(setups, monkeypatch):
    """Why the whole runs above take one local step, measured on one batch
    at equal params. In f32 the early-block gradients of this d_model = 8
    net differ from the reference's by up to 3 %. In f64 (every f32 cast of
    both models redirected to f64) the two backward passes agree to 1e-12,
    and the port's f32 gradients lie within 1e-5 of that f64 gradient. The
    reference's f32 gradients land there too once its GroupNorms alone run
    in f64: the gap is the reference's f32 GroupNorm on the CPU, not the
    port, and four steps at lr = 0.3 amplify it past the tolerance."""
    import repro.models.resnet as jax_resnet

    (_, jmodel, jdata), (_, model, data), params = setups
    jparams = jmodel.init_params(jax.random.PRNGKey(1))
    jb = {k: v[0] for k, v in jdata.client_batches(0, 1, 16,
                                                   np.random.default_rng(0)).items()}
    tb = {k: v[0] for k, v in data.client_batches(0, 1, 16,
                                                  np.random.default_rng(0)).items()}

    def ref_grads(dt):
        p = jax.tree.map(lambda x: jnp.asarray(x, dt), jparams)
        g = jax.jit(jax.grad(jmodel.loss))(p, {"images": jnp.asarray(jb["images"], dt),
                                               "labels": jnp.asarray(jb["labels"])})
        return {k: torch.from_numpy(np.array(v, np.float64))
                for k, v in params_from_jax(g).items()}

    def port_grads(dt):
        g = torch.func.grad(model.loss)(
            {k: v.to(dt) for k, v in params.items()},
            {"images": torch.as_tensor(np.asarray(tb["images"])).to(dt),
             "labels": torch.as_tensor(np.asarray(tb["labels"]))})
        return {k: v.double() for k, v in g.items()}

    def worst(got, want):
        return max(float((got[k] - want[k]).abs().max() / want[k].abs().max())
                   for k in want)

    port32, ref32 = port_grads(torch.float32), ref_grads(jnp.float32)
    gn32 = jax_resnet.group_norm
    with jax.enable_x64(True):
        with monkeypatch.context() as m:
            m.setattr(jnp, "float32", jnp.float64)
            m.setattr(torch, "float32", torch.float64)
            port64, ref64 = port_grads(torch.float64), ref_grads(jnp.float64)

        def gn64(x, w, b, groups=8, eps=1e-5):
            with monkeypatch.context() as m:
                m.setattr(jnp, "float32", jnp.float64)
                return gn32(x.astype(jnp.float64), w, b, groups, eps).astype(x.dtype)

        monkeypatch.setattr(jax_resnet, "group_norm", gn64)
        ref32_gn64 = ref_grads(jnp.float32)
    assert worst(port64, ref64) < 1e-12
    assert worst(port32, ref64) < 1e-5
    assert worst(ref32_gn64, ref64) < 1e-5
    assert worst(ref32, ref64) > 1e-2  # the gap this test explains
