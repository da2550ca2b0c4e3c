"""The hierarchical slice of the port (client → edge → cloud, sync rounds)
against the JAX reference's ``repro.fed.hierarchy``.

Pieces: the edge partition and budgets (numpy, bitwise), the pooled edge
state and the outer stage's probabilities (1e-6), the E = 1 contract (the
port's hierarchical run equals its own flat run bitwise), and the whole
slice against a live reference run of ``test_hierarchy.quickstart_setup``
at E = 3 and 3 rounds.

The reference's draws are handed to the port through ``edge_noise``: each
round splits ``key, sk``; the outer stage draws ``gumbel(fold_in(sk, E),
(E,))`` eagerly, and edge e draws ``gumbel(split(sk, E)[e], (|edge e|,))``
— inside ``jax.jit`` on the ``heterosel`` path, eagerly on the
``heterosel_pallas`` path, each drawn here the same way (jit can change the
last bits). Tolerances are those of ``test_torch_slice.py``: selection
history and ``cloud_uploads`` equal, accuracy within 2/N_test, train loss
within rtol 1e-3 (that file also admits the reference's own
batched-vs-sequential spread where it is larger; this one does not need
to, see below).

Each round takes one local step, as the reference's own segmented-vs-jnp
hierarchy test does. At four steps the lr = 0.3 trajectory of one client
outgrows the tolerance: on the first step, with equal params and batch,
the loss and the output layer's gradient agree to 1e-7, but gradients of
the early blocks of this d_model = 8 net differ by up to 3 %, and three
more steps at lr = 0.3 bring the round-1 train loss 1.2e-3 apart.
``test_first_step_gradients_match_reference_in_f64`` pins the cause: the
reference's f32 GroupNorm gradient on the CPU, while the port's f32
gradient lies within 1e-5 of the f64 one that both packages agree on.
Measured at one step: the train-loss gap is at most 7.5e-5 relative
(``heterosel``, ``heterosel_pallas``) and 2.3e-4 (outer stage on).

The module runs torch on one intra-op thread (restored afterwards): the
suite runs six pytest workers on the machine's cores, and per-client
training's many small ops slow down by an order of magnitude when every
worker's torch spins eight threads.
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
from repro.core.scoring import HeteRoScoreConfig as JaxScoreCfg
from repro.core.selection import SelectorConfig as JaxSelCfg
from repro.core.selection import edge_selection_probs as jax_edge_probs
from repro.core.state import ClientState as JaxState
from repro.core.state import pool_client_state as jax_pool
from repro.data import make_vision_data as jax_make_vision_data
from repro.fed import FederatedSpec as JaxSpec
from repro.fed import HierarchyConfig as JaxHierCfg
from repro.fed import edge_budgets as jax_edge_budgets
from repro.fed.partition import partition_edges as jax_partition_edges
from repro.models import build_model as jax_build_model
from repro_torch.configs.base import FedConfig
from repro_torch.configs.registry import get_config, smoke_variant
from repro_torch.convert import params_from_jax
from repro_torch.core.scoring import HeteRoScoreConfig
from repro_torch.core.selection import SelectorConfig, edge_selection_probs
from repro_torch.core.state import ClientState, NEVER, pool_client_state
from repro_torch.data import make_vision_data
from repro_torch.fed import (FederatedSpec, HierarchyConfig, edge_budgets,
                             partition_edges, run_federated)
from repro_torch.kernels import score_select as tss
from repro_torch.models import build_model
from test_torch_slice import jax_compile_cache  # noqa: F401  (autouse fixture)

ROUNDS = 3
EDGES = 3
FED_KW = dict(num_clients=12, participation=0.5, rounds=ROUNDS, local_epochs=2,
              local_batch=16, lr=0.3, mu=0.1, dirichlet_alpha=0.1, seed=0)
DATA_KW = dict(train_per_class=48, test_per_class=16, noise=0.3)
STEPS = 1


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# Partition, budgets, pooled state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["similarity", "random"])
@pytest.mark.parametrize("k,e", [(12, 1), (12, 3), (12, 5), (40, 7)])
def test_partition_and_budgets_match_reference_bitwise(mode, k, e):
    js = np.random.default_rng(k + e).random(k)
    js[::4] = js[1]  # ties: the stable argsort must order them alike
    mine, ref = partition_edges(js, e, mode=mode, seed=3), \
        jax_partition_edges(js, e, mode=mode, seed=3)
    np.testing.assert_array_equal(mine.assignment, ref.assignment)
    assert mine.assignment.dtype == ref.assignment.dtype
    np.testing.assert_array_equal(mine.sizes, ref.sizes)
    for a, b in zip(mine.member_lists(), ref.member_lists()):
        np.testing.assert_array_equal(a, b)
    for m in (1, 6, k // 2 + 1, k):
        for budget in (0, 2):
            np.testing.assert_array_equal(edge_budgets(m, mine.sizes, budget),
                                          jax_edge_budgets(m, ref.sizes, budget))


@pytest.mark.parametrize("m,sizes", [(6, [4, 4, 4]), (6, [1, 5, 6]), (5, [3, 3]),
                                     (12, [4, 4, 4]), (512, [32] * 32), (7, [2, 6, 3])])
def test_edge_budgets_match_reference(m, sizes):
    got = edge_budgets(m, np.asarray(sizes))
    np.testing.assert_array_equal(got, jax_edge_budgets(m, np.asarray(sizes)))
    assert got.sum() == min(m, sum(sizes)) and np.all(got <= np.asarray(sizes))


def mid_run_state(k: int, seed: int):
    """A mid-run state as numpy fields (never-selected clients included)."""
    rng = np.random.default_rng(seed)
    has_loss = rng.uniform(size=k) > 0.3
    has_mom = has_loss & (rng.uniform(size=k) > 0.5)
    return dict(
        loss_prev=np.where(has_loss, rng.uniform(0.1, 4.0, k), 0.0).astype(np.float32),
        loss_prev2=np.where(has_mom, rng.uniform(0.1, 4.0, k), 0.0).astype(np.float32),
        label_js=rng.uniform(0.0, 0.69, k).astype(np.float32),
        part_count=np.where(has_loss, rng.integers(1, 6, k), 0).astype(np.int32),
        last_selected=np.where(has_loss, rng.integers(0, 9, k), NEVER).astype(np.int32),
        update_sqnorm=np.where(has_loss, rng.uniform(0.0, 2.0, k), 0.0).astype(np.float32),
        has_loss=has_loss.astype(np.float32),
        has_momentum=has_mom.astype(np.float32),
    )


@pytest.mark.parametrize("k,e", [(12, 3), (40, 7)])
def test_pooled_state_and_edge_probs_match_reference(k, e):
    fields = mid_run_state(k, seed=k)
    assignment = jax_partition_edges(fields["label_js"], e).assignment
    ref = jax_pool(JaxState(**{n: jnp.asarray(v) for n, v in fields.items()}),
                   jnp.asarray(assignment), e)
    mine = pool_client_state(ClientState(**{n: torch.from_numpy(v)
                                            for n, v in fields.items()}),
                             torch.from_numpy(assignment), e)
    for name in fields:
        got, want = getattr(mine, name), np.asarray(getattr(ref, name))
        assert got.shape == (e,)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    assert mine.last_selected.dtype == torch.int32
    for t, additive in ((0, True), (9, True), (9, False)):
        p_ref = jax_edge_probs(ref, jnp.int32(t), JaxSelCfg(additive=additive),
                               JaxScoreCfg())
        p_mine = edge_selection_probs(mine, t, SelectorConfig(additive=additive),
                                      HeteRoScoreConfig())
        np.testing.assert_allclose(p_mine.numpy(), np.asarray(p_ref),
                                   rtol=1e-6, atol=1e-6)


def test_cloud_stage_and_weighted_mean_match_reference():
    """``params_delta_f32`` + ``apply_weighted_deltas`` (the cloud stage) and
    the weighted ``fedavg_fused`` equal the reference's cloud stage and
    ``fedavg_weighted`` on the same f32 inputs, and
    ``WeightedFedAvg.cohort_weights`` gives the reference's weights."""
    from repro.fed import server as jsrv
    from repro.fed.engine import WeightedFedAvg as JaxWeighted
    from repro_torch.fed import WeightedFedAvg, stack_client_trees
    from repro_torch.fed import server as tsrv

    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,)}
    anchor = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    edges = [{k: (anchor[k] + 0.1 * rng.normal(size=s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    w = np.array([3.0, 2.0, 4.0], np.float32)
    tt = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    ref = jsrv.apply_weighted_deltas(
        anchor, [jsrv.params_delta_f32(e, anchor) for e in edges], jnp.asarray(w))
    got = tsrv.apply_weighted_deltas(
        tt(anchor), [tsrv.params_delta_f32(tt(e), tt(anchor)) for e in edges],
        torch.from_numpy(w))
    ref_w = jsrv.fedavg_weighted(edges, w)
    got_w = tsrv.fedavg_fused(stack_client_trees([tt(e) for e in edges]),
                              torch.from_numpy(w))
    for k in shapes:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
        np.testing.assert_allclose(got_w[k].numpy(), np.asarray(ref_w[k]),
                                   rtol=1e-6, atol=1e-7)

    class Data:
        num_clients = 4
        client_indices = [np.arange(n) for n in (5, 9, 2, 7)]

    sel = np.array([0, 2, 3])
    np.testing.assert_array_equal(
        WeightedFedAvg().cohort_weights(sel, Data()).numpy(),
        np.asarray(JaxWeighted().cohort_weights(sel, Data())))


# ---------------------------------------------------------------------------
# Whole runs
# ---------------------------------------------------------------------------


def reference_edge_draws(seed: int, rounds: int, sizes, outer: bool, jit_inner: bool):
    """{(round, stream): draw} as the reference's hierarchical engine takes
    them (see the module docstring)."""
    num_edges = len(sizes)
    eager = lambda key, n: jax.random.gumbel(key, (n,), jnp.float32)
    jitted = jax.jit(eager, static_argnums=1)
    draws = {}
    key = jax.random.PRNGKey(seed)
    for t in range(rounds):
        key, sk = jax.random.split(key)
        if outer:
            draws[t, num_edges] = np.array(jax.random.gumbel(
                jax.random.fold_in(sk, num_edges), (num_edges,)))
        keys = [sk] if num_edges == 1 else jax.random.split(sk, num_edges)
        for e, n in enumerate(sizes):
            draws[t, e] = np.array((jitted if jit_inner else eager)(keys[e], int(n)))
    return draws


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


def test_e1_hierarchical_equals_flat_bitwise(setups):
    """One edge with the full budget is flat selection: same draws, same
    cohort, the edge aggregate taken as the global model bitwise."""
    _, (fed, model, data), params = setups
    fed2 = dataclasses.replace(fed, rounds=2)
    kw = dict(selector="heterosel", steps_per_round=1, client_execution="batched",
              device="cpu", init_params=params)
    flat = run_federated(model, fed2, data, **kw)
    hier = run_federated(model, dataclasses.replace(
        fed2, topology="hierarchical", edge_count=1), data, **kw)
    np.testing.assert_array_equal(hier.selected_history, flat.selected_history)
    np.testing.assert_array_equal(hier.accuracy, flat.accuracy)
    np.testing.assert_array_equal(hier.train_loss, flat.train_loss)
    np.testing.assert_array_equal(hier.cloud_uploads, np.ones(2, np.int64))
    assert flat.cloud_uploads is None
    for k in flat.params:
        assert torch.equal(hier.params[k], flat.params[k])


def test_weighted_mean_of_both_executor_forms():
    """The aggregator's cohort weights reach the aggregate in both forms a
    cohort arrives in: the batched executor's fused reduction
    (``fedavg_fused``) and the sequential executor's list
    (``Aggregator._mean``, which stacks it) give one model."""
    from repro_torch.fed import CohortUpdates, WeightedFedAvg
    from repro_torch.fed import server as tsrv

    gen = torch.Generator().manual_seed(0)
    stacked = {"w": torch.randn(4, 3, 5, generator=gen), "b": torch.randn(4, 5, generator=gen)}
    w = torch.tensor([5.0, 9.0, 2.0, 7.0])
    fused = tsrv.fedavg_fused(stacked, w)
    cohort = CohortUpdates(mean_loss=np.zeros(4, np.float32),
                           update_sqnorm=np.zeros(4, np.float32),
                           param_list=[{k: v[i] for k, v in stacked.items()}
                                       for i in range(4)], weights=w)
    listed = WeightedFedAvg().reduce(None, cohort)
    unweighted = WeightedFedAvg().reduce(None, dataclasses.replace(cohort, weights=None))
    for k in stacked:
        torch.testing.assert_close(listed[k], fused[k], rtol=1e-6, atol=1e-6)
        assert not torch.allclose(unweighted[k], fused[k])


def test_budgets_uploads_and_weighted_cloud_stage(setups):
    """Per-edge cohorts respect their budgets; the |D_k|-weighted aggregator
    and the random selector's uniform outer stage compose."""
    _, (fed, model, data), params = setups
    hfed = dataclasses.replace(fed, rounds=2, topology="hierarchical", edge_count=4,
                               edge_budget=2)
    engine = FederatedSpec(model, hfed, data, selector="random", steps_per_round=1,
                           aggregator="fedavg_weighted", executor="sequential",
                           device="cpu",
                           init_params=params,
                           hier_cfg=HierarchyConfig(edges_per_round=3,
                                                    partition_mode="random")).build()
    res = engine.run()
    np.testing.assert_array_equal(engine.budgets, [2, 2, 2, 2])
    np.testing.assert_array_equal(res.cloud_uploads, [3, 3])
    assert res.selected_history.sum(1).tolist() == [6, 6]
    for row in res.selected_history:
        per_edge = [row[m].sum() for m in engine.partition.member_lists()]
        assert sorted(per_edge) == [0, 2, 2, 2]
    assert all(np.isfinite(res.train_loss))


# ---------------------------------------------------------------------------
# Loud configurations
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny(setups):
    _, (fed, model, data), _ = setups
    return fed, model, data


def test_missing_edge_count(tiny):
    fed, model, data = tiny
    with pytest.raises(ValueError, match="edge_count"):
        FederatedSpec(model, dataclasses.replace(fed, topology="hierarchical"),
                      data, device="cpu").build()


def test_unknown_topology_and_policy(tiny):
    fed, model, data = tiny
    with pytest.raises(ValueError, match="topology"):
        FederatedSpec(model, fed, data, topology="mesh", device="cpu").build()
    with pytest.raises(ValueError, match="round_policy"):
        FederatedSpec(model, fed, data, round_policy="eventual", device="cpu").build()


def test_edge_fields_without_hierarchy(tiny):
    fed, model, data = tiny
    with pytest.raises(ValueError, match="edge_count"):
        FederatedSpec(model, dataclasses.replace(fed, edge_count=4), data,
                      device="cpu").build()
    with pytest.raises(ValueError, match="edge_budget|edge_count"):
        FederatedSpec(model, dataclasses.replace(fed, edge_budget=2), data,
                      device="cpu").build()


def test_hier_cfg_and_edge_noise_without_hierarchy(tiny):
    fed, model, data = tiny
    with pytest.raises(ValueError, match="hier_cfg"):
        FederatedSpec(model, fed, data, hier_cfg=HierarchyConfig(),
                      device="cpu").build()
    with pytest.raises(ValueError, match="edge_noise"):
        FederatedSpec(model, fed, data, edge_noise=lambda t, s, n: None,
                      device="cpu").build()


def test_greedy_selector_with_outer_stage_refused(tiny):
    fed, model, data = tiny
    hfed = dataclasses.replace(fed, topology="hierarchical", edge_count=3)
    with pytest.raises(ValueError, match="edge-level analogue"):
        FederatedSpec(model, hfed, data, selector="oort", device="cpu",
                      hier_cfg=HierarchyConfig(edges_per_round=2)).build()


def test_not_ported_parts_refused(tiny):
    """What is still unported raises ('filtered', slice 10); async rounds and
    the 'adaptive' selector, refused until slice 8, now build."""
    fed, model, data = tiny
    hfed = dataclasses.replace(fed, topology="hierarchical", edge_count=3)
    with pytest.raises(ValueError, match="not yet ported"):
        FederatedSpec(model, hfed, data, selector="filtered", device="cpu").build()
    eng = FederatedSpec(model, hfed, data, round_policy="async", device="cpu").build()
    assert eng.policy == "async" and eng.snapshot_kind == "async/hierarchical"
    eng = FederatedSpec(model, hfed, data, selector="adaptive", device="cpu").build()
    assert eng._budget_ctl is not None


def test_incompatible_aggregator(tiny):
    fed, model, data = tiny
    hfed = dataclasses.replace(fed, topology="hierarchical", edge_count=2)
    with pytest.raises(ValueError, match="aggregator"):
        FederatedSpec(model, hfed, data, aggregator="fedavgm", device="cpu").build()

    class Median:
        name = "median"

    with pytest.raises(ValueError, match="does not compose"):
        FederatedSpec(model, hfed, data, aggregator=Median(), device="cpu").build()


def test_edge_noise_of_wrong_shape_raises(tiny):
    fed, model, data = tiny
    hfed = dataclasses.replace(fed, rounds=1, topology="hierarchical", edge_count=3)
    with pytest.raises(ValueError, match="edge_noise"):
        run_federated(model, hfed, data, steps_per_round=1, device="cpu",
                      edge_noise=lambda t, s, n: torch.zeros(n + 1))


def test_cuda_request_without_a_card_raises(tiny):
    fed, model, data = tiny
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal needs a machine without one")
    hfed = dataclasses.replace(fed, topology="hierarchical", edge_count=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_federated(model, hfed, data, steps_per_round=1)
