"""The asynchronous slice of the port against the JAX reference: the virtual
clock, the latency model, FedBuff's staleness weights and buffered
aggregation, the 4-argument selectors with the clock's staleness override,
the sync-replay contract and the loud refusals of the reference's
``tests/test_async_engine.py``; the smoke async federations, flat and
hierarchical (``heterosel`` with the outer stage's over-selection, and
``adaptive`` with its budgets), are in ``test_torch_async_fed.py``.

Draws: the reference engine splits ``key, sk`` each round and its jitted
selector draws ``gumbel(sk, (K,))`` (Power-of-Choice and Oort split ``sk``
once more, as ``test_torch_selectors`` replays them); the port takes those
rows through ``FederatedSpec.noise``. The host stream
``np.random.default_rng(seed)`` (batches, then the latencies' log-normal
jitter) is the same in both packages. The hierarchical runs take the
reference's per-edge and outer-stage rows (``hier_draws``).

Tolerances: masks, selection histories, ``cloud_uploads``, ``wall_clock``,
``round_staleness`` and the edge budgets equal; probabilities 1e-5; the
buffered step rtol 1e-6; accuracy within 2/N_test and train loss within
rtol 1e-3, the bound ``test_torch_slice.py`` sets for the chaotic lr
(ROADMAP queue 3 (c)).

The smoke federation is the reference resume matrix's hostile async profile
(``tests/test_resume_matrix.py:53-73``: K = 6, 4 rounds, multipliers
[1, 3, .5, 2.5, 1, 4], deadline 1.5, ε 0.5, jitter 0.1) at one local step
instead of two, as ``test_torch_hierarchy.py`` does and for its reason
(queue 3 (d)): the reference's f32 GroupNorm gradient on the CPU is up to
3 % off in the early blocks, and at two steps of lr 0.2 the round-3 train
loss drifts 3e-3 relative apart while the selection, the clock and the
staleness still agree exactly. Measured at one step: the train-loss gap is
2.2e-5 and 1.1e-4 relative in rounds 2 and 3, and 5 stragglers aggregate.
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
from repro.core import selection as jselection
from repro.data import make_vision_data as jax_make_vision_data
from repro.fed import RoundHook as JaxRoundHook
from repro.fed import async_engine as jasync
from repro.fed import clock as jclock
from repro.models import build_model as jax_build_model
from repro_torch.configs.base import FedConfig
from repro_torch.configs.registry import get_config, smoke_variant
from repro_torch.convert import params_from_jax
from repro_torch.core import selection
from repro_torch.data import make_vision_data
from repro_torch.fed import (AsyncConfig, BufferedAggregator, ExecutorCompatError,
                             FederatedSpec, LatencyModel, RoundHook, VirtualClock,
                             run_federated, staleness_weights)
from repro_torch.fed import async_engine
from repro_torch.kernels import score_select as tss

from test_torch_selectors import DRAWS, states
from test_torch_slice import jax_compile_cache  # noqa: F401  (autouse fixture)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# The reference resume matrix's hostile async profile
# (tests/test_resume_matrix.py:53-73).
ROUNDS = 4
FED_KW = dict(num_clients=6, participation=0.5, rounds=ROUNDS, local_epochs=1,
              local_batch=8, lr=0.2, mu=0.1, dirichlet_alpha=0.1, seed=0)
DATA_KW = dict(train_per_class=24, test_per_class=8, noise=0.3)
MULT = np.asarray([1.0, 3.0, 0.5, 2.5, 1.0, 4.0])
ACFG_KW = dict(deadline=1.5, over_select_frac=0.5, jitter=0.1)
STEPS = 1


def gumbel_row(key, k):
    return torch.from_numpy(np.array(jax.random.gumbel(key, (k,), jnp.float32)))


def round_draws(selector, key, k, remask=False):
    """One round's draws as the reference's selector takes them from ``sk``
    (and the availability re-sample from ``fold_in(sk, 1)``)."""
    d = DRAWS[selector](key, k) if selector in DRAWS else gumbel_row(key, k)
    if remask:
        d = dict(d) if isinstance(d, dict) else {"gumbel": d}
        d["remask"] = gumbel_row(jax.random.fold_in(key, 1), k)
    return d


def reference_draws(selector, seed, k, rounds, remask=False):
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(rounds):
        key, sk = jax.random.split(key)
        out.append(round_draws(selector, sk, k, remask))
    return out


def hier_draws(seed, rounds, sizes, outer, remask, jit_inner=True):
    """{(round, stream): draws} as the reference's hierarchical engine takes
    them: edge e's rows from ``split(sk, E)[e]`` (and its re-sample's from
    ``fold_in`` of it), the outer stage's ``gumbel(fold_in(sk, E), (E,))``.
    The reference's per-edge selectors draw under ``jax.jit``; its segmented
    ``heterosel_pallas`` stage draws eagerly (``jit_inner=False``)."""
    num_edges = len(sizes)
    eager = lambda key, n: jax.random.gumbel(key, (n,), jnp.float32)
    inner = jax.jit(eager, static_argnums=1) if jit_inner else eager
    draws = {}
    key = jax.random.PRNGKey(seed)
    for t in range(rounds):
        key, sk = jax.random.split(key)
        if outer:
            draws[t, num_edges] = gumbel_row(jax.random.fold_in(sk, num_edges), num_edges)
        keys = jax.random.split(sk, num_edges)
        for e, n in enumerate(sizes):
            row = torch.from_numpy(np.array(inner(keys[e], int(n))))
            if remask:
                row = {"gumbel": row, "remask": torch.from_numpy(np.array(
                    inner(jax.random.fold_in(keys[e], 1), int(n))))}
            draws[t, e] = row
    return draws


# ---------------------------------------------------------------------------
# Clock, latencies, FedBuff
# ---------------------------------------------------------------------------


def test_virtual_clock_order_and_state_roundtrip():
    ours, ref = VirtualClock(), jclock.VirtualClock()
    # equal times resolve in insertion (seq) order
    for delay, client in [(2.0, 0), (1.0, 1), (2.0, 2), (0.5, 3), (1.0, 4), (3.0, 5)]:
        for c in (ours, ref):
            c.schedule(delay, client, dispatch_round=0, payload=f"p{client}")
    assert ours.peek_time() == ref.peek_time() and ours.latest_time() == ref.latest_time()
    got = [(e.time, e.seq, e.client) for e in ours.pop_due(1.0)]
    want = [(e.time, e.seq, e.client) for e in ref.pop_due(1.0)]
    assert got == want == [(0.5, 3, 3), (1.0, 1, 1), (1.0, 4, 4)]
    assert ours.now == ref.now == 1.0
    ours.schedule(0.25, 9, dispatch_round=1, payload="p9")
    ref.schedule(0.25, 9, dispatch_round=1, payload="p9")
    state = ours.state_dict()
    assert state == ref.state_dict()
    payloads = {e.seq: e.payload for e in ours.pending()}
    back = VirtualClock()
    back.load_state_dict(state, payloads)
    assert back.state_dict() == state
    assert [(e.seq, e.payload) for e in back.drain()] == \
        [(e.seq, e.payload) for e in ours.drain()]
    assert back.now == ours.now == 3.0
    with pytest.raises(ValueError, match="no payload"):
        VirtualClock().load_state_dict(state, {})
    with pytest.raises(ValueError, match="delay"):
        VirtualClock().schedule(-1.0, 0, 0)


def test_channel_queue_shares_the_clock_and_leaves_training_state_alone():
    ours, ref = VirtualClock(), jclock.VirtualClock()
    for c in (ours, ref):
        c.schedule(1.0, 0, dispatch_round=0)
        ch = c.channel("serve")
        assert c.channel("serve") is ch
        for time_, tag in [(0.5, 1), (0.2, 2), (0.5, 3), (2.0, 4)]:
            ch.schedule_at(time_, tag=tag, round_idx=0)
    got = [(e.time, e.seq, e.client) for e in ours.channel("serve").pop_due(0.5)]
    want = [(e.time, e.seq, e.client) for e in ref.channel("serve").pop_due(0.5)]
    assert got == want == [(0.2, 1, 2), (0.5, 0, 1), (0.5, 2, 3)]
    assert ours.now == 0.5 and len(ours) == 1 and len(ours.channel("serve")) == 1
    assert ours.state_dict() == ref.state_dict()
    assert ours.channel("serve").peek_time() == 2.0


@pytest.mark.parametrize("jitter", [0.0, 0.1])
def test_latency_model_sample_matches_reference_bitwise(jitter):
    mult = np.random.default_rng(3).lognormal(0, 0.5, 12)
    ours = LatencyModel(mult, base=1.5, jitter=jitter)
    ref = jclock.LatencyModel(mult, base=1.5, jitter=jitter)
    rng_a, rng_b = np.random.default_rng(7), np.random.default_rng(7)
    for cohort in ([0, 3, 5], [1, 2, 4, 6, 8, 11], [7]):
        np.testing.assert_array_equal(ours.sample(np.asarray(cohort), rng_a),
                                      ref.sample(np.asarray(cohort), rng_b))
    assert rng_a.bit_generator.state == rng_b.bit_generator.state
    assert ours.reference_time() == ref.reference_time()


def test_staleness_weights_and_buffered_step_match_reference():
    rng = np.random.default_rng(0)
    tau = np.asarray([0.0, 1.0, 3.0, -1.0, 7.5])
    np.testing.assert_array_equal(staleness_weights(tau, 0.5),
                                  jasync.staleness_weights(tau, 0.5))
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    deltas = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
              for _ in range(3)]
    weights = np.asarray([2.0, 1.0, 3.0], np.float32)
    stale = np.asarray([0.0, 2.0, 1.0], np.float32)
    got = BufferedAggregator(0.5, server_lr=0.7).reduce(
        {k: torch.from_numpy(v) for k, v in params.items()},
        async_engine.CohortUpdates(
            mean_loss=None, update_sqnorm=None, staleness=stale, weights=weights,
            delta_list=[{k: torch.from_numpy(v) for k, v in d.items()} for d in deltas]))
    want = jasync.BufferedAggregator(0.5, server_lr=0.7).reduce(
        params, jasync.CohortUpdates(mean_loss=None, update_sqnorm=None, staleness=stale,
                                     weights=weights, delta_list=deltas))
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)


# ---------------------------------------------------------------------------
# make_async_selector with the clock's staleness
# ---------------------------------------------------------------------------

ASYNC_SELECTORS = ["heterosel", "heterosel_pallas", "heterosel_mult", "power_of_choice",
                   "oort", "random", "adaptive"]


@pytest.mark.parametrize("name", ASYNC_SELECTORS)
def test_async_selector_matches_reference(name):
    k, m = 40, 8
    sj, st = states(k, seed=5, rounds=4)
    rng = np.random.default_rng(11)
    stale = rng.uniform(0, 6, k).astype(np.float32)
    stale[:3] = async_engine.NEVER_STALE
    speeds = rng.uniform(0.3, 2.0, k).astype(np.float32)
    fj = jselection.make_async_selector(name, jselection.SelectorConfig(num_selected=m),
                                        speeds=jnp.asarray(speeds))
    ft = selection.make_async_selector(name, selection.SelectorConfig(num_selected=m),
                                       speeds=torch.from_numpy(speeds))
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        mask_j, probs_j = fj(key, sj, jnp.int32(4), jnp.asarray(stale))
        mask_t, probs_t = ft(round_draws(name, key, k), st, 4, torch.from_numpy(stale))
        np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
        np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j), rtol=1e-5,
                                   atol=1e-7)


def test_async_pallas_selector_feeds_the_override_row(monkeypatch):
    """Under heterosel_pallas the clock's staleness reaches K1 + K2 as the
    override row (the kernel's ``use_ov``; its plain version on the CPU)."""
    seen = []
    plain = tss.score_select_plain

    def spy(stacked, *args, **kwargs):
        seen.append((stacked[tss.ROW_STALE].clone(), kwargs.get("use_ov")))
        return plain(stacked, *args, **kwargs)

    monkeypatch.setattr(tss, "score_select_plain", spy)
    k = 12
    _, st = states(k, seed=1, rounds=2)
    stale = torch.arange(k, dtype=torch.float32) / 2
    sel = selection.make_async_selector("heterosel_pallas",
                                        selection.SelectorConfig(num_selected=4))
    sel(torch.zeros(k), st, 2, stale)
    assert len(seen) == 1 and seen[0][1] is True
    torch.testing.assert_close(seen[0][0][:k], stale, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setups():
    jfed = JaxFedConfig(**FED_KW)
    jmodel = jax_build_model(dataclasses.replace(
        jax_smoke_variant(jax_get_config("resnet18-cifar10")), d_model=8))
    jdata = jax_make_vision_data(jfed, **DATA_KW)
    fed = FedConfig(**FED_KW)
    model = build_model_smoke()
    data = make_vision_data(fed, **DATA_KW)
    params = params_from_jax(jax.tree.map(
        np.array, jmodel.init_params(jax.random.PRNGKey(fed.seed + 1))))
    return (jfed, jmodel, jdata), (fed, model, data), params


def build_model_smoke():
    from repro_torch.models import build_model

    return build_model(dataclasses.replace(
        smoke_variant(get_config("resnet18-cifar10")), d_model=8))


class BudgetLog(RoundHook):
    """The hierarchical engine's per-edge budgets after each round."""

    def __init__(self):
        self.budgets = []

    def on_round_end(self, ctx):
        self.budgets.append(np.asarray(ctx.engine.budgets).copy())


class JaxBudgetLog(JaxRoundHook):
    def __init__(self):
        self.budgets = []

    def on_round_end(self, ctx):
        self.budgets.append(np.asarray(ctx.engine.budgets).copy())


# Hierarchical async cases on the same profile: (selector, E, edges per
# round). With E_sel = 1 the outer stage over-selects ⌈1 · 1.5⌉ = 2 of the
# idle edges by its draw; 'adaptive' dispatches every idle edge under the
# budgets its controller moves.


def test_async_replays_sync_under_equal_latencies(setups):
    """Equal latencies, no deadline, ε = 0: the same draws and cohorts as
    the sync run, and FedAvg up to float reassociation, which this lr
    amplifies round by round (1e-7 after round 0, 2e-3 after round 2 in the
    params), so the metrics take the reference's own envelope
    (``test_async_engine.py::test_equal_latencies_infinite_deadline``)."""
    _, (fed, model, data), params = setups
    fed = dataclasses.replace(fed, rounds=3)
    noise = reference_draws("heterosel", fed.seed, fed.num_clients, fed.rounds)
    kw = dict(selector="heterosel", steps_per_round=1, device="cpu", init_params=params,
              noise=lambda t, k: noise[t])
    sync = FederatedSpec(model, fed, data, **kw).build().run()
    asy = FederatedSpec(model, fed, data, round_policy="async", **kw).build().run()
    np.testing.assert_array_equal(asy.selected_history, sync.selected_history)
    np.testing.assert_array_equal(asy.round_staleness, np.zeros(fed.rounds))
    np.testing.assert_array_equal(asy.wall_clock, np.arange(1.0, fed.rounds + 1))
    np.testing.assert_allclose(asy.accuracy, sync.accuracy, atol=0.011)
    np.testing.assert_allclose(asy.train_loss, sync.train_loss, atol=2e-2)


def test_fedbuff_under_the_sync_engine_is_fedavg(setups):
    _, (fed, model, data), params = setups
    fed = dataclasses.replace(fed, rounds=1)
    kw = dict(selector="heterosel", steps_per_round=1, device="cpu", init_params=params)
    a = FederatedSpec(model, fed, data, **kw).build().run()
    b = FederatedSpec(model, fed, data, aggregator="fedbuff", **kw).build().run()
    np.testing.assert_array_equal(a.selected_history, b.selected_history)
    for k in a.params:
        torch.testing.assert_close(b.params[k], a.params[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("executor", ["batched", "sequential"])
def test_async_engine_runs_both_executors(setups, executor):
    _, (fed, model, data), _ = setups
    res = run_federated(model, dataclasses.replace(fed, rounds=2), data,
                        selector="heterosel", steps_per_round=1, client_execution=executor,
                        round_policy="async", system=MULT,
                        async_cfg=AsyncConfig(deadline=1.0), device="cpu")
    assert np.isfinite(res.accuracy).all() and len(res.wall_clock) == 2


# ---------------------------------------------------------------------------
# Loud configurations (the reference's TestAsyncConfigAndCompat)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,match", [
    (dict(deadline=0.0), "deadline"), (dict(over_select_frac=-0.1), "over_select"),
    (dict(base_latency=0.0), "base_latency")])
def test_bad_async_config_raises(kw, match):
    with pytest.raises(ValueError, match=match):
        AsyncConfig(**kw)


def test_unknown_round_policy_raises(setups):
    _, (fed, model, data), _ = setups
    with pytest.raises(ValueError, match="round_policy"):
        FederatedSpec(model, fed, data, round_policy="semi", device="cpu").build()


@pytest.mark.parametrize("knob", ["system", "async_cfg"])
def test_async_knobs_with_sync_policy_raise(setups, knob):
    _, (fed, model, data), _ = setups
    value = np.ones(fed.num_clients) if knob == "system" else AsyncConfig()
    with pytest.raises(ValueError, match="round_policy='async'"):
        FederatedSpec(model, fed, data, device="cpu", **{knob: value}).build()


def test_non_delta_aggregator_raises(setups):
    _, (fed, model, data), _ = setups
    with pytest.raises(ValueError, match="supports_deltas"):
        FederatedSpec(model, fed, data, round_policy="async", aggregator="fedavgm",
                      device="cpu").build()


def test_chunked_batched_raises(setups):
    _, (fed, model, data), _ = setups
    with pytest.raises(ExecutorCompatError, match="client_chunk"):
        FederatedSpec(model, dataclasses.replace(fed, client_chunk=2), data,
                      round_policy="async", device="cpu").build()


def test_bad_system_shape_raises(setups):
    _, (fed, model, data), _ = setups
    with pytest.raises(ValueError, match="multipliers"):
        FederatedSpec(model, fed, data, round_policy="async", system=np.ones(3),
                      device="cpu").build()
