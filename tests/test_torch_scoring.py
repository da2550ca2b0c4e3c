"""Scoring, client state and selection of the port against the reference.

Inputs are numpy arrays drawn from a seed, handed to both packages. Scores
are compared to 1e-5 (f32 exp/log1p differ between XLA and PyTorch in the
last bits); state updates and masks exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import scoring as jscoring
from repro.core import selection as jselection
from repro.core import state as jstate
from repro_torch.core import scoring, selection, state


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite's workers share the cores, and torch's
    threads waiting on one another under that load made these tests many
    times slower than alone."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TOL = dict(rtol=1e-5, atol=1e-5)


def mid_run_states(k: int, seed: int, rounds: int = 3):
    """The same mid-run ClientState in both packages, built by folding the
    same random observations through each package's update_client_state."""
    rng = np.random.default_rng(seed)
    js = rng.uniform(0, 0.69, k).astype(np.float32)
    sj = jstate.init_client_state(k, jnp.asarray(js))
    st = state.init_client_state(k, js, device="cpu")
    for t in range(rounds):
        mask = rng.uniform(size=k) > 0.4
        loss = rng.uniform(0.1, 4, k).astype(np.float32)
        sq = rng.uniform(0, 2, k).astype(np.float32)
        sj = jstate.update_client_state(
            sj, round_idx=jnp.int32(t), selected_mask=jnp.asarray(mask),
            observed_loss=jnp.asarray(loss), observed_sqnorm=jnp.asarray(sq))
        st = state.update_client_state(
            st, round_idx=t, selected_mask=torch.from_numpy(mask),
            observed_loss=torch.from_numpy(loss), observed_sqnorm=torch.from_numpy(sq))
    return sj, st


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def assert_states_equal(sj, st):
    for f in dataclasses.fields(st):
        np.testing.assert_array_equal(as_np(getattr(st, f.name)),
                                      as_np(getattr(sj, f.name)), err_msg=f.name)


@pytest.mark.parametrize("compact", [False, True], ids=["f32", "bf16"])
def test_update_client_state_matches_reference(compact):
    sj, st = mid_run_states(40, seed=1, rounds=1)
    if compact:
        sj, st = jstate.to_bf16(sj), state.to_bf16(st)
    rng = np.random.default_rng(2)
    for t in (1, 2):
        mask = rng.uniform(size=40) > 0.5
        loss = rng.uniform(0.1, 4, 40).astype(np.float32)
        sq = rng.uniform(0, 2, 40).astype(np.float32)
        sj = jstate.update_client_state(
            sj, round_idx=jnp.int32(t), selected_mask=jnp.asarray(mask),
            observed_loss=jnp.asarray(loss), observed_sqnorm=jnp.asarray(sq))
        st = state.update_client_state(
            st, round_idx=t, selected_mask=torch.from_numpy(mask),
            observed_loss=torch.from_numpy(loss), observed_sqnorm=torch.from_numpy(sq))
    assert {f: str(d).split(".")[-1] for f, d in state.field_dtypes(st).items()} \
        == jstate.field_dtypes(sj)
    assert_states_equal(sj, st)
    np.testing.assert_array_equal(state.staleness(st, 5).numpy(),
                                  np.asarray(jstate.staleness(sj, jnp.int32(5))))


def test_never_selected_survives_bf16():
    st = state.init_client_state(8, device="cpu")
    sb = state.to_bf16(st)
    assert sb.loss_prev.dtype == torch.bfloat16
    assert sb.last_selected.dtype == torch.int32
    assert (state.to_f32(sb).last_selected == state.NEVER).all()


def test_scatter_observations_matches_reference():
    sel = np.array([1, 4, 7])
    loss = np.array([0.5, 1.5, 2.5], np.float32)
    sq = np.array([3.0, 2.0, 1.0], np.float32)
    lj, qj = jstate.scatter_observations(9, jnp.asarray(sel), jnp.asarray(loss),
                                         jnp.asarray(sq))
    lt, qt = state.scatter_observations(9, torch.from_numpy(sel),
                                        torch.from_numpy(loss), torch.from_numpy(sq))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))


@pytest.mark.parametrize("additive", [True, False], ids=["additive", "mult"])
@pytest.mark.parametrize("override", [False, True], ids=["counter", "override"])
@pytest.mark.parametrize("compact", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("k,t", [(12, 0), (12, 3), (200, 17), (200, 150)])
def test_compute_scores_matches_reference(k, t, compact, override, additive):
    sj, st = mid_run_states(k, seed=k + t, rounds=min(t, 3))
    if compact:
        sj, st = jstate.to_bf16(sj), state.to_bf16(st)
    stale = np.random.default_rng(t).uniform(-1, 30, k).astype(np.float32) \
        if override else None
    cj = jscoring.HeteRoScoreConfig()
    ct = scoring.HeteRoScoreConfig()
    comp_j = jscoring.compute_score_components(
        sj, jnp.int32(t), cj,
        staleness_override=None if stale is None else jnp.asarray(stale))
    comp_t = scoring.compute_score_components(
        st, t, ct, staleness_override=None if stale is None else torch.from_numpy(stale))
    for name in comp_j:
        np.testing.assert_allclose(comp_t[name].numpy(), np.asarray(comp_j[name]),
                                   err_msg=name, **TOL)
    sc_j = jscoring.compute_scores(
        sj, jnp.int32(t), cj, additive=additive,
        staleness_override=None if stale is None else jnp.asarray(stale))
    sc_t = scoring.compute_scores(
        st, t, ct, additive=additive,
        staleness_override=None if stale is None else torch.from_numpy(stale))
    assert sc_t.dtype == torch.float32
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), **TOL)


def test_fresh_state_scores_are_neutral():
    """Round 0, nobody observed: every client gets the same score."""
    st = state.init_client_state(12, np.zeros(12), device="cpu")
    s = scoring.compute_scores(st, 0, scoring.HeteRoScoreConfig())
    assert torch.allclose(s, s[0].expand_as(s))


@pytest.mark.parametrize("t", [0, 7, 100, 250])
def test_dynamic_temperature_is_bitwise(t):
    assert float(selection.dynamic_temperature(t, selection.SelectorConfig())) \
        == float(jselection.dynamic_temperature(jnp.int32(t), jselection.SelectorConfig()))


@pytest.mark.parametrize("name", ["heterosel", "heterosel_pallas",
                                  "heterosel_mult", "random"])
@pytest.mark.parametrize("k,m", [(12, 6), (300, 40)])
def test_selector_masks_match_reference(name, k, m):
    """Same state, same Gumbel noise → the same cohort and probabilities."""
    sj, st = mid_run_states(k, seed=m)
    key = jax.random.PRNGKey(k + m)
    gumbel = np.array(jax.random.gumbel(key, (k,), jnp.float32))
    fj = jselection.make_selector(name, jselection.SelectorConfig(num_selected=m))
    ft = selection.make_selector(name, selection.SelectorConfig(num_selected=m))
    mask_j, probs_j = fj(key, sj, jnp.int32(5))
    mask_t, probs_t = ft(torch.from_numpy(gumbel), st, 5)
    assert mask_t.dtype == torch.bool and int(mask_t.sum()) == m
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j), **TOL)


def test_make_selector_lists_what_is_ported():
    with pytest.raises(ValueError, match="heterosel_pallas"):
        selection.make_selector("filtered", selection.SelectorConfig())
    assert "adaptive" in selection.SELECTORS


def test_gumbel_noise_is_seeded():
    a = selection.gumbel_noise(torch.Generator().manual_seed(3), 1000)
    b = selection.gumbel_noise(torch.Generator().manual_seed(3), 1000)
    assert torch.equal(a, b) and torch.isfinite(a).all()
    # Standard Gumbel: mean is the Euler–Mascheroni constant.
    assert abs(float(a.mean()) - 0.5772) < 0.1
