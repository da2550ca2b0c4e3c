"""The unfused selectors' tie order against ``jax.lax.top_k`` (ROADMAP queue
3 (n)).

``core/selection.sample_clients`` and ``_topk_first`` rank by
``score_select.order_keys`` with a stable descending sort: value in IEEE
total order (−0.0 below +0.0, NaN above +inf), ties to the smaller index,
as ``lax.top_k`` ranks on the CPU. ``heterosel``, ``heterosel_mult``,
``random``, Power-of-Choice, Oort and the hierarchy's inner stage all pass
through one of the two. Before the repair ``sample_clients`` took
``torch.topk``, which leaves ties unordered, and ``_topk_first`` a stable
sort of the floats, which ranks −0.0 equal to +0.0.

A whole round runs with identical client states and a zero Gumbel row (the
reference's ``jax.random.gumbel`` and ``uniform`` patched to zeros), so
every perturbed value ties.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import selection as jselection
from repro.core import state as jstate
from repro_torch.core import selection, state

SHAPES = [(12, 6), (24, 3), (100, 10), (4096, 100)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files on parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def lax_top_k(x: np.ndarray, m: int) -> np.ndarray:
    return np.asarray(jax.lax.top_k(jnp.asarray(x), m)[1])


def tied_rows(k: int):
    """Rows with ties: all equal, ±0.0 mixed, a few distinct levels with NaN,
    and the `x[::7]` pattern of many equal values among distinct ones."""
    rng = np.random.default_rng(k)
    zeros = np.where(rng.uniform(size=k) < 0.5, -0.0, 0.0).astype(np.float32)
    levels = rng.choice(np.float32([-1.5, 0.0, 0.25, 2.0]), size=k).astype(np.float32)
    levels[rng.choice(k, size=max(k // 20, 1), replace=False)] = np.nan
    every7 = rng.normal(size=k).astype(np.float32)
    every7[::7] = 0.5
    return {"equal": np.full(k, 0.125, np.float32), "signed zeros": zeros,
            "levels and nan": levels, "every 7th": every7}


@pytest.mark.parametrize("k,m", SHAPES, ids=[f"K{k}-m{m}" for k, m in SHAPES])
def test_topk_first_matches_lax_top_k(k, m):
    for name, x in tied_rows(k).items():
        got = selection._topk_first(torch.from_numpy(x), m).numpy()
        np.testing.assert_array_equal(got, lax_top_k(x, m), err_msg=name)


def test_topk_first_ranks_plus_zero_above_minus_zero():
    x = np.float32([-0.0, 0.0, -0.0, 0.0, 1.0, np.nan])
    got = selection._topk_first(torch.from_numpy(x), 4).numpy()
    np.testing.assert_array_equal(got, lax_top_k(x, 4))
    np.testing.assert_array_equal(got, [5, 4, 1, 3])


@pytest.mark.parametrize("k,m", SHAPES, ids=[f"K{k}-m{m}" for k, m in SHAPES])
def test_sample_clients_matches_the_reference_on_ties(k, m, monkeypatch):
    """The reference's ``sample_clients`` with its Gumbel draw replaced by the
    row handed to the port: uniform probs and a zero row (every value ties),
    the `x[::7]` probs with a zero row, and tied probs with a row of ±0."""
    rng = np.random.default_rng(m)
    every7 = rng.uniform(0.5, 1.5, k).astype(np.float32)
    every7[::7] = 1.0
    every7 /= every7.sum()
    signed = np.where(rng.uniform(size=k) < 0.5, -0.0, 0.0).astype(np.float32)
    cases = {"uniform, zero row": (np.full(k, 1.0 / k, np.float32), np.zeros(k, np.float32)),
             "every 7th, zero row": (every7, np.zeros(k, np.float32)),
             "uniform, signed zeros": (np.full(k, 1.0 / k, np.float32), signed)}
    for name, (probs, g) in cases.items():
        monkeypatch.setattr(jselection.jax.random, "gumbel",
                            lambda key, shape, dtype, g=g: jnp.asarray(g, dtype))
        want = np.asarray(jselection.sample_clients(jax.random.PRNGKey(0),
                                                    jnp.asarray(probs), m))
        got = selection.sample_clients(torch.from_numpy(g), torch.from_numpy(probs), m)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        assert int(got.sum()) == m


def test_sample_clients_unchanged_where_values_are_distinct():
    """With continuous Gumbel draws the set is ``torch.topk``'s, as before."""
    rng = np.random.default_rng(3)
    for k, m in SHAPES:
        probs = torch.from_numpy(rng.dirichlet(np.ones(k)).astype(np.float32))
        g = torch.from_numpy(rng.gumbel(size=k).astype(np.float32))
        got = selection.sample_clients(g, probs, m)
        before = torch.zeros(k, dtype=torch.bool)
        before[torch.topk(torch.log(probs + 1e-30) + g, m).indices] = True
        assert torch.equal(got, before)


def identical_states(k: int, observed: bool):
    """The same ClientState in both packages, every client alike: fresh, or
    after one round in which all of them reported the same loss and norm."""
    js = np.full(k, 0.3, np.float32)
    sj = jstate.init_client_state(k, jnp.asarray(js))
    st = state.init_client_state(k, js, device="cpu")
    if observed:
        mask = np.ones(k, bool)
        loss = np.full(k, 1.25, np.float32)
        sq = np.full(k, 0.5, np.float32)
        sj = jstate.update_client_state(
            sj, round_idx=jnp.int32(0), selected_mask=jnp.asarray(mask),
            observed_loss=jnp.asarray(loss), observed_sqnorm=jnp.asarray(sq))
        st = state.update_client_state(
            st, round_idx=0, selected_mask=torch.from_numpy(mask),
            observed_loss=torch.from_numpy(loss), observed_sqnorm=torch.from_numpy(sq))
    return sj, st


ROUND_CASES = [(name, observed) for name in ("heterosel", "heterosel_mult", "random",
                                             "power_of_choice", "oort")
               for observed in (False, True)]


@pytest.mark.parametrize("name,observed", ROUND_CASES,
                         ids=[f"{n}-{'observed' if o else 'fresh'}" for n, o in ROUND_CASES])
def test_whole_round_with_tied_clients_matches_the_reference(name, observed, monkeypatch):
    """One round of each selector over identical clients with every draw 0:
    the reference's ``jax.random.gumbel`` and ``uniform`` return zeros, and
    the port takes zero rows by name."""
    k, m = 24, 6
    monkeypatch.setattr(jselection.jax.random, "gumbel",
                        lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype))
    monkeypatch.setattr(jselection.jax.random, "uniform",
                        lambda key, shape, dtype=jnp.float32, minval=0.0, maxval=1.0:
                        jnp.zeros(shape, dtype))
    sj, st = identical_states(k, observed)
    t = 1 if observed else 0
    jcfg = jselection.SelectorConfig(num_selected=m)
    cfg = selection.SelectorConfig(num_selected=m)
    want_mask, want_probs = jselection.make_selector(name, jcfg)(
        jax.random.PRNGKey(0), sj, jnp.int32(t))
    zero = torch.zeros(k)
    draws = {n: zero for n in selection.selector_draws(name)} \
        if name == "power_of_choice" else zero
    got_mask, got_probs = selection.make_selector(name, cfg)(draws, st, t)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(got_probs.numpy(), np.asarray(want_probs), rtol=1e-6,
                               atol=1e-6)
    assert int(got_mask.sum()) == m
