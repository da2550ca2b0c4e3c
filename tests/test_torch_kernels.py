"""K1–K4 of the port (``repro_torch.kernels.score_select``) against the
reference's Pallas kernels run in interpret mode on the same inputs and the
same Gumbel noise.

On the CPU the port's wrappers take their plain PyTorch versions; the CUDA
kernels are held against those plain versions in tests/test_torch_cuda.py.

Tolerances: selected cohorts are compared exactly, as sets and, where the
test says so, in order (``merge_candidates`` orders them as the reference's
``lax.top_k``); scores and probabilities to 1e-5, which covers the
different f32 exp/log1p implementations and summation orders of XLA and
PyTorch.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from repro.core.scoring import HeteRoScoreConfig as JaxScoreCfg
from repro.core.selection import SelectorConfig as JaxSelCfg
from repro.core.selection import dynamic_temperature as jax_tau
from repro.core.state import NEVER
from repro.kernels import score_select as jss
from repro_torch.core.scoring import HeteRoScoreConfig
from repro_torch.core.selection import SelectorConfig, dynamic_temperature
from repro_torch.kernels import score_select as tss


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


def make_rows(k: int, seed: int, t: int, dtype: str):
    """Eight (K,) numpy rows of a mid-run state in ``score_inputs`` order,
    with never-selected clients; float rows rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    has_loss = rng.uniform(size=k) > 0.3
    has_mom = has_loss & (rng.uniform(size=k) > 0.5)
    rows = [
        np.where(has_loss, rng.uniform(0.1, 4.0, k), 0.0),
        np.where(has_mom, rng.uniform(0.1, 4.0, k), 0.0),
        rng.uniform(0.0, 0.69, k),
        np.where(has_loss, rng.integers(1, 6, k), 0).astype(np.int32),
        np.where(has_loss, rng.integers(0, t, k), NEVER).astype(np.int32),
        np.where(has_loss, rng.uniform(0.0, 2.0, k), 0.0),
        has_loss.astype(np.float64),
        has_mom.astype(np.float64),
    ]
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    # Round float rows through the reference's dtype once; both sides then
    # hold the same values.
    return [r if r.dtype == np.int32
            else np.array(jnp.asarray(r, jnp.float32).astype(jdt).astype(jnp.float32))
            for r in rows]


def jax_rows(rows, dtype):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    return [jnp.asarray(r) if r.dtype == np.int32 else jnp.asarray(r, jnp.float32).astype(jdt)
            for r in rows]


def torch_rows(rows, dtype):
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return [torch.from_numpy(r) if r.dtype == np.int32
            else torch.from_numpy(np.asarray(r, np.float32)).to(tdt) for r in rows]


@pytest.mark.parametrize("override", [False, True], ids=["counter", "override"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k,m,block", [(12, 6, None), (300, 24, None),
                                       (300, 24, 128), (1000, 64, 128)])
def test_plain_matches_pallas_interpret(k, m, block, dtype, override):
    t = 17
    rows = make_rows(k, seed=k, t=t, dtype=dtype)
    stale = np.random.default_rng(k + 1).uniform(0, 30, k).astype(np.float32) \
        if override else None
    key = jax.random.PRNGKey(k)
    gumbel = np.array(jax.random.gumbel(key, (k,), jnp.float32))
    tau_j = jax_tau(jnp.int32(t), JaxSelCfg())
    sel_j, probs_j, scores_j = jss.fused_score_select(
        *jax_rows(rows, dtype), round_idx=jnp.float32(t), tau=tau_j, m=m,
        key=key, cfg=JaxScoreCfg(),
        staleness_override=None if stale is None else jnp.asarray(stale),
        interpret=True)

    tau_t = dynamic_temperature(t, SelectorConfig())
    assert float(tau_t) == float(tau_j)
    sel_t, probs_t, scores_t = tss.fused_score_select(
        *torch_rows(rows, dtype), round_idx=t, tau=tau_t, m=m,
        gumbel=torch.from_numpy(gumbel), cfg=HeteRoScoreConfig(),
        staleness_override=None if stale is None else torch.from_numpy(stale),
        block=block)

    assert sel_t.shape == (m,) and len(set(sel_t.tolist())) == m
    assert set(sel_t.tolist()) == set(np.asarray(sel_j).tolist())
    # In order too: by perturbed value descending, as lax.top_k returns them.
    assert sel_t.tolist() == np.asarray(sel_j).tolist()
    np.testing.assert_allclose(scores_t.numpy(), np.asarray(scores_j), **TOL)
    np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j), **TOL)
    assert float(probs_t.sum()) == pytest.approx(1.0, abs=1e-5)


@pytest.mark.parametrize("k", [12, 300])
def test_bf16_pack_matches_reference(k):
    """A compact state casts the int32 counters (NEVER included) to bf16
    inside the pack, the same way as the reference."""
    rows = make_rows(k, seed=3, t=5, dtype="bf16")
    stale = np.linspace(-2, 40, k).astype(np.float32)
    _, _, kpad = tss._layout(k)
    packed_t = tss._pack(torch_rows(rows, "bf16"), torch.from_numpy(stale), k, kpad)
    packed_j = jss._pack(jax_rows(rows, "bf16"), jnp.asarray(stale), k, kpad)
    assert packed_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(packed_t.float().numpy(),
                                  np.asarray(packed_j.astype(jnp.float32)))


def test_stats_plain_matches_stats_kernel_interpret():
    """K1 alone: the plain per-block partials equal the Pallas kernel's
    lanes block for block (128-client blocks on both sides)."""
    k, block = 300, 128
    rows = make_rows(k, seed=11, t=9, dtype="f32")
    jblk, nblocks, kpad = jss._layout(k, block)
    assert (jblk, nblocks, kpad) == tss._layout(k, block)
    stacked_j = jss._pack(jax_rows(rows, "f32"), None, k, kpad)
    scal0 = jss._scalar_row(0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, k)
    stats_j = np.asarray(jss._run_stats(stacked_j, scal0, nblocks=nblocks,
                                        block=jblk, interpret=True))[:, :tss.NSTATS]
    stacked_t = tss._pack(torch_rows(rows, "f32"), None, k, kpad)
    stats_t = tss.score_stats(stacked_t, k=k, block=block).numpy()
    np.testing.assert_allclose(stats_t, stats_j, **TOL)


@pytest.mark.parametrize("mb", [1, 7, 32])
def test_plain_candidates_are_the_block_top_in_column_order(mb):
    """Each block's candidates are its top mb perturbed values by (value
    descending, column ascending), listed by ascending column, with global
    ids; ties are forced by clients with one state and by a Gumbel row of
    repeated values."""
    k = 64
    rows = make_rows(k, seed=1, t=3, dtype="f32")
    rows = [np.where(np.arange(k) % 3 == 0, r[0], r) for r in rows]   # every third alike
    rows = torch_rows(rows, "f32")
    stacked = tss._pack(rows, None, k, k)
    glob = tss._combine_stats(tss.score_stats(stacked, k=k, block=32))
    gumbel = torch.from_numpy(np.random.default_rng(2).integers(0, 3, k).astype(np.float32))
    s, _, _, cval, cidx = tss.score_select(
        stacked, glob, gumbel, k=k, block=32, t=3.0, tau=1.0, use_ov=False,
        decay=2.0, cfg=HeteRoScoreConfig(), mb=mb)
    pert = (s / 1.0 + gumbel).tolist()
    for b in range(2):
        cols = range(32 * b, 32 * b + 32)
        want = sorted(sorted(cols, key=lambda c: (-pert[c], c))[:mb])
        assert cidx[b].tolist() == want
        assert cval[b].tolist() == [pert[c] for c in want]
        assert len({pert[c] for c in cols}) < 32   # the block has ties


# Candidate values with ties, each (values, m): the merge must give
# lax.top_k's indices, as a set and in order.
def _tie_cases():
    every7 = np.zeros(4096, np.float32)
    every7[::7] = 1.0
    rng = np.random.default_rng(5)
    return {
        "every7": (every7, 100),
        "all-equal": (np.full(300, 0.25, np.float32), 37),
        "few-values": (rng.integers(-2, 3, 1000).astype(np.float32), 333),
        "signed-zeros": (np.array([0.0, -0.0, 1.0, -0.0, 0.0, -1.0, np.inf, -np.inf] * 4,
                                  np.float32), 20),
        "padding": (np.where(rng.uniform(size=512) < 0.5, np.float32(-1e30),
                             rng.gumbel(size=512).astype(np.float32)), 300),
    }


@pytest.mark.parametrize("case", list(_tie_cases()))
def test_merge_candidates_matches_lax_top_k(case):
    vals, m = _tie_cases()[case]
    want = np.asarray(jax.lax.top_k(jnp.asarray(vals), m)[1]).tolist()
    got = tss.merge_candidates(torch.from_numpy(vals)[None],
                               torch.arange(len(vals), dtype=torch.int32)[None], m)
    assert got.dtype == torch.int32
    assert got.tolist() == want


@pytest.mark.parametrize("nblocks,block,mb", [(8, 256, 40), (3, 1024, 128)])
def test_merge_candidates_matches_lax_top_k_over_the_reference_layout(nblocks, block, mb):
    """Candidates cut per block by lax.top_k, as the reference's
    ``_select_kernel`` cuts them, then merged by lax.top_k: the port's merge
    of the same candidates, each block's listed by column as K2 lists them,
    gives the reference's cohort, in order."""
    rng = np.random.default_rng(nblocks)
    x = rng.integers(0, 6, (nblocks, block)).astype(np.float32)
    vals, loc = jax.lax.top_k(jnp.asarray(x), mb)
    ids = loc + jnp.arange(nblocks, dtype=jnp.int32)[:, None] * block
    m = 3 * mb
    want = ids.reshape(-1)[jax.lax.top_k(vals.reshape(-1), m)[1]]
    by_column = np.argsort(np.asarray(ids), axis=1)
    got = tss.merge_candidates(
        torch.from_numpy(np.take_along_axis(np.asarray(vals), by_column, 1)),
        torch.from_numpy(np.take_along_axis(np.asarray(ids), by_column, 1)), m)
    assert got.tolist() == np.asarray(want).tolist()


def reference_select_with_gumbel(rows, gumbel, *, t, tau, m, dtype):
    """The reference's fused select (``score_select.py:342-394``) on a given
    Gumbel row instead of one drawn from a key: ``_select_kernel`` in
    interpret mode on ``gpad``, then its ``lax.top_k`` merge."""
    k = len(gumbel)
    blk, nblocks, kpad = jss._layout(k, None)
    stacked = jss._pack(jax_rows(rows, dtype), None, k, kpad)
    tf = jnp.float32(t)
    scal0 = jss._scalar_row(tf, tau, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, k)
    stats = jss._run_stats(stacked, scal0, nblocks=nblocks, block=blk, interpret=True)
    lmin, lmax, avgsq, hmax = jss._combine_stats(stats)
    scal = jss._scalar_row(tf, tau, 0.0, lmin, lmax, avgsq, hmax, 0.0, k)
    gpad = jnp.pad(jnp.asarray(gumbel), (0, kpad - k)).reshape(1, kpad)
    mb_pad = -(-min(m, blk) // jss.LANE) * jss.LANE
    kernel = functools.partial(jss._select_kernel, cfg=JaxScoreCfg(), block=blk,
                               mb_pad=mb_pad)
    _, _, _, cval, cidx = pl.pallas_call(
        kernel, grid=(nblocks,),
        in_specs=[pl.BlockSpec((jss.NROWS, blk), lambda i: (0, i)),
                  pl.BlockSpec((1, jss.LANE), lambda i: (0, 0)),
                  pl.BlockSpec((1, blk), lambda i: (0, i))],
        out_specs=[pl.BlockSpec((1, blk), lambda i: (0, i)),
                   pl.BlockSpec((1, blk), lambda i: (0, i)),
                   pl.BlockSpec((1, jss.LANE), lambda i: (i, 0)),
                   pl.BlockSpec((1, mb_pad), lambda i: (i, 0)),
                   pl.BlockSpec((1, mb_pad), lambda i: (i, 0))],
        out_shape=[jax.ShapeDtypeStruct((1, kpad), jnp.float32),
                   jax.ShapeDtypeStruct((1, kpad), jnp.float32),
                   jax.ShapeDtypeStruct((nblocks, jss.LANE), jnp.float32),
                   jax.ShapeDtypeStruct((nblocks, mb_pad), jnp.float32),
                   jax.ShapeDtypeStruct((nblocks, mb_pad), jnp.int32)],
        interpret=True,
    )(stacked, scal, gpad)
    _, pos = jax.lax.top_k(cval.reshape(-1), m)
    return np.asarray(cidx.reshape(-1)[pos])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k,m,noise", [(4096, 100, "zero"), (3000, 150, "repeated"),
                                       (600, 40, "repeated")])
def test_fused_select_breaks_ties_as_the_reference(k, m, noise, dtype):
    """Whole-path ties: every client has one state (so one score), the
    Gumbel row is 0 or a few repeated values. The port's fused select (2048-
    wide blocks) gives the reference's cohort (one block of up to 32768), in
    order: equal perturbed values go to the smaller id."""
    t = 5
    one = make_rows(1, seed=k, t=t, dtype=dtype)
    rows = [np.repeat(r, k) for r in one]
    rng = np.random.default_rng(k + m)
    gumbel = (np.zeros(k, np.float32) if noise == "zero"
              else rng.choice(np.array([-0.5, 0.0, 1.25, 2.0], np.float32), k))
    tau_j = jax_tau(jnp.int32(t), JaxSelCfg())
    want = reference_select_with_gumbel(rows, gumbel, t=t, tau=tau_j, m=m, dtype=dtype)
    sel, _, _ = tss.fused_score_select(
        *torch_rows(rows, dtype), round_idx=t, tau=dynamic_temperature(t, SelectorConfig()),
        m=m, gumbel=torch.from_numpy(gumbel), cfg=HeteRoScoreConfig())
    assert sel.tolist() == want.tolist()
    if noise == "zero":
        assert want.tolist() == list(range(m))


def test_wrappers_check_their_operands():
    k, blk = 40, 64
    rows = torch_rows(make_rows(k, seed=2, t=3, dtype="f32"), "f32")
    stacked = tss._pack(rows, None, k, blk)
    glob = tss._combine_stats(tss.score_stats(stacked, k=k, block=blk))
    g = torch.zeros(blk)
    kw = dict(k=k, block=blk, t=3.0, tau=1.0, use_ov=False, decay=2.0,
              cfg=HeteRoScoreConfig(), mb=8)
    with pytest.raises(TypeError):
        tss.score_stats(stacked.to(torch.float64), k=k, block=blk)
    with pytest.raises(ValueError):
        tss.score_stats(stacked[:, :48], k=k, block=blk)
    with pytest.raises(ValueError):
        tss.score_stats(torch.zeros(blk, tss.NROWS).t(), k=k, block=blk)
    with pytest.raises(ValueError, match="unsupported device"):
        tss.score_stats(stacked.to("meta"), k=k, block=blk)
    with pytest.raises(ValueError):
        tss.score_select(stacked, glob, g[:-1], **kw)
    with pytest.raises(ValueError):
        tss.score_select(stacked, glob.double(), g, **kw)
    with pytest.raises(ValueError):
        tss.score_select(stacked, glob, g, **{**kw, "mb": blk + 1})
    with pytest.raises(ValueError):
        tss._layout(k, 96)
    with pytest.raises(ValueError):
        tss.fused_score_select(*rows, round_idx=0, tau=1.0, m=k + 1,
                               gumbel=torch.zeros(k), cfg=HeteRoScoreConfig())


def test_plain_versions_launch_nothing():
    tss.reset_launches()
    k = 12
    rows = torch_rows(make_rows(k, seed=4, t=2, dtype="f32"), "f32")
    cfg = HeteRoScoreConfig()
    tss.fused_score_select(*rows, round_idx=2, tau=1.0, m=6,
                           gumbel=torch.zeros(k), cfg=cfg)
    tss.fused_score_probs(*rows, round_idx=2, tau=1.0, cfg=cfg)
    tss.segmented_score_probs(*rows, sizes=[5, 7], round_idx=2, tau=1.0, cfg=cfg,
                              seg=6)
    assert tss.LAUNCHES == {"score_stats": 0, "score_select": 0,
                            "score_probs": 0, "segment_probs": 0}


# ---------------------------------------------------------------------------
# K3 and K4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("override", [False, True], ids=["counter", "override"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_score_probs_plain_matches_pallas_interpret(dtype, override):
    """K3 over five 128-client blocks, so the normalizer merge runs."""
    k, block, t = 515, 128, 9
    rows = make_rows(k, seed=5, t=t, dtype=dtype)
    stale = np.random.default_rng(6).uniform(0, 30, k).astype(np.float32) \
        if override else None
    assert tss._layout(k, block) == (128, 5, 640) == jss._layout(k, block)
    tau_j = jax_tau(jnp.int32(t), JaxSelCfg())
    probs_j, scores_j = jss.fused_score_probs(
        *jax_rows(rows, dtype), round_idx=jnp.float32(t), tau=tau_j,
        cfg=JaxScoreCfg(),
        staleness_override=None if stale is None else jnp.asarray(stale),
        interpret=True, block=block)
    probs_t, scores_t = tss.fused_score_probs(
        *torch_rows(rows, dtype), round_idx=t,
        tau=dynamic_temperature(t, SelectorConfig()), cfg=HeteRoScoreConfig(),
        staleness_override=None if stale is None else torch.from_numpy(stale),
        block=block)
    np.testing.assert_allclose(scores_t.numpy(), np.asarray(scores_j), **TOL)
    np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j), **TOL)
    assert float(probs_t.sum()) == pytest.approx(1.0, abs=1e-5)


def edge_major(sizes, seg: int) -> np.ndarray:
    """(E·seg,) gather order: edge e's members in slots [e·seg, e·seg + n_e),
    client 0 in every padding slot (as the reference engine lays it out)."""
    perm = np.zeros(len(sizes) * seg, np.int64)
    off = 0
    for e, n in enumerate(sizes):
        perm[e * seg:e * seg + n] = np.arange(off, off + n)
        off += n
    return perm


@pytest.mark.parametrize("override", [False, True], ids=["counter", "override"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("seg", [128, 67], ids=["seg128", "seg67"])
def test_segment_probs_plain_matches_pallas_interpret(seg, dtype, override):
    """K4 on the reference's ragged case. The reference needs seg % 128 == 0;
    the port takes any seg ≥ the largest edge, so seg = 67 is held slot by
    slot against the reference's 128-wide layout."""
    sizes = np.array([5, 67, 60], np.int32)
    k, t = int(sizes.sum()), 6
    rows = make_rows(k, seed=13, t=t, dtype=dtype)
    stale = np.random.default_rng(14).uniform(0, 30, k).astype(np.float32) \
        if override else None
    perm_j, perm_t = edge_major(sizes, 128), edge_major(sizes, seg)
    tau_j = jax_tau(jnp.int32(t), JaxSelCfg())
    probs_j, scores_j = jss.segmented_score_probs(
        *[r[perm_j] for r in jax_rows(rows, dtype)], sizes=jnp.asarray(sizes),
        round_idx=jnp.float32(t), tau=tau_j, cfg=JaxScoreCfg(), seg=128,
        staleness_override=None if stale is None else jnp.asarray(stale[perm_j]),
        interpret=True)
    probs_t, scores_t = tss.segmented_score_probs(
        *[r[perm_t] for r in torch_rows(rows, dtype)], sizes=sizes, round_idx=t,
        tau=dynamic_temperature(t, SelectorConfig()), cfg=HeteRoScoreConfig(),
        seg=seg,
        staleness_override=None if stale is None else torch.from_numpy(stale[perm_t]))
    probs_j, scores_j = np.asarray(probs_j), np.asarray(scores_j)
    probs_t, scores_t = probs_t.numpy(), scores_t.numpy()
    assert probs_t.shape == scores_t.shape == (len(sizes) * seg,)
    for e, n in enumerate(sizes):
        mine, ref = slice(e * seg, e * seg + n), slice(e * 128, e * 128 + n)
        np.testing.assert_allclose(probs_t[mine], probs_j[ref], **TOL)
        np.testing.assert_allclose(scores_t[mine], scores_j[ref], **TOL)
        assert float(probs_t[mine].sum()) == pytest.approx(1.0, abs=1e-5)
        pad = slice(e * seg + n, (e + 1) * seg)
        assert np.all(probs_t[pad] == 0.0) and np.all(scores_t[pad] == 0.0)
        np.testing.assert_array_equal(probs_j[e * 128 + n:(e + 1) * 128], 0.0)


def test_segment_probs_plain_equals_per_edge_probs():
    """Each edge's slice of K4 is K3 run on that edge alone."""
    sizes = [7, 40, 33]
    k, t = sum(sizes), 4
    rows = torch_rows(make_rows(k, seed=21, t=t, dtype="f32"), "f32")
    cfg = HeteRoScoreConfig()
    seg = 48
    perm = torch.from_numpy(edge_major(sizes, seg))
    probs, scores = tss.segmented_score_probs(
        *[r[perm] for r in rows], sizes=sizes, round_idx=t, tau=0.9, cfg=cfg, seg=seg)
    off = 0
    for e, n in enumerate(sizes):
        p_e, s_e = tss.fused_score_probs(*[r[off:off + n] for r in rows],
                                         round_idx=t, tau=0.9, cfg=cfg)
        torch.testing.assert_close(probs[e * seg:e * seg + n], p_e, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(scores[e * seg:e * seg + n], s_e, rtol=1e-6, atol=1e-6)
        off += n


def test_ops_wrappers_take_a_client_state():
    """``ops.heterosel_probs`` and ``ops.heterosel_probs_segmented`` hand a
    ``ClientState``'s rows, in ``score_inputs`` order, to K3 and K4."""
    from repro_torch.core.state import ClientState
    from repro_torch.kernels import ops

    sizes, seg, t = [7, 40, 33], 48, 4
    rows = torch_rows(make_rows(sum(sizes), seed=22, t=t, dtype="f32"), "f32")
    cfg = HeteRoScoreConfig()
    perm = torch.from_numpy(edge_major(sizes, seg))
    state = ClientState(*rows)
    probs, scores = ops.heterosel_probs(state, t, 0.9, cfg)
    want = tss.fused_score_probs_plain(*rows, round_idx=t, tau=0.9, cfg=cfg)
    torch.testing.assert_close((probs, scores), want, rtol=0, atol=0)
    probs, scores = ops.heterosel_probs_segmented(
        state.map(lambda x: x[perm]), sizes, round_idx=t, tau=0.9, cfg=cfg, seg=seg)
    want = tss.segmented_score_probs_plain(*[r[perm] for r in rows], sizes=sizes,
                                           round_idx=t, tau=0.9, cfg=cfg, seg=seg)
    torch.testing.assert_close((probs, scores), want, rtol=0, atol=0)


def test_k3_k4_wrappers_check_their_operands():
    k, blk = 40, 64
    rows = torch_rows(make_rows(k, seed=2, t=3, dtype="f32"), "f32")
    stacked = tss._pack(rows, None, k, blk)
    glob = tss._combine_stats(tss.score_stats(stacked, k=k, block=blk))
    kw = dict(t=3.0, tau=1.0, use_ov=False, decay=2.0, cfg=HeteRoScoreConfig())
    with pytest.raises(ValueError):
        tss.score_probs(stacked, glob.double(), k=k, block=blk, **kw)
    with pytest.raises(ValueError):
        tss.score_probs(stacked[:, :48], glob, k=k, block=blk, **kw)
    sizes = torch.tensor([20, 20], dtype=torch.int32)
    with pytest.raises(ValueError):  # 64 columns are not whole 48-wide slices
        tss.segment_probs(stacked, sizes, seg=48, **kw)
    with pytest.raises(ValueError):
        tss.segment_probs(stacked, sizes.long(), seg=32, **kw)
    with pytest.raises(ValueError):
        tss.segment_probs(stacked, sizes[:1], seg=32, **kw)
    with pytest.raises(ValueError):
        tss.segment_probs(stacked, sizes, seg=0, **kw)
    with pytest.raises(ValueError, match="edge-major"):
        tss.segmented_score_probs(*rows, sizes=[20, 20], round_idx=3, tau=1.0,
                                  cfg=HeteRoScoreConfig(), seg=32)
