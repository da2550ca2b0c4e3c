"""K1–K4 of the port (``repro_torch.kernels.score_select``) against the
reference's Pallas kernels run in interpret mode on the same inputs and the
same Gumbel noise.

On the CPU the port's wrappers take their plain PyTorch versions; the CUDA
kernels are held against those plain versions in tests/test_torch_cuda.py.

Tolerances: selected sets are compared exactly (as sets: the two sorts may
order ties differently); scores and probabilities to 1e-5, which covers the
different f32 exp/log1p implementations and summation orders of XLA and
PyTorch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

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


def test_plain_candidates_are_sorted_value_desc_index_asc():
    """Ties inside a block come out by ascending column, as the kernel's
    bitonic sort orders them."""
    k = 64
    rows = torch_rows(make_rows(k, seed=1, t=3, dtype="f32"), "f32")
    stacked = tss._pack(rows, None, k, k)
    glob = tss._combine_stats(tss.score_stats(stacked, k=k, block=32))
    gumbel = torch.zeros(k)
    _, _, _, cval, cidx = tss.score_select(
        stacked, glob, gumbel, k=k, block=32, t=3.0, tau=1.0, use_ov=False,
        decay=2.0, cfg=HeteRoScoreConfig(), mb=32)
    for b in range(2):
        v, i = cval[b].numpy(), cidx[b].numpy()
        assert np.all(v[:-1] >= v[1:])
        ties = v[:-1] == v[1:]
        assert np.all(i[:-1][ties] < i[1:][ties])
        assert set(i.tolist()) == set(range(32 * b, 32 * b + 32))


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
