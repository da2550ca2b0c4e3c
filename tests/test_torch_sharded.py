"""K8, the sharded select, against the reference and the port's fused path.

``sharded_score_select_plain`` runs K1 and K2's plain versions on each
client shard of a gloo process group. World size 1 runs in this process;
world sizes 2, 4 and 8 run as groups of the first 2, 4 and 8 of 8 processes
spawned once with ``torch.multiprocessing`` (a ``file://`` rendezvous),
joined under a timeout so that a hang fails the test. Every rank's cohort
must be the reference's on the same Gumbel row — its fused
``ops.heterosel_topm`` (Pallas in interpret mode) and its
``ops.heterosel_topm_sharded`` on a one-device mesh — with probabilities
within 2e-6 (the reference's own tolerance, ``tests/test_kernels.py``), and
the ranks must agree bitwise. The JAX package is imported inside the tests
only, so the spawned ranks import torch and the port alone.
"""

import contextlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.scoring import HeteRoScoreConfig
from repro_torch.core.selection import SelectorConfig, dynamic_temperature
from repro_torch.core.state import (init_client_state, score_inputs, to_bf16,
                                    update_client_state)
from repro_torch.kernels import score_select as tss

T = 4
# (K, m, dtype, staleness override). K = 1100 at W = 8 leaves shard 4 with 76
# of its 256 columns and shards 5-7 empty; K = 384 at W = 8 leaves 5 of 8
# shards empty.
CASES = [(384, 12, "f32", False), (1024, 16, "bf16", False), (5000, 50, "f32", True),
         (5000, 50, "bf16", True), (1100, 20, "f32", False)]
CASE_IDS = [f"K{k}-m{m}-{d}{'-override' if o else ''}" for k, m, d, o in CASES]
JOIN_TIMEOUT_S = 240


def case_arrays(k, seed):
    """numpy draws of a mid-training state, its staleness override and its
    Gumbel key's seed, shared by both packages."""
    rng = np.random.default_rng(seed)
    rounds = []
    for _ in range(3):
        rounds.append((rng.uniform(size=k) > 0.4, rng.uniform(0.1, 4, k).astype(np.float32),
                       rng.uniform(0, 2, k).astype(np.float32)))
    return dict(js=rng.uniform(0, 0.69, k).astype(np.float32), rounds=rounds,
                stale=rng.uniform(-1, 30, k).astype(np.float32))


def torch_state(arrays, dtype):
    st = init_client_state(len(arrays["js"]), arrays["js"], device="cpu")
    for t, (mask, loss, sq) in enumerate(arrays["rounds"]):
        st = update_client_state(st, round_idx=t, selected_mask=torch.from_numpy(mask),
                                 observed_loss=torch.from_numpy(loss),
                                 observed_sqnorm=torch.from_numpy(sq))
    return to_bf16(st) if dtype == "bf16" else st


def port_inputs(case, gumbel):
    k, m, dtype, override = case
    arrays = case_arrays(k, seed=k + m)
    return dict(rows=score_inputs(torch_state(arrays, dtype)), gumbel=torch.from_numpy(gumbel),
                stale=torch.from_numpy(arrays["stale"]) if override else None, m=m)


def run_sharded(inp, group, plain=True):
    fn = tss.sharded_score_select_plain if plain else tss.sharded_score_select
    return fn(*inp["rows"], round_idx=T,
              tau=dynamic_temperature(T, SelectorConfig(num_selected=inp["m"])),
              m=inp["m"], gumbel=inp["gumbel"], cfg=HeteRoScoreConfig(), group=group,
              staleness_override=inp["stale"])


WORLDS = (2, 4, 8)


def _rank(rank, world, rendezvous, gumbels, out_dir):
    """One rank of a spawned gloo group of ``world`` ranks: for each size in
    WORLDS the ranks below it form a group of that size and run every case
    through the sharded select on it; results saved for the parent."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            world_size=world, rank=rank)
    try:
        for size in WORLDS:
            group = dist.new_group(list(range(size)))   # every rank takes part in new_group
            if rank < size:
                out = [tuple(x.clone() for x in run_sharded(port_inputs(case, g), group))
                       for case, g in zip(CASES, gumbels)]
                torch.save(out, os.path.join(out_dir, f"world{size}-rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_group(world, tmp_path, gumbels):
    """Results by group size and rank, from one spawn of ``world`` ranks."""
    ctx = mp.start_processes(_rank, args=(world, str(tmp_path / "rendezvous"), gumbels,
                                          str(tmp_path)),
                             nprocs=world, join=False, start_method="spawn")
    for _ in range(JOIN_TIMEOUT_S):
        if ctx.join(timeout=1):
            break
    else:
        for p in ctx.processes:
            p.kill()
        pytest.fail(f"world size {world}: the gloo group did not finish in "
                    f"{JOIN_TIMEOUT_S} s")
    return {size: [torch.load(tmp_path / f"world{size}-rank{r}.pt") for r in range(size)]
            for size in WORLDS}


@pytest.fixture(scope="module")
def references():
    """The reference's Gumbel row, fused and one-device sharded results per
    case (Pallas in interpret mode). Each call is jitted whole: run op by op,
    its interpreted kernels compile hundreds of small programs one by one;
    jitted, they give the same bits at a fraction of the cost."""
    import jax
    import jax.numpy as jnp

    from repro.core.scoring import HeteRoScoreConfig as JaxCfg
    from repro.core.selection import SelectorConfig as JaxSel
    from repro.core.selection import dynamic_temperature as jax_tau
    from repro.core.state import init_client_state as jinit
    from repro.core.state import to_bf16 as jbf16
    from repro.core.state import update_client_state as jupdate
    from repro.kernels import ops as jops

    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("clients",))
    out = []
    for k, m, dtype, override in CASES:
        arrays = case_arrays(k, seed=k + m)
        sj = jinit(k, jnp.asarray(arrays["js"]))
        for t, (mask, loss, sq) in enumerate(arrays["rounds"]):
            sj = jupdate(sj, round_idx=jnp.int32(t), selected_mask=jnp.asarray(mask),
                         observed_loss=jnp.asarray(loss), observed_sqnorm=jnp.asarray(sq))
        if dtype == "bf16":
            sj = jbf16(sj)
        key = jax.random.PRNGKey(k + m)
        tau = jax_tau(jnp.int32(T), JaxSel(num_selected=m))
        stale = jnp.asarray(arrays["stale"]) if override else None
        fused = jax.jit(lambda s, tau, key, stale: jops.heterosel_topm(
            s, jnp.int32(T), tau, m, key, JaxCfg(), interpret=True,
            staleness_override=stale))(sj, tau, key, stale)
        sharded = jax.jit(lambda s, tau, key, stale: jops.heterosel_topm_sharded(
            s, jnp.int32(T), tau, m, key, JaxCfg(), mesh=mesh, interpret=True,
            staleness_override=stale))(sj, tau, key, stale)
        gumbel = np.array(jax.random.gumbel(key, (k,), jnp.float32))
        out.append((gumbel, [tuple(np.asarray(x) for x in r) for r in (fused, sharded)]))
    return out


def assert_matches_reference(got, ref, where):
    sel, probs, _ = got
    for name, (ref_sel, ref_probs, _) in zip(("fused", "sharded"), ref):
        assert sorted(sel.tolist()) == sorted(ref_sel.tolist()), f"{where} vs {name}"
        np.testing.assert_allclose(probs.numpy(), ref_probs, atol=2e-6,
                                   err_msg=f"{where} vs the reference's {name}")


@pytest.fixture()
def one_rank_gloo(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous1'}",
                            world_size=1, rank=0)
    yield dist.group.WORLD
    dist.destroy_process_group()


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_one_rank_is_the_fused_path_bitwise_and_the_reference(case, references,
                                                                one_rank_gloo):
    gumbel, ref = references[CASES.index(case)]
    inp = port_inputs(case, gumbel)
    got = run_sharded(inp, one_rank_gloo)
    fused = tss.fused_score_select_plain(
        *inp["rows"], round_idx=T, tau=dynamic_temperature(T, SelectorConfig(num_selected=inp["m"])),
        m=inp["m"], gumbel=inp["gumbel"], cfg=HeteRoScoreConfig(),
        staleness_override=inp["stale"])
    for g, f in zip(got, fused):
        assert torch.equal(g, f)
    assert got[0].dtype == torch.int32
    assert_matches_reference(got, ref, "W=1")
    # The kernel wrapper takes the plain versions for CPU tensors.
    for g, w in zip(run_sharded(inp, one_rank_gloo, plain=False), got):
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def spawned(references, tmp_path_factory):
    """One spawn of max(WORLDS) gloo ranks serves every world size: a
    process start-up (importing torch) is most of a rank's cost."""
    return spawn_group(max(WORLDS), tmp_path_factory.mktemp("gloo"),
                       [g for g, _ in references])


@pytest.mark.parametrize("world", WORLDS)
def test_world_sizes_match_the_reference(world, references, spawned):
    per_rank = spawned[world]
    for i, case in enumerate(CASES):
        first = per_rank[0][i]
        for r in range(1, world):
            for a, b in zip(first, per_rank[r][i]):
                assert torch.equal(a, b), f"rank {r} disagrees with rank 0 on {CASE_IDS[i]}"
        assert_matches_reference(first, references[i][1], f"W={world} {CASE_IDS[i]}")


@pytest.mark.parametrize("world", [2, 4, 8])
def test_in_process_shards_match_the_reference(world, references):
    """The collectives' arithmetic over every shard in one process (what
    one card checks) gives the reference's cohort too."""
    for case, (gumbel, ref) in zip(CASES, references):
        inp = port_inputs(case, gumbel)
        got = tss.sharded_score_select_in_process(
            *inp["rows"], world=world, round_idx=T,
            tau=dynamic_temperature(T, SelectorConfig(num_selected=inp["m"])), m=inp["m"],
            gumbel=inp["gumbel"], cfg=HeteRoScoreConfig(), staleness_override=inp["stale"])
        assert_matches_reference(got, ref, f"in-process W={world} {case}")


@pytest.mark.parametrize("k,world", [(5000, 4), (1100, 8), (384, 8)])
def test_offset_kernels_are_the_unsplit_kernels_on_the_shard(k, world):
    """Plain K1 and K2 on a shard with its offset give, block for block, what
    they give on the unsplit state (128-wide blocks, so the shard's blocks
    are blocks of the unsplit layout); a shard's blocks past K are padding."""
    arrays = case_arrays(k, seed=3)
    rows = score_inputs(torch_state(arrays, "f32"))
    gumbel = torch.from_numpy(np.random.default_rng(4).gumbel(size=k).astype(np.float32))
    blk = 128
    _, _, full = tss._layout(k, blk)
    stacked = tss._pack(rows, None, k, full)
    gpad = torch.nn.functional.pad(gumbel, (0, full - k))
    stats = tss.score_stats_plain(stacked, k=k, block=blk)
    glob = tss._combine_stats(stats)
    kw = dict(block=blk, t=float(T), tau=0.9, use_ov=False, decay=1.5,
              cfg=HeteRoScoreConfig(), mb=8)
    whole = tss.score_select_plain(stacked, glob, gpad, k=k, **kw)
    nfull = full // blk
    for rank in range(world):
        s_l, g_l, off, klim = tss.shard_operands(rows, gumbel, None, rank=rank, world=world,
                                                 block=blk)
        st_l = tss.score_stats_plain(s_l, k=klim, block=blk, off=off)
        out_l = tss.score_select_plain(s_l, glob, g_l, k=klim, off=off, **kw)
        b0, nb = off // blk, s_l.shape[1] // blk
        live = max(0, min(nb, nfull - b0))          # the shard's blocks inside K's layout
        assert torch.equal(st_l[:live], stats[b0:b0 + live])
        assert torch.equal(out_l[2][:live], whole[2][b0:b0 + live])
        assert torch.equal(out_l[3][:live], whole[3][b0:b0 + live])
        assert torch.equal(out_l[4][:live], whole[4][b0:b0 + live])
        cols = slice(b0 * blk, (b0 + live) * blk)
        assert torch.equal(out_l[0][:live * blk], whole[0][cols])
        assert torch.equal(out_l[1][:live * blk], whole[1][cols])
        # Blocks past K: no observed client, no valid column, no candidate value.
        assert bool((st_l[live:, tss.ST_NOBS] == 0).all())
        assert bool((st_l[live:, tss.ST_LMIN] == tss.BIG).all())
        assert bool((out_l[1][live * blk:] == 0).all())


def test_group_and_device_must_agree(one_rank_gloo):
    inp = port_inputs(CASES[0], np.zeros(CASES[0][0], np.float32))
    with pytest.raises(ValueError, match="nccl"):
        tss._GroupComm(one_rank_gloo, torch.device("cuda"))
    with pytest.raises(ValueError, match=r"m must be"):
        tss.sharded_score_select_plain(*inp["rows"], round_idx=T, tau=1.0, m=0,
                                       gumbel=inp["gumbel"], cfg=HeteRoScoreConfig(),
                                       group=one_rank_gloo)


# ---------------------------------------------------------------------------
# Collectives per call, and the cohort's order
# ---------------------------------------------------------------------------

# Every collective of torch.distributed that a K8 call could make.
COLLECTIVES = ("all_gather", "all_gather_coalesced", "all_gather_into_tensor",
               "all_gather_object", "all_gather_single", "all_reduce", "all_reduce_coalesced",
               "all_to_all", "all_to_all_single", "barrier", "batch_isend_irecv", "broadcast",
               "broadcast_object_list", "gather", "gather_object", "irecv", "isend", "recv",
               "recv_object_list", "reduce", "reduce_scatter", "reduce_scatter_single",
               "reduce_scatter_tensor", "scatter", "scatter_object_list", "send",
               "send_object_list")


@contextlib.contextmanager
def counting_collectives():
    """Count the calls of every torch.distributed collective while inside."""
    counts, saved = {}, {}
    for name in COLLECTIVES:
        fn = getattr(dist, name, None)
        if fn is None:
            continue
        saved[name] = fn

        def counted(*args, _fn=fn, _name=name, **kwargs):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*args, **kwargs)

        setattr(dist, name, counted)
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def collectives_per_case(group):
    """The collectives one K8 call makes, for each case, over ``group``."""
    out = []
    for k, m, dtype, override in CASES:
        inp = port_inputs((k, m, dtype, override), np.zeros(k, np.float32))
        with counting_collectives() as counts:
            run_sharded(inp, group)
        out.append(dict(counts))
    return out


def _count_rank(rank, world, rendezvous, out_dir):
    """One rank of a spawned gloo group: for each size in (2, world) the
    ranks below it count K8's collectives on a group of that size."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            world_size=world, rank=rank)
    try:
        for size in (2, world):
            group = dist.new_group(list(range(size)))
            if rank < size:
                torch.save(collectives_per_case(group),
                           os.path.join(out_dir, f"count{size}-rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_at_most_four_collectives_per_call(one_rank_gloo, tmp_path):
    """K8 stitches its shards with at most four collective calls (four
    all-gathers) at world sizes 1, 2 and 4 over gloo, on every rank."""
    by_world = {1: [collectives_per_case(one_rank_gloo)]}
    ctx = mp.start_processes(_count_rank, args=(4, str(tmp_path / "rendezvous4"),
                                                str(tmp_path)),
                             nprocs=4, join=False, start_method="spawn")
    for _ in range(JOIN_TIMEOUT_S):
        if ctx.join(timeout=1):
            break
    else:
        for p in ctx.processes:
            p.kill()
        pytest.fail(f"the gloo group did not finish in {JOIN_TIMEOUT_S} s")
    for size in (2, 4):
        by_world[size] = [torch.load(tmp_path / f"count{size}-rank{r}.pt")
                          for r in range(size)]
    for world, ranks in by_world.items():
        for rank, per_case in enumerate(ranks):
            for case_id, counts in zip(CASE_IDS, per_case):
                assert 1 <= sum(counts.values()) <= 4, (world, rank, case_id, counts)


def test_cohort_order_matches_the_reference(references, spawned, one_rank_gloo):
    """K8's cohort comes in the reference's order (perturbed value
    descending, then id): at W = 1, with all shards in one process, and on
    every spawned world size, against the reference's fused and sharded
    cohorts."""
    got = {}
    for i, (case, (gumbel, _)) in enumerate(zip(CASES, references)):
        inp = port_inputs(case, gumbel)
        got[(1, i)] = run_sharded(inp, one_rank_gloo)[0]
        for world in WORLDS:
            got[(f"in-process {world}", i)] = tss.sharded_score_select_in_process(
                *inp["rows"], world=world, round_idx=T,
                tau=dynamic_temperature(T, SelectorConfig(num_selected=inp["m"])),
                m=inp["m"], gumbel=inp["gumbel"], cfg=HeteRoScoreConfig(),
                staleness_override=inp["stale"])[0]
            got[(world, i)] = spawned[world][0][i][0]
    for (where, i), sel in got.items():
        for name, (ref_sel, _, _) in zip(("fused", "sharded"), references[i][1]):
            assert sel.tolist() == ref_sel.tolist(), f"W={where} {CASE_IDS[i]} vs {name}"
