"""K8, the sharded select, against the reference and the port's fused path.

``sharded_score_select_plain`` runs K1 and K2's plain versions on each
client shard of a gloo process group. World size 1 runs in this process;
world sizes 2, 4 and 8 run in processes spawned with
``torch.multiprocessing`` (a ``file://`` rendezvous), each group joined
under its own timeout so that a hang fails the test. Every rank's cohort
must be the reference's on the same Gumbel row — its fused
``ops.heterosel_topm`` (Pallas in interpret mode) and its
``ops.heterosel_topm_sharded`` on a one-device mesh — with probabilities
within 2e-6 (the reference's own tolerance, ``tests/test_kernels.py``), and
the ranks must agree bitwise. The JAX package is imported inside the tests
only, so the spawned ranks import torch and the port alone.
"""

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


def _rank(rank, world, rendezvous, gumbels, out_dir):
    """One rank of a spawned gloo group: every case through the sharded
    select, results saved for the parent."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            world_size=world, rank=rank)
    try:
        out = [tuple(x.clone() for x in run_sharded(port_inputs(case, g), dist.group.WORLD))
               for case, g in zip(CASES, gumbels)]
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_group(world, tmp_path, gumbels):
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
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]


@pytest.fixture(scope="module")
def references():
    """The reference's Gumbel row, fused and one-device sharded results per
    case (Pallas in interpret mode)."""
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
        kw = dict(interpret=True,
                  staleness_override=jnp.asarray(arrays["stale"]) if override else None)
        fused = jops.heterosel_topm(sj, jnp.int32(T), tau, m, key, JaxCfg(), **kw)
        sharded = jops.heterosel_topm_sharded(sj, jnp.int32(T), tau, m, key, JaxCfg(),
                                              mesh=mesh, **kw)
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


@pytest.mark.parametrize("world", [2, 4, 8])
def test_world_sizes_match_the_reference(world, references, tmp_path):
    per_rank = spawn_group(world, tmp_path, [g for g, _ in references])
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
