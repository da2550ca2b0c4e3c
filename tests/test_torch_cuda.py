"""The port's CUDA kernels (K1–K8) against their plain PyTorch versions, on
the card.

Every test here is marked ``cuda`` and skips when torch sees no device. The
file imports neither JAX nor the reference package, so it also runs where
only the port is installed:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Selected sets are compared exactly; scores and probabilities to 1e-5
relative (K1 sums Σ‖Δw‖² in another order than ``torch.sum``). K5's f32
outputs to 1e-5 relative and 1e-6 absolute, its bf16 outputs within one
bf16 ulp of the plain version's plus the same 1e-6: the kernel and the plain
version sum the scores and p·v in other orders, so their f32 results differ
by up to ~5e-7 where the p·v sum cancels to near 0 (measured on the CPU
against f64), more than one bf16 ulp of such an output; each then rounds
its f32 result to bf16 once. K6 likewise: bf16 outputs within one bf16 ulp
of the plain version's plus 1e-5 of the largest output (the f32 sums of up
to 7168 products differ by summation order, ~1e-4 at these sizes, more than
one bf16 ulp of an output near 0), f32 outputs to 1e-5 relative plus 1e-5
of the largest; the rows that are 0 (padding, rows past the last group) are
the same rows, exactly 0.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.scoring import HeteRoScoreConfig
from repro_torch.core.selection import SelectorConfig, dynamic_temperature, gumbel_noise
from repro_torch.core.state import NEVER
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import score_select as tss

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def random_rows(k, dtype, gen, t):
    dev = gen.device
    has_loss = torch.rand(k, generator=gen, device=dev) > 0.3
    zero = torch.zeros((), device=dev)
    rows = [
        torch.where(has_loss, 4 * torch.rand(k, generator=gen, device=dev), zero),
        torch.where(has_loss, 4 * torch.rand(k, generator=gen, device=dev), zero),
        0.69 * torch.rand(k, generator=gen, device=dev),
        torch.where(has_loss, torch.randint(1, 6, (k,), generator=gen, device=dev), 0),
        torch.where(has_loss, torch.randint(0, t, (k,), generator=gen, device=dev), NEVER),
        torch.where(has_loss, 2 * torch.rand(k, generator=gen, device=dev), zero),
        has_loss.float(),
        (has_loss & (torch.rand(k, generator=gen, device=dev) > 0.5)).float(),
    ]
    return [r.to(torch.int32) if i in (3, 4) else r.to(dtype) for i, r in enumerate(rows)]


@pytest.mark.cuda
@pytest.mark.parametrize("override", [False, True], ids=["counter", "override"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k,m", [(12, 6), (4133, 64), (4133, 1024), (70000, 300)])
def test_cuda_kernels_match_plain(cuda_device, k, m, dtype, override):
    gen = torch.Generator(device=cuda_device).manual_seed(k + m)
    rows = random_rows(k, dtype, gen, t=9)
    stale = 30 * torch.rand(k, generator=gen, device=cuda_device) if override else None
    kw = dict(round_idx=9, tau=dynamic_temperature(9, SelectorConfig()), m=m,
              gumbel=gumbel_noise(gen, k), cfg=HeteRoScoreConfig(),
              staleness_override=stale)
    before = dict(tss.LAUNCHES)
    sel_k, probs_k, scores_k = tss.fused_score_select(*rows, **kw)
    torch.cuda.synchronize()
    assert tss.LAUNCHES["score_stats"] == before["score_stats"] + 1
    assert tss.LAUNCHES["score_select"] == before["score_select"] + 1
    sel_p, probs_p, scores_p = tss.fused_score_select_plain(*rows, **kw)
    assert set(sel_k.tolist()) == set(sel_p.tolist())
    torch.testing.assert_close(scores_k, scores_p, **TOL)
    torch.testing.assert_close(probs_k, probs_p, rtol=1e-5, atol=1e-12)


@pytest.mark.cuda
def test_cuda_candidates_sorted_like_plain(cuda_device):
    """Per-block candidates come out as the plain version lists them: with
    mb = block, every column in column order."""
    k, blk = 256, 64
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    rows = random_rows(k, torch.float32, gen, t=3)
    stacked = tss._pack(rows, None, k, k)
    glob = tss._combine_stats(tss.score_stats_plain(stacked, k=k, block=blk))
    gumbel = torch.zeros(k, device=cuda_device)  # ties wherever scores tie
    kw = dict(k=k, block=blk, t=3.0, tau=1.0, use_ov=False, decay=2.0,
              cfg=HeteRoScoreConfig(), mb=blk)
    got = tss.score_select(stacked, glob, gumbel, **kw)
    want = tss.score_select_plain(stacked, glob, gumbel, **kw)
    torch.testing.assert_close(got[3], want[3], **TOL)
    assert torch.equal(got[4], want[4])


# K2's candidates (a radix select, no sort) against its plain version, bit
# for bit: every m below, cut to the block.
K2_MS = (1, 6, 31, 32, 33, 1000, 2048)
K2_BLOCKS = (32, 64, 128, 256, 512, 1024, 2048)


def assert_k2_candidates_bitwise(stacked, glob, gumbel, *, k, block, use_ov, off=0):
    for mb in sorted({min(m, block) for m in K2_MS}):
        kw = dict(k=k, block=block, off=off, t=9.0, tau=0.95, use_ov=use_ov, decay=2.0,
                  cfg=HeteRoScoreConfig(), mb=mb)
        before = tss.LAUNCHES["score_select"]
        got = tss.score_select(stacked, glob, gumbel, **kw)
        torch.cuda.synchronize()
        assert tss.LAUNCHES["score_select"] == before + 1
        want = tss.score_select_plain(stacked, glob, gumbel, **kw)
        where = f"block {block} mb {mb} off {off}"
        assert torch.equal(got[3].view(torch.int32), want[3].view(torch.int32)), where
        assert torch.equal(got[4], want[4]), where


@pytest.mark.cuda
@pytest.mark.parametrize("override", [False, True], ids=["counter", "override"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("block", K2_BLOCKS)
def test_cuda_k2_candidates_bitwise(cuda_device, block, dtype, override):
    """Three full blocks and a ragged fourth (its tail is padding)."""
    k = 3 * block + block // 2 + 5
    gen = torch.Generator(device=cuda_device).manual_seed(block + 2 * override)
    rows = random_rows(k, dtype, gen, t=9)
    stale = 30 * torch.rand(k, generator=gen, device=cuda_device) if override else None
    blk, _, kpad = tss._layout(k, block)
    assert blk == block
    stacked = tss._pack(rows, stale, k, kpad)
    glob = tss._combine_stats(tss.score_stats_plain(stacked, k=k, block=blk))
    gumbel = torch.nn.functional.pad(gumbel_noise(gen, k), (0, kpad - k))
    assert_k2_candidates_bitwise(stacked, glob, gumbel, k=k, block=blk, use_ov=override)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_k2_candidates_of_equal_keys_and_of_a_shard_past_k(cuda_device, dtype):
    """Every client one state and no noise: each block's keys are all equal
    (the last block's padding equal among itself), so the candidates are
    its first columns. A shard past K is all padding: its first columns."""
    k = 5000
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    rows = [r[:1].expand(k).contiguous() for r in random_rows(k, dtype, gen, t=9)]
    for block in (32, 256, 2048):
        _, _, kpad = tss._layout(k, block)
        stacked = tss._pack(rows, None, k, kpad)
        glob = tss._combine_stats(tss.score_stats_plain(stacked, k=k, block=block))
        gumbel = torch.zeros(kpad, device=cuda_device)
        assert_k2_candidates_bitwise(stacked, glob, gumbel, k=k, block=block, use_ov=False)
    k, world = 384, 8   # shards 3-7 hold no client
    gumbel = gumbel_noise(gen, k)
    rows = random_rows(k, dtype, gen, t=9)
    _, blk, _, _ = tss.shard_layout(k, world)
    for rank in (2, 3, 7):
        stacked, gpad, off, klim = tss.shard_operands(rows, gumbel, None, rank=rank,
                                                      world=world)
        glob = tss._combine_stats(tss.score_stats_plain(stacked, k=klim, block=blk, off=off))
        assert_k2_candidates_bitwise(stacked, glob, gpad, k=klim, block=blk,
                                     use_ov=False, off=off)
        if off >= k:
            want = torch.arange(off, off + blk, dtype=torch.int32, device=cuda_device)
            got = tss.score_select(stacked, glob, gpad, k=klim, block=blk, off=off, t=9.0,
                                   tau=0.95, use_ov=False, decay=2.0,
                                   cfg=HeteRoScoreConfig(), mb=blk)[4]
            assert torch.equal(got[0], want)


@pytest.mark.cuda
def test_cuda_wrapper_refuses_bad_operands(cuda_device):
    k = 40
    stacked = torch.zeros(tss.NROWS, 64, device=cuda_device)
    with pytest.raises(TypeError):
        tss.score_stats(stacked.double(), k=k, block=64)
    with pytest.raises(ValueError):
        tss.score_select(stacked, torch.zeros(4, device=cuda_device),
                         torch.zeros(64), k=k, block=64, t=0.0, tau=1.0,
                         use_ov=False, decay=2.0, cfg=HeteRoScoreConfig(), mb=8)


@pytest.mark.cuda
@pytest.mark.parametrize("override", [False, True], ids=["counter", "override"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [12, 4133, 70000])
def test_cuda_score_probs_matches_plain(cuda_device, k, dtype, override):
    """K1 + K3 against their plain versions."""
    gen = torch.Generator(device=cuda_device).manual_seed(k)
    rows = random_rows(k, dtype, gen, t=9)
    stale = 30 * torch.rand(k, generator=gen, device=cuda_device) if override else None
    kw = dict(round_idx=9, tau=dynamic_temperature(9, SelectorConfig()),
              cfg=HeteRoScoreConfig(), staleness_override=stale)
    before = dict(tss.LAUNCHES)
    probs_k, scores_k = tss.fused_score_probs(*rows, **kw)
    torch.cuda.synchronize()
    assert tss.LAUNCHES["score_probs"] == before["score_probs"] + 1
    assert tss.LAUNCHES["score_select"] == before["score_select"]
    probs_p, scores_p = tss.fused_score_probs_plain(*rows, **kw)
    torch.testing.assert_close(scores_k, scores_p, **TOL)
    torch.testing.assert_close(probs_k, probs_p, rtol=1e-5, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("override", [False, True], ids=["counter", "override"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("sizes,seg", [([5, 128, 60], 128), ([4133], 4133),
                                       ([32] * 32, 32), ([700, 2000, 1, 0], 2013)],
                         ids=["ragged", "E1", "K1024", "odd-seg"])
def test_cuda_segment_probs_matches_plain(cuda_device, sizes, seg, dtype, override):
    """K4 against its plain version; padding slots are exactly 0.0."""
    k = len(sizes) * seg
    gen = torch.Generator(device=cuda_device).manual_seed(k + seg)
    rows = random_rows(k, dtype, gen, t=9)
    stale = 30 * torch.rand(k, generator=gen, device=cuda_device) if override else None
    kw = dict(sizes=sizes, round_idx=9, tau=dynamic_temperature(9, SelectorConfig()),
              cfg=HeteRoScoreConfig(), seg=seg, staleness_override=stale)
    before = tss.LAUNCHES["segment_probs"]
    probs_k, scores_k = tss.segmented_score_probs(*rows, **kw)
    torch.cuda.synchronize()
    assert tss.LAUNCHES["segment_probs"] == before + 1
    probs_p, scores_p = tss.segmented_score_probs_plain(*rows, **kw)
    torch.testing.assert_close(scores_k, scores_p, **TOL)
    torch.testing.assert_close(probs_k, probs_p, rtol=1e-5, atol=1e-12)
    for e, n in enumerate(sizes):
        pad = slice(e * seg + n, (e + 1) * seg)
        assert bool((probs_k[pad] == 0).all()) and bool((scores_k[pad] == 0).all())
        if n:
            assert float(probs_k[e * seg:e * seg + n].sum()) == pytest.approx(1.0, abs=1e-5)


# ---------------------------------------------------------------------------
# K8: K1 and K2 with a shard's offset, and the sharded select
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k,world", [(70000, 4), (5000, 8)])
def test_cuda_offset_kernels_match_plain(cuda_device, k, world, dtype):
    """K1 and K2 on every shard, with its global offset and limit, against
    their plain versions on the same shard: candidate ids exactly."""
    gen = torch.Generator(device=cuda_device).manual_seed(k + world)
    rows = random_rows(k, dtype, gen, t=9)
    gumbel = gumbel_noise(gen, k)
    cfg = HeteRoScoreConfig()
    _, blk, _, _ = tss.shard_layout(k, world)
    for rank in range(world):
        stacked, gpad, off, klim = tss.shard_operands(rows, gumbel, None, rank=rank,
                                                      world=world)
        stats_k = tss.score_stats(stacked, k=klim, block=blk, off=off)
        stats_p = tss.score_stats_plain(stacked, k=klim, block=blk, off=off)
        torch.testing.assert_close(stats_k, stats_p, **TOL)
        glob = tss._combine_stats(stats_p)
        kw = dict(k=klim, block=blk, off=off, t=9.0, tau=0.95, use_ov=False,
                  decay=2.0, cfg=cfg, mb=min(64, blk))
        got = tss.score_select(stacked, glob, gpad, **kw)
        want = tss.score_select_plain(stacked, glob, gpad, **kw)
        for g, w in zip(got[:4], want[:4]):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
        if off < k:   # a shard past K has no candidates to order
            assert torch.equal(got[4], want[4])
            assert int(got[4].min()) >= off


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_sharded_in_process_equals_fused(cuda_device, dtype):
    """W = 4 shards in one process through K1 and K2, merged by the
    collectives' arithmetic: the single-device fused cohort."""
    k, m = 1 << 20, 1024
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    rows = random_rows(k, dtype, gen, t=9)
    kw = dict(round_idx=9, tau=dynamic_temperature(9, SelectorConfig()), m=m,
              gumbel=gumbel_noise(gen, k), cfg=HeteRoScoreConfig())
    sel_s, probs_s, scores_s = tss.sharded_score_select_in_process(*rows, world=4, **kw)
    sel_f, probs_f, scores_f = tss.fused_score_select(*rows, **kw)
    assert set(sel_s.tolist()) == set(sel_f.tolist())
    torch.testing.assert_close(probs_s, probs_f, rtol=1e-5, atol=1e-12)
    torch.testing.assert_close(scores_s, scores_f, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("override", [False, True], ids=["counter", "override"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_sharded_one_rank_nccl_is_fused(cuda_device, tmp_path, dtype, override):
    """K8 on a one-rank NCCL group is K1 + K2 bitwise: cohort, probs, scores."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        assert dist.get_backend() == "nccl"
        k, m = 100_000, 100
        gen = torch.Generator(device=cuda_device).manual_seed(k + override)
        rows = random_rows(k, dtype, gen, t=9)
        stale = 30 * torch.rand(k, generator=gen, device=cuda_device) if override else None
        kw = dict(round_idx=9, tau=dynamic_temperature(9, SelectorConfig()), m=m,
                  gumbel=gumbel_noise(gen, k), cfg=HeteRoScoreConfig(),
                  staleness_override=stale)
        before = dict(tss.LAUNCHES), tss.SHARDED_LAUNCHES["sharded_score_select"]
        got = tss.sharded_score_select(*rows, group=dist.group.WORLD, **kw)
        torch.cuda.synchronize()
        assert tss.SHARDED_LAUNCHES["sharded_score_select"] == before[1] + 1
        assert tss.LAUNCHES["score_stats"] == before[0]["score_stats"] + 1
        assert tss.LAUNCHES["score_select"] == before[0]["score_select"] + 1
        want = tss.fused_score_select(*rows, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        with pytest.raises(ValueError, match="gloo"):
            tss.sharded_score_select(*(r.cpu() for r in rows), group=dist.group.WORLD,
                                     **dict(kw, staleness_override=None))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# K5: flash attention
# ---------------------------------------------------------------------------

# (B, S, T, H, KVH, D, causal, window)
FLASH_CASES = [
    (32, 32, 32, 14, 2, 64, True, 0),      # the LM path's shape (a quarter of its batch)
    (1, 1000, 1000, 14, 2, 64, True, 0),   # T-padding and the ragged edge
    (1, 1000, 1000, 14, 2, 64, True, 256), # sliding window
    (2, 300, 300, 4, 4, 128, False, 0),    # MHA, non-causal
    (1, 100, 100, 2, 1, 256, True, 0),     # the largest head_dim
    (2, 20, 70, 4, 2, 16, False, 0),       # S < T, S smaller than a tile
    (32, 32, 32, 64, 8, 112, True, 0),     # the kimi-k2 share's shape: D 112, a partial chunk
    (1, 300, 300, 64, 8, 112, True, 0),    # D 112 with T-padding
]
FLASH_IDS = ["path", "T1000", "window", "mha", "d256", "cross", "d112-path", "d112-T300"]


def _bf16_ulp(x):
    e = torch.floor(torch.log2(torch.clamp_min(x.abs().float(), 2.0 ** -126)))
    return torch.exp2(e - 7)


def assert_flash_close(got, want):
    if got.dtype == torch.bfloat16:
        gap = (got.float() - want.float()).abs()
        assert bool((gap <= _bf16_ulp(want) + 1e-6).all()), float(gap.max())
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _qkv(case, dtype, dev, seed=0):
    b, s, t, h, kvh, d = case[:6]
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((b, s, h, d), (b, t, kvh, d), (b, t, kvh, d))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=FLASH_IDS)
def test_cuda_flash_attention_matches_plain(cuda_device, case, dtype):
    causal, window = case[6], case[7]
    q, k, v = _qkv(case, dtype, cuda_device)
    before = tfa.LAUNCHES["flash_attention"]
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention"] == before + 1
    o_p, lse_p = tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert o.dtype == dtype and o.shape == q.shape and o.is_contiguous()
    assert_flash_close(o, o_p)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_flash_attention_reads_strided_operands(cuda_device):
    """q, k, v as views with non-default batch, sequence and head strides
    (a packed qkv projection), read in place."""
    b, s, h, kvh, d = 2, 80, 4, 2, 32
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    packed = torch.randn(b, s, h + 2 * kvh, d, generator=gen, device=cuda_device)
    q, k, v = packed[:, :, :h], packed[:, :, h:h + kvh], packed[:, :, h + kvh:]
    assert not q.is_contiguous()
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    o_p, lse_p = tfa.flash_attention_plain(q.contiguous(), k.contiguous(),
                                           v.contiguous(), causal=True)
    assert_flash_close(o, o_p)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5)


# bf16 layouts of K5's wgmma kernel: every head width it pads (to 64, 128
# or 256), groups of 1, 7 and 8 query heads per KV head, S and T ragged
# against the 64-key tiles and the packed query tiles.
@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 7, 8])
@pytest.mark.parametrize("d", [1, 24, 64, 112, 128, 256])
def test_cuda_flash_attention_bf16_head_dims_and_groups(cuda_device, d, g):
    case = (2, 100, 100, 2 * g, 2, d, True, 0)
    q, k, v = _qkv(case, torch.bfloat16, cuda_device, seed=d + g)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    o_p, lse_p = tfa.flash_attention_plain(q, k, v, causal=True)
    assert_flash_close(o, o_p)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5)


# (B, S, T, H, KVH, D, causal, window): S ≠ T both ways, ragged against every
# tile; the sliding window with grouped heads of 64 and 112.
FLASH_BF16_CASES = [
    (2, 70, 130, 14, 2, 64, False, 0),
    (2, 130, 70, 14, 2, 64, True, 0),
    (1, 77, 301, 16, 2, 112, False, 0),
    (1, 700, 700, 14, 2, 64, True, 256),
    (1, 600, 600, 64, 8, 112, True, 256),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_BF16_CASES,
                         ids=["s<t", "s>t-causal", "s<t-d112", "window-d64", "window-d112"])
def test_cuda_flash_attention_bf16_lengths_and_window(cuda_device, case):
    causal, window = case[6], case[7]
    q, k, v = _qkv(case, torch.bfloat16, cuda_device, seed=7)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    o_p, lse_p = tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert_flash_close(o, o_p)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_flash_attention_bf16_unaligned_strides(cuda_device):
    """bf16 q, k, v as views of a packed projection whose row stride (5 heads
    of 36: 360 bytes) and head offsets are not 16-byte aligned: the kernel
    copies them with ordinary loads instead of TMA, in the same launch."""
    b, s, h, kvh, d = 2, 90, 3, 1, 36
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    packed = torch.randn(b, s, h + 2 * kvh, d, generator=gen, device=cuda_device)
    packed = packed.to(torch.bfloat16)
    q, k, v = packed[:, :, :h], packed[:, :, h:h + kvh], packed[:, :, h + kvh:]
    assert (k.stride(1) * 2) % 16 and (k.data_ptr() % 16)
    before = tfa.LAUNCHES["flash_attention"]
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    assert tfa.LAUNCHES["flash_attention"] == before + 1
    o_p, lse_p = tfa.flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                                           causal=True)
    assert_flash_close(o, o_p)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5)


def _attention_loss_f64(q, k, v, w):
    """Σ attention(q, k, v)·w in f64 by the definition (causal, GQA by
    repeating the KV heads), over a leading client axis."""
    g = q.shape[3] // k.shape[3]
    kk, vv = k.repeat_interleave(g, dim=3), v.repeat_interleave(g, dim=3)
    sc = torch.einsum("nbshd,nbthd->nbhst", q, kk) / q.shape[-1] ** 0.5
    s, t = q.shape[2], k.shape[2]
    causal = torch.arange(t)[None, :] <= torch.arange(s)[:, None]
    p = torch.softmax(torch.where(causal, sc, -torch.inf), dim=-1)
    return (torch.einsum("nbhst,nbthd->nbshd", p, vv) * w).sum()


def _over(got, want, rtol=1e-5, atol=1e-5):
    return (got - want).abs() > atol + rtol * want.abs()


def _cpu_reference(fn, *args):
    """``fn`` on CPU copies of ``args``, on the default intra-op threads
    (``tests/test_torch_flash_threads.py`` holds the CPU path's first
    multi-threaded call to its one-thread result)."""
    return fn(*(a.cpu() for a in args))


def _vmap_grad_report(q, k, v, w, got, want, grad, saved, kvh):
    """What the (client, batch, KV head) groups of a vmap∘grad mismatch look
    like: which gradients and groups are over the tolerance, each side
    against an f64 reference, each side recomputed, the saved forward
    against a fresh one, and the process state that could move a result."""
    lines = []
    qc, kc, vc, wc = (x.cpu() for x in (q, k, v, w))
    q64, k64, v64 = (x.double().requires_grad_() for x in (qc, kc, vc))
    ref = torch.autograd.grad(_attention_loss_f64(q64, k64, v64, wc.double()),
                              (q64, k64, v64))
    want2 = _cpu_reference(grad, qc, kc, vc, wc)
    want_mt = grad(qc, kc, vc, wc)
    got2 = grad(q, k, v, w)
    for name, g, g2, r, r2, r_mt, f in zip("qkv", got, got2, want, want2, want_mt, ref):
        g, g2 = g.cpu(), g2.cpu()
        bad = _over(g, r)
        # (client, batch, KV head) of every entry: dq is (n, B, S, H, D).
        heads = bad.any(2).any(-1)
        groups = (heads.reshape(*heads.shape[:2], kvh, -1).any(-1) if name == "q"
                  else heads)
        where = [tuple(i) for i in groups.nonzero().tolist()]
        lines.append(f"d{name}: {int(bad.sum())} of {bad.numel()} over the tolerance "
                     f"in (client, batch, kv head) groups {where[:8]}")
        for label, x in (("card", g), ("card again", g2), ("cpu", r),
                         ("cpu again", r2), ("cpu threads", r_mt)):
            err = (x.double() - f).abs()
            lines.append(f"  {label:12s} vs f64: max {float(err.max()):.3e}, in the bad "
                         f"entries {float(err[bad].max()) if bad.any() else 0.0:.3e}")
        lines.append(f"  card == card again: {torch.equal(g, g2)}; cpu == cpu again: "
                     f"{torch.equal(r, r2)}; cpu == cpu on {torch.get_num_threads()} "
                     f"threads: {torch.equal(r, r_mt)}")
    o, lse = saved[0]
    fold = lambda x: x.reshape(-1, *x.shape[2:])
    o2, lse2 = tfa.flash_attention_fwd(fold(q), fold(k), fold(v), causal=True)
    op, lsep = tfa.flash_attention_plain(fold(qc), fold(kc), fold(vc), causal=True)
    lines.append(f"saved o == fresh forward: {torch.equal(o, o2)}, lse: "
                 f"{torch.equal(lse, lse2)}; saved vs plain on the cpu: o "
                 f"{float((o.cpu() - op).abs().max()):.3e}, lse "
                 f"{float((lse.cpu() - lsep).abs().max()):.3e}")
    lines.append(f"state: matmul allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, "
                 f"float32_matmul_precision {torch.get_float32_matmul_precision()}, "
                 f"cudnn allow_tf32 {torch.backends.cudnn.allow_tf32}, threads "
                 f"{torch.get_num_threads()}, deterministic "
                 f"{torch.are_deterministic_algorithms_enabled()}, library "
                 f"{tfa._library()._name}")
    return "\n".join(lines)


@pytest.mark.cuda
def test_cuda_flash_attention_vmap_grad_is_one_launch(cuda_device, monkeypatch):
    """vmap∘grad over a client axis on the card: one forward launch for the
    whole cohort (the vmap rule folds the clients into the batch), none in
    the backward, and the gradients of the CPU path on the same inputs
    (``_cpu_reference``). On a mismatch the message says which side moved
    (``_vmap_grad_report``)."""
    n, case = 4, (8, 32, 32, 14, 2, 64, True, 0)
    q, k, v = (x.unsqueeze(0).expand(n, *x.shape).contiguous()
               for x in _qkv(case, torch.float32, cuda_device, seed=2))
    w = torch.randn(q.shape, generator=torch.Generator(device=cuda_device).manual_seed(3),
                    device=cuda_device)

    def loss(q, k, v, w):
        return (ops.flash_mha(q, k, v, causal=True) * w).sum()

    saved = []
    fwd = tfa.flash_attention_fwd

    def recording_fwd(*args, **kwargs):
        out = fwd(*args, **kwargs)
        if args[0].is_cuda:
            saved.append(out)
        return out

    monkeypatch.setattr(tfa, "flash_attention_fwd", recording_fwd)
    grad = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))
    before = tfa.LAUNCHES["flash_attention"]
    got = grad(q, k, v, w)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention"] == before + 1
    want = _cpu_reference(grad, q, k, v, w)
    report = ""
    if any(bool(_over(g.cpu(), r).any()) for g, r in zip(got, want)):
        report = _vmap_grad_report(q, k, v, w, got, want, grad, saved, case[4])
    print("worst error / tolerance " + ", ".join(
        f"d{name} {float(((g.cpu() - r).abs() / (1e-5 + 1e-5 * r.abs())).max()):.3f}"
        for name, g, r in zip("qkv", got, want)))
    for g, r in zip(got, want):
        torch.testing.assert_close(g.cpu(), r, rtol=1e-5, atol=1e-5,
                                   msg=lambda m: f"{m}\n{report}")


@pytest.mark.cuda
def test_cuda_flash_attention_vmap_grad_over_many_draws(cuda_device):
    """The check above over 50 draws of q, k, v and the weights, each with
    its own seed. Each card gradient is computed twice and the two must be
    bitwise equal (no race, no dependence on the order CTAs or GEMM tiles
    run in); each must agree with the CPU path to the tolerance above. All
    draws run before the verdict, and the message lists every failing one
    with its largest error and its position."""
    n, case = 4, (8, 32, 32, 14, 2, 64, True, 0)

    def loss(q, k, v, w):
        return (ops.flash_mha(q, k, v, causal=True) * w).sum()

    grad = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))
    failures, worst = [], 0.0
    for draw in range(50):
        q, k, v = (x.unsqueeze(0).expand(n, *x.shape).contiguous()
                   for x in _qkv(case, torch.float32, cuda_device, seed=100 + draw))
        gen = torch.Generator(device=cuda_device).manual_seed(1000 + draw)
        w = torch.randn(q.shape, generator=gen, device=cuda_device)
        got, again = grad(q, k, v, w), grad(q, k, v, w)
        want = _cpu_reference(grad, q, k, v, w)
        for name, g, g2, r in zip("qkv", got, again, want):
            if not torch.equal(g, g2):
                diff = (g - g2).abs()
                failures.append(f"draw {draw} d{name}: two card runs differ, max "
                                f"{float(diff.max()):.3e} at flat index {int(diff.argmax())}")
            err = (g.cpu() - r).abs()
            ratio = err / (1e-5 + 1e-5 * r.abs())
            worst = max(worst, float(ratio.max()))
            if bool((ratio > 1).any()):
                i = int(ratio.argmax())
                failures.append(f"draw {draw} d{name}: |card - cpu| {float(err.flatten()[i]):.3e} "
                                f"at flat index {i} (cpu value {float(r.flatten()[i]):.6e}), "
                                f"{int((ratio > 1).sum())} entries over the tolerance")
    assert not failures, "\n".join(failures) + f"\nworst error / tolerance {worst:.3f}"
    print(f"vmap∘grad over 50 draws: worst error / tolerance {worst:.3f}")


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_bad_operands(cuda_device):
    q = torch.randn(1, 8, 4, 16, device=cuda_device)
    k = torch.randn(1, 8, 2, 16, device=cuda_device)
    with pytest.raises(ValueError, match="one device"):
        tfa.flash_attention_fwd(q, k.cpu(), k, causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_fwd(q, k.transpose(1, 3).contiguous().transpose(1, 3), k,
                                causal=True)


# ---------------------------------------------------------------------------
# K7 (SSD chunk)
# ---------------------------------------------------------------------------

# (B, S, CL, NH, HP, N): chip_smoke.py's cases: the mamba2 path's shape, S not
# a multiple of CL (a padded chunk), the CPU tests' smoke shape, a 4096-token
# prompt of 16 chunks, CL 100 (not a multiple of the kernel's 16- or 64-row
# tiles) over three chunks, and HP 128 with N 256 (the largest the kernel
# takes).
SSD_CASES = [(32, 256, 256, 32, 64, 128), (3, 300, 128, 5, 64, 128), (8, 32, 32, 16, 32, 16),
             (1, 4096, 256, 32, 64, 128), (4, 250, 100, 8, 64, 128), (2, 512, 256, 4, 128, 256)]
SSD_IDS = ["path", "ragged", "smoke", "prefill4096", "cl100", "hp128-n256"]


def _ssd_inputs(bsz, s, nh, hp, n, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    return (r(bsz, s, nh, hp), torch.nn.functional.softplus(-2.0 + 0.5 * r(bsz, s, nh)),
            -torch.exp(0.3 * r(nh)), r(bsz, s, n), r(bsz, s, n))


def _close_to_max(got, want, rtol=1e-5):
    """K7 against its plain version: rtol 1e-5 plus 1e-5 of the largest
    entry; the two sum C·Bᵀ, W·x and the state in other orders (cuBLAS
    GEMMs in the plain version; 3×TF32 products on the tensor cores, each
    within ~2^-21 of the f32 product, in the kernel) and share cum (both
    sum it in f64)."""
    torch.testing.assert_close(got, want, rtol=rtol, atol=rtol * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES, ids=SSD_IDS)
def test_cuda_ssd_chunk_matches_plain(cuda_device, case):
    from repro_torch.kernels import ssd_scan as tssd

    bsz, s, cl, nh, hp, n = case
    x, dt, a, b, c = _ssd_inputs(bsz, s, nh, hp, n, cuda_device)
    xc, dtc, bc, cc = tssd.to_chunks(x, dt, b, c, cl)
    before = tssd.LAUNCHES["ssd_chunk"]
    got = tssd.ssd_chunk(xc, dtc, a.expand(bsz, nh), bc, cc)
    torch.cuda.synchronize()
    assert tssd.LAUNCHES["ssd_chunk"] == before + 1
    want = tssd.ssd_chunk_plain(xc, dtc, a.expand(bsz, nh), bc, cc)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_contiguous()
        _close_to_max(g, w)


@pytest.mark.cuda
def test_cuda_ssd_chunk_reads_strided_operands(cuda_device):
    """b and c as the two halves of one (B, NC, CL, 2N) tensor (the model's
    split of the B‖C conv output), dt and a_neg with non-default strides:
    read in place."""
    from repro_torch.kernels import ssd_scan as tssd

    bsz, nc, cl, nh, hp, n = 2, 2, 64, 4, 32, 16
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    r = lambda *shape: torch.randn(shape, generator=gen, device=cuda_device)
    x = r(bsz, nc, cl, nh, hp)
    dt = torch.nn.functional.softplus(-2.0 + r(bsz, nc, nh, cl)).transpose(2, 3)
    a = (-torch.exp(r(nh))).expand(bsz, nh)
    b, c = torch.split(r(bsz, nc, cl, 2 * n), n, dim=-1)
    assert not b.is_contiguous() and not dt.is_contiguous() and a.stride(0) == 0
    got = tssd.ssd_chunk(x, dt, a, b, c)
    want = tssd.ssd_chunk_plain(x, dt.contiguous(), a.contiguous(), b.contiguous(),
                                c.contiguous())
    for g, w in zip(got, want):
        _close_to_max(g, w)


# (CL, HP, N) over every pairing of the kernel's row-tile and template
# cases: CL 100 is neither a multiple of the 16-row mma tile nor of the
# 64-row CTA tile; HP 32, 64, 128 are the three accumulator sizes; N 16 to
# 256 one to two state slices. Two batch rows of three chunks, the last one
# padded, so every call has NC > 1.
SSD_SHAPES = [(cl, hp, n) for cl in (32, 100, 128, 256) for hp in (32, 64, 128)
              for n in (16, 64, 128, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("cl,hp,n", SSD_SHAPES, ids=[f"cl{c}-hp{h}-n{m}" for c, h, m in SSD_SHAPES])
def test_cuda_ssd_chunk_shapes(cuda_device, cl, hp, n):
    """K7 against its plain version at every (CL, HP, N) pairing, and its
    cum_last bitwise equal to ``chunk_cumsum`` (the cross-chunk correction
    and the backward recompute cum with it)."""
    from repro_torch.kernels import ssd_scan as tssd

    bsz, nh = 2, 3
    x, dt, a, b, c = _ssd_inputs(bsz, 3 * cl - cl // 3, nh, hp, n, cuda_device, seed=cl + hp + n)
    xc, dtc, bc, cc = tssd.to_chunks(x, dt, b, c, cl)
    assert xc.shape[1] == 3
    a2 = a.expand(bsz, nh)
    got = tssd.ssd_chunk(xc, dtc, a2, bc, cc)
    want = tssd.ssd_chunk_plain(xc, dtc, a2, bc, cc)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        _close_to_max(g, w)
    assert torch.equal(got[2], tssd.chunk_cumsum(dtc * a2[:, None, None, :])[:, :, -1])


@pytest.mark.cuda
def test_cuda_ssd_chunk_vmap_folds_unaligned_operands(cuda_device):
    """Under vmap, x vmapped over its second axis (the fold copies it), b and
    c sliced out of one (…, 2N + 1) tensor (odd row stride, bases not
    16-byte aligned) and HP 30: the kernel reads them in 4-byte pieces into
    the same layout and equals the plain version client by client."""
    from repro_torch.kernels import ssd_scan as tssd

    n_clients, bsz, nc, cl, nh, hp, n = 3, 2, 2, 100, 3, 30, 20
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    r = lambda *shape: torch.randn(shape, generator=gen, device=cuda_device)
    x = r(bsz, n_clients, nc, cl, nh, hp + 1)[..., :hp]
    dt = torch.nn.functional.softplus(-2.0 + 0.5 * r(n_clients, bsz, nc, cl, nh))
    a = -torch.exp(0.3 * r(n_clients, bsz, nh))
    bc_in = r(n_clients, bsz, nc, cl, 2 * n + 1)
    b, c = bc_in[..., 1:n + 1], bc_in[..., n + 1:]
    assert b.stride(-2) % 4 and b.storage_offset() % 4 and c.storage_offset() % 4
    before = tssd.LAUNCHES["ssd_chunk"]
    got = torch.func.vmap(tssd.SSDChunk.apply, in_dims=(1, 0, 0, 0, 0))(x, dt, a, b, c)
    torch.cuda.synchronize()
    assert tssd.LAUNCHES["ssd_chunk"] == before + 1
    for k in range(n_clients):
        want = tssd.ssd_chunk_plain(x[:, k].contiguous(), dt[k], a[k], b[k].contiguous(),
                                    c[k].contiguous())
        for g, w in zip(got, want):
            _close_to_max(g[k], w)


@pytest.mark.cuda
def test_cuda_ssd_large_decay_spread_stays_finite(cuda_device):
    """dt = 2, A = −1 over one 256-row chunk: a log-decay spread of 512, far
    past the ~88 at which exp of an unmasked exponent overflows. The kernel
    masks before the exponential: finite, equal to its plain version and,
    through ``ops.ssd_forward``, to the exact recurrence."""
    from repro_torch.kernels import ssd_scan as tssd

    bsz, s, nh, hp, n = 2, 256, 2, 32, 16
    x, _, _, b, c = _ssd_inputs(bsz, s, nh, hp, n, cuda_device, seed=9)
    dt = torch.full((bsz, s, nh), 2.0, device=cuda_device)
    a = torch.full((nh,), -1.0, device=cuda_device)
    xc, dtc, bc, cc = tssd.to_chunks(x, dt, b, c, s)
    got = tssd.ssd_chunk(xc, dtc, a.expand(bsz, nh), bc, cc)
    want = tssd.ssd_chunk_plain(xc, dtc, a.expand(bsz, nh), bc, cc)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        _close_to_max(g, w)
    y, h = ops.ssd_forward(x, dt, a, b, c, chunk=s)
    ry, rh = tssd.ssd_recurrence(x, dt, a, b, c)
    _close_to_max(y, ry, rtol=1e-4)
    _close_to_max(h, rh, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_ssd_chunk_error_against_f64_at_the_path(cuda_device):
    """At the mamba2 path's shape: the kernel's largest error against the
    plain version in f64, beside the f32 plain version's own (printed as one
    JSON line). The gate stays the kernel against the f32 plain version."""
    import json

    from repro_torch.kernels import ssd_scan as tssd

    bsz, s, nh, hp, n = SSD_CASES[0][0], SSD_CASES[0][1], SSD_CASES[0][3], SSD_CASES[0][4], \
        SSD_CASES[0][5]
    x, dt, a, b, c = _ssd_inputs(bsz, s, nh, hp, n, cuda_device, seed=1)
    xc, dtc, bc, cc = tssd.to_chunks(x, dt, b, c, s)
    args = (xc, dtc, a.expand(bsz, nh), bc, cc)
    got = tssd.ssd_chunk(*args)
    plain = tssd.ssd_chunk_plain(*args)
    exact = tssd.ssd_chunk_plain(*(t.double() for t in args))
    report = {}
    for name, g, p, e in zip(("y_intra", "states", "cum_last"), got, plain, exact):
        _close_to_max(g, p)
        report[name] = {"kernel_vs_f64": float((g.double() - e).abs().max()),
                        "plain_f32_vs_f64": float((p.double() - e).abs().max()),
                        "max_abs": float(e.abs().max())}
    print("K7 f64 " + json.dumps(report))


@pytest.mark.cuda
def test_cuda_ssd_vmap_grad_is_one_launch_and_none_in_backward(cuda_device):
    """vmap∘grad over 4 clients, each with its own a_neg, on the card: one
    K7 launch for the whole cohort's forward, none in the backward, and the
    gradients of the CPU path on the same inputs."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as tssd

    n_clients, bsz, s, nh, hp, n = 4, 2, 96, 4, 16, 16
    x, dt, _, b, c = _ssd_inputs(n_clients * bsz, s, nh, hp, n, cuda_device, seed=2)
    split = lambda u: u.reshape(n_clients, bsz, *u.shape[1:])
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    a = -torch.exp(0.3 * torch.randn(n_clients, nh, generator=gen, device=cuda_device))
    w = torch.randn(n_clients, bsz, s, nh, hp, generator=gen, device=cuda_device)

    def loss(x, dt, a, b, c, w):
        y, h = ops.ssd_forward(x, dt, a, b, c, chunk=32)
        return (y * w).sum() + h.sum()

    grad = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2, 3, 4)))
    args = (split(x), split(dt), a, split(b), split(c), w)
    launches = []
    bwd = tssd.ssd_chunk_bwd

    def counting_bwd(*t):
        launches.append(tssd.LAUNCHES["ssd_chunk"])
        return bwd(*t)

    tssd.ssd_chunk_bwd = counting_bwd
    try:
        before = tssd.LAUNCHES["ssd_chunk"]
        got = grad(*args)
        torch.cuda.synchronize()
        after = tssd.LAUNCHES["ssd_chunk"]
    finally:
        tssd.ssd_chunk_bwd = bwd
    assert after == before + 1 and launches == [after]   # the backward launched none
    want = grad(*(u.cpu() for u in args))
    for name, g, r in zip(("x", "dt", "a_neg", "b", "c"), got, want):
        torch.testing.assert_close(g.cpu(), r, rtol=1e-5, atol=1e-5 * float(r.abs().max()),
                                   msg=name)


@pytest.mark.cuda
def test_cuda_ssd_chunk_refuses_bad_operands(cuda_device):
    from repro_torch.kernels import ssd_scan as tssd

    x, dt, a, b, c = _ssd_inputs(2, 32, 2, 8, 8, cuda_device)
    xc, dtc, bc, cc = tssd.to_chunks(x, dt, b, c, 32)
    a2 = a.expand(2, 2)
    with pytest.raises(ValueError, match="one device"):
        tssd.ssd_chunk(xc, dtc, a2.cpu(), bc, cc)
    with pytest.raises(ValueError, match="contiguous"):
        tssd.ssd_chunk(xc, dtc, a2, bc.transpose(2, 3).contiguous().transpose(2, 3), cc)
    with pytest.raises(ValueError, match="float32"):
        tssd.ssd_chunk(xc.to(torch.bfloat16), dtc, a2, bc, cc)


# ---------------------------------------------------------------------------
# K6: grouped matmul
# ---------------------------------------------------------------------------

# (clients, rows, K, N, groups, sizes, block_m, shared rhs, transposed rhs).
# "path-*" are the federated kimi-k2 share's launches: 4 clients x 8 experts
# folded, ~5 of 2048 pair rows per (client, expert), the rest past the last
# group; "down-dx" is the backward's dX through a transposed view.
_PATH = [5, 6, 4, 7, 3, 5, 6, 7, 0, 9, 5, 5, 4, 6, 3, 2, 6, 6, 6, 6, 6, 6, 6, 6,
         1, 0, 0, 40, 2, 3, 4, 5]
GMM_CASES = [
    (4, 2048, 7168, 2048, 8, _PATH, 128, False, False),
    (4, 2048, 2048, 7168, 8, _PATH, 128, True, False),
    (4, 2048, 7168, 2048, 8, _PATH, 128, False, True),
    (1, 8192, 256, 384, 8, [1024] * 8, 128, False, False),
    (1, 300, 72, 40, 4, [0, 300, 0, 0], 16, False, False),
    (2, 100, 40, 24, 3, [40, 0, 50, 0, 0, 0], 8, False, False),
]
GMM_IDS = ["path-gate", "path-down-shared", "down-dx", "eval-all-rows", "one-group",
           "ragged-past-last"]


def _gmm_operands(case, dtype, dev, seed=0):
    c, r, k, n, g, sizes, _, shared, trans = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = torch.randn(c * r, k, generator=gen, device=dev).to(dtype)
    if trans:
        rhs = torch.randn(c, g, n, k, generator=gen, device=dev).to(dtype).transpose(-1, -2)
    else:
        rhs = torch.randn(c, g, k, n, generator=gen, device=dev).to(dtype)
    if shared:
        rhs = rhs[0]
    return xs, rhs, torch.tensor(sizes, dtype=torch.int32, device=dev).reshape(c, g)


def assert_gmm_close(got, want):
    assert torch.equal((got == 0).all(1), (want == 0).all(1))
    top = float(want.float().abs().max())
    if got.dtype == torch.bfloat16:
        gap = (got.float() - want.float()).abs()
        assert bool((gap <= _bf16_ulp(want) + 1e-5 * top).all()), float(gap.max())
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * top)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", GMM_CASES, ids=GMM_IDS)
def test_cuda_grouped_matmul_matches_plain(cuda_device, case, dtype):
    from repro_torch.kernels import moe_gmm as tgmm

    xs, rhs, sizes = _gmm_operands(case, dtype, cuda_device)
    c, r, bm = case[0], case[1], case[6]
    before = tgmm.LAUNCHES["grouped_matmul"]
    got = tgmm.grouped_matmul_fwd(xs, rhs, sizes, block_m=bm)
    torch.cuda.synchronize()
    assert tgmm.LAUNCHES["grouped_matmul"] == before + 1
    want = torch.cat([tgmm.gmm_plain(xs[i * r:(i + 1) * r], rhs if rhs.dim() == 3 else rhs[i],
                                     sizes[i], block_m=bm) for i in range(c)])
    assert got.dtype == dtype and got.shape == want.shape
    assert_gmm_close(got, want)


# bf16 layouts of K6's TMA kernel, each over sizes with an empty group, a
# group longer than one block (block_m 32) and rows past the last group:
# per-client, shared and transposed (the dX view) weights, a transposed view
# of shared weights, weights with no contiguous dimension, and xs whose row
# stride is not 16-byte aligned (the last two copied by the producer warp).
GMM_LAYOUTS = ["client", "shared", "transposed", "transposed-shared", "strided", "xs-strided"]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", GMM_LAYOUTS)
def test_cuda_grouped_matmul_bf16_layouts(cuda_device, layout):
    from repro_torch.kernels import moe_gmm as tgmm

    c, r, k, n, g, bm = 2, 200, 200, 136, 3, 32
    sizes = torch.tensor([[0, 75, 90], [120, 0, 1]], dtype=torch.int32, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    bf = lambda *shape: torch.randn(*shape, generator=gen, device=cuda_device).to(torch.bfloat16)
    xs = bf(c * r, k)
    if layout == "xs-strided":
        xs = bf(c * r, k + 3)[:, 1:k + 1]
        assert (xs.stride(0) * 2) % 16
    if layout.startswith("transposed"):
        rhs = bf(c, g, n, k).transpose(-1, -2)
    elif layout == "strided":
        rhs = bf(c, g, 2 * k, 2 * n)[:, :, ::2, ::2]
    else:
        rhs = bf(c, g, k, n)
    if layout in ("shared", "transposed-shared"):
        rhs = rhs[0]
    before = tgmm.LAUNCHES["grouped_matmul"]
    got = tgmm.grouped_matmul_fwd(xs, rhs, sizes, block_m=bm)
    torch.cuda.synchronize()
    assert tgmm.LAUNCHES["grouped_matmul"] == before + 1
    want = tgmm.gmm_plain_clients(xs, rhs, sizes, block_m=bm)
    assert_gmm_close(got, want)
    assert bool((got[r + 121:] == 0).all())   # client 1's rows past its last group


@pytest.mark.cuda
def test_cuda_grouped_matmul_vmap_grad_is_one_launch_each_way(cuda_device):
    """vmap∘grad over 4 clients on the card: one K6 launch for the cohort's
    forward and one for its dX, and the gradients of the CPU path."""
    from repro_torch.kernels import moe_gmm as tgmm

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    c, m, k, n, g = 4, 96, 64, 48, 3
    xs = torch.randn(c, m, k, generator=gen, device=cuda_device)
    rhs = torch.randn(c, g, k, n, generator=gen, device=cuda_device)
    w = torch.randn(c, m, n, generator=gen, device=cuda_device)
    sizes = torch.tensor([[30, 30, 36], [0, 90, 0], [10, 0, 20], [96, 0, 0]],
                         dtype=torch.int32, device=cuda_device)

    def loss(x, r, s, w):
        return (ops.grouped_matmul(x, r, s, block_m=16) * w).sum()

    grad = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)))
    before = tgmm.LAUNCHES["grouped_matmul"]
    got = grad(xs, rhs, sizes, w)
    torch.cuda.synchronize()
    assert tgmm.LAUNCHES["grouped_matmul"] == before + 2
    want = grad(xs.cpu(), rhs.cpu(), sizes.cpu(), w.cpu())
    for name, a, b in zip(("dx", "drhs"), got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5 * float(b.abs().max()),
                                   msg=name)


@pytest.mark.cuda
def test_cuda_grouped_matmul_refuses_bad_operands(cuda_device):
    from repro_torch.kernels import moe_gmm as tgmm

    xs = torch.zeros(16, 8, device=cuda_device)
    rhs = torch.zeros(2, 8, 4, device=cuda_device)
    sizes = torch.tensor([8, 8], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="one device"):
        tgmm.grouped_matmul_fwd(xs, rhs, sizes.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        tgmm.gmm_cuda(torch.zeros(8, 16, device=cuda_device).t(), rhs, sizes)
    with pytest.raises(ValueError, match="float32 or both bfloat16"):
        tgmm.grouped_matmul_fwd(xs.to(torch.float16), rhs.to(torch.float16), sizes)


# ---------------------------------------------------------------------------
# The hybrid, encoder and vlm paths: K5 and K7 at their shapes, and the
# hybrid on the card against the CPU port
# ---------------------------------------------------------------------------

# (B, S, T, H, KVH, D, causal, window): chip_smoke.py's new K5 cases: the
# zamba2 path (a cohort of 4 clients × batch 4 at seq 256, 32 MHA heads of
# 112), the vlm's cross-attention over 1 601 vision keys (25 full 64-key
# tiles and one of 1) at 4 096 queries and at 32 (S < T), and hubert-xlarge
# (16 MHA heads of 80, zero-padded to 128 in the kernel's shared memory).
PATH_FLASH_CASES = [
    (16, 256, 256, 32, 32, 112, True, 0),
    (1, 4096, 1601, 64, 8, 128, False, 0),
    (1, 32, 1601, 64, 8, 128, False, 0),
    (2, 4096, 4096, 16, 16, 80, False, 0),
]
PATH_FLASH_IDS = ["zamba-path", "vlm-cross", "vlm-cross-s32", "hubert"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", PATH_FLASH_CASES, ids=PATH_FLASH_IDS)
def test_cuda_flash_attention_matches_plain_at_the_new_paths(cuda_device, case, dtype):
    causal, window = case[6], case[7]
    q, k, v = _qkv(case, dtype, cuda_device, seed=3)
    before = tfa.LAUNCHES["flash_attention"]
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention"] == before + 1
    o_p, lse_p = tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert o.dtype == dtype and o.shape == q.shape
    assert_flash_close(o, o_p)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_ssd_chunk_matches_plain_at_the_zamba_path(cuda_device):
    """K7 at the zamba2 path's shape: B 16 (4 clients × batch 4), one
    256-row chunk, 112 heads of 64, state N 64."""
    from repro_torch.kernels import ssd_scan as tssd

    bsz, s, cl, nh, hp, n = 16, 256, 256, 112, 64, 64
    x, dt, a, b, c = _ssd_inputs(bsz, s, nh, hp, n, cuda_device, seed=4)
    xc, dtc, bc, cc = tssd.to_chunks(x, dt, b, c, cl)
    before = tssd.LAUNCHES["ssd_chunk"]
    got = tssd.ssd_chunk(xc, dtc, a.expand(bsz, nh), bc, cc)
    torch.cuda.synchronize()
    assert tssd.LAUNCHES["ssd_chunk"] == before + 1
    want = tssd.ssd_chunk_plain(xc, dtc, a.expand(bsz, nh), bc, cc)
    for g, w in zip(got, want):
        _close_to_max(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_hybrid_forward_and_gradient_match_the_cpu_port(cuda_device, dtype, monkeypatch):
    """The zamba2 smoke variant (2 layers: a Mamba2 layer through K7, the
    shared block through K5) on the card against the same model on the CPU
    (the plain versions), on the same seeded weights and tokens. Every dtype
    f32 (``DEFAULT_DTYPE`` patched in hybrid and mamba2): logits within 1e-4
    of the largest, loss rtol 1e-5, gradients within 1e-4 of each leaf's
    largest entry (K7's 3xTF32 products err ~1e-4 relative against f64, as
    the f32 plain version does). bf16: logits within 4 bf16 ulp of the
    largest, loss rtol 1e-3, gradients within 3 % of each leaf's largest."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.kernels import ssd_scan as tssd
    from repro_torch.models import build_model, hybrid, mamba2

    if dtype == torch.float32:
        for module in (hybrid, mamba2):
            monkeypatch.setattr(module, "DEFAULT_DTYPE", torch.float32)
    model = build_model(smoke_variant(get_config("zamba2-7b")))
    params = model.init_params(torch.Generator().manual_seed(0))
    if dtype == torch.float32:
        params = {k: v.float() for k, v in params.items()}
    toks = torch.randint(0, model.cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": toks}
    on_card = {k: v.to(cuda_device) for k, v in params.items()}
    batch_card = {k: v.to(cuda_device) for k, v in batch.items()}
    before = (tfa.LAUNCHES["flash_attention"], tssd.LAUNCHES["ssd_chunk"])
    logits = model.forward(on_card, batch_card)
    loss, grads = torch.func.grad_and_value(model.loss)(on_card, batch_card)[::-1]
    torch.cuda.synchronize()
    # Forward and the loss's forward: one K5 and one K7 launch each.
    assert (tfa.LAUNCHES["flash_attention"], tssd.LAUNCHES["ssd_chunk"]) == \
        (before[0] + 2, before[1] + 2)
    want_logits = model.forward(params, batch)
    want_loss, want_grads = torch.func.grad_and_value(model.loss)(params, batch)[::-1]
    top = float(want_logits.float().abs().max())
    gap = float((logits.cpu().float() - want_logits.float()).abs().max())
    if dtype == torch.float32:
        assert gap <= 1e-4 * top, gap
        torch.testing.assert_close(float(loss), float(want_loss), rtol=1e-5, atol=0)
        frac = 1e-4
    else:
        assert gap <= 4 * float(_bf16_ulp(torch.tensor(top))), gap
        torch.testing.assert_close(float(loss), float(want_loss), rtol=1e-3, atol=0)
        frac = 0.03
    for name, g in grads.items():
        w = want_grads[name].float()
        assert float((g.cpu().float() - w).abs().max()) <= frac * float(w.abs().max()), name


@pytest.mark.cuda
@pytest.mark.parametrize("compact", [False, True], ids=["f32state", "bf16state"])
def test_cuda_async_rounds_feed_the_clock_staleness_to_k1_k2(cuda_device, compact):
    """Flat async rounds under heterosel_pallas on the card: each dispatch
    equals the plain versions' selection on the same state, the same clock
    override (rounded to bf16 with a compact state, as the kernel reads it)
    and the same draws, minus the clients in flight; K1 and K2 each launch
    once a round with the override on."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import FedConfig, get_config, smoke_variant
    from repro_torch.core.state import score_inputs
    from repro_torch.data import make_vision_data
    from repro_torch.fed import AsyncConfig, FederatedSpec, RoundHook
    from repro_torch.models import build_model

    fed = FedConfig(num_clients=12, participation=0.5, rounds=3, local_epochs=1,
                    local_batch=8, lr=0.05, mu=0.1, seed=0, round_policy="async")
    data = make_vision_data(fed, train_per_class=24, test_per_class=8, noise=0.3)
    model = build_model(dataclasses.replace(
        smoke_variant(get_config("resnet18-cifar10")), d_model=8))
    mult = np.asarray([1.0, 3.0, 0.5, 2.5, 1.0, 4.0] * 2)

    def noise(t, k):   # a function of the round, as resumable runs need
        return gumbel_noise(torch.Generator(device=cuda_device).manual_seed(100 + t), k)

    seen = []

    class Check(RoundHook):
        def on_round_start(self, ctx):
            eng, t = ctx.engine, ctx.round_idx
            stale = eng.staleness_override()
            sel, _, _ = tss.fused_score_select_plain(
                *score_inputs(eng.state), round_idx=t,
                tau=dynamic_temperature(t, SelectorConfig()), m=eng.m_over,
                gumbel=eng.round_noise(t), cfg=HeteRoScoreConfig(),
                staleness_override=stale)
            self.want = np.zeros(fed.num_clients, bool)
            self.want[sel.cpu().numpy()] = True
            self.want &= ~eng._in_flight
            self.before = dict(tss.LAUNCHES)
            self.stale = stale.cpu().numpy()

        def on_round_end(self, ctx):
            grew = {n: tss.LAUNCHES[n] - self.before[n] for n in ("score_stats", "score_select")}
            assert grew == {"score_stats": 1, "score_select": 1}, grew
            np.testing.assert_array_equal(ctx.mask, self.want)
            seen.append((self.stale, ctx.num_stragglers))

    FederatedSpec(model, fed, data, selector="heterosel_pallas", steps_per_round=1,
                  system=mult, compact_state=compact, device=cuda_device, noise=noise,
                  async_cfg=AsyncConfig(deadline=1.5, over_select_frac=0.5, jitter=0.1),
                  hooks=[Check()]).build().run()
    assert len(seen) == fed.rounds
    # the override is the clock's, not the round counter
    assert any(not np.all(s[s < 1e5] == t) for t, (s, _) in enumerate(seen))


# ---------------------------------------------------------------------------
# The serving tier (slice 9): decode attention, a slot tick, K6 at decode
# ---------------------------------------------------------------------------


def _decode_attention_f64(q, k, v, cur_len):
    """Single-token attention in f64: the reference's einsums over (B, KVH,
    G, 1, T), positions ≥ cur_len masked."""
    b, _, h, d = q.shape
    kvh, t = k.shape[2], k.shape[1]
    qf = (q.double() / d ** 0.5).reshape(b, 1, kvh, h // kvh, d)
    s = torch.einsum("bskgd,btkd->bkgst", qf, k.double())
    s = torch.where(torch.arange(t, device=q.device) < cur_len, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", p, v.double()).reshape(b, 1, h, d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(8, 128, 14, 2, 64), (2, 1601, 64, 8, 128)],
                         ids=["qwen2-slots", "vlm-cross"])
def test_cuda_decode_attention_matches_f64(cuda_device, shape, dtype):
    """decode_attention on the card (f32 math over bf16 or f32 caches)
    against the same function in f64: f32 outputs within 1e-5 relative plus
    1e-6 absolute; bf16 outputs within one bf16 ulp of the f64 result plus
    1e-6 (the one rounding to bf16)."""
    from repro_torch.models.attention import decode_attention

    b, t, h, kvh, d = shape
    gen = torch.Generator(device=cuda_device).manual_seed(t)
    q = torch.randn(b, 1, h, d, generator=gen, device=cuda_device).to(dtype)
    k = torch.randn(b, t, kvh, d, generator=gen, device=cuda_device).to(dtype)
    v = torch.randn(b, t, kvh, d, generator=gen, device=cuda_device).to(dtype)
    for cur in (1, t // 3, t):
        got = decode_attention(q, k, v, cur)
        want = _decode_attention_f64(q, k, v, cur)
        assert got.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-6)
        else:
            gap = (got.double() - want).abs()
            assert bool((gap <= _bf16_ulp(want.float()).double() + 1e-6).all()), float(gap.max())


@pytest.mark.cuda
def test_cuda_slot_tick_against_batch1_steps(cuda_device):
    """A 4-slot tick of the smoke qwen2 on the card, each slot at its own
    position, against batch-1 steps on each slot's cache: the logits within
    2 bf16 ulp of the largest logit (cuBLAS may round a product differently
    at another row count, chip_smoke.py phase 14a), and ``generate`` run as
    one slot of the same width gives the served tokens bit for bit."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import build_model
    from repro_torch.serve import (ModelServer, TrafficConfig, TrafficSimulator,
                                   VersionRegistry, generate)
    from repro_torch.serve.server import slot_tick

    model = build_model(smoke_variant(get_config("qwen2-0.5b")))
    params = model.init_params(torch.Generator(device=cuda_device).manual_seed(0))
    width, caches, toks = 4, [], []
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    with torch.no_grad():
        for i in range(width):
            cache = model.init_cache(1, 16, device=cuda_device)
            for pos in range(i + 1):
                tok = torch.randint(0, 512, (1, 1), generator=gen, device=cuda_device)
                _, cache = model.decode_step(params, cache, tok.to(torch.int32), pos)
            caches.append(cache)
            toks.append(torch.randint(0, 512, (1, 1), generator=gen, device=cuda_device))
        stacked = {k: torch.stack([c[k] for c in caches]) for k in caches[0]}
        logits, _ = slot_tick(model)(params, stacked,
                                     torch.stack(toks).to(torch.int32),
                                     torch.arange(1, width + 1, device=cuda_device))
        for i in range(width):
            one, _ = model.decode_step(params, caches[i], toks[i].to(torch.int32), i + 1)
            top = float(_bf16_ulp(one.float().abs().max()))
            assert float((logits[i].float() - one.float()).abs().max()) <= 2 * top
    reg = VersionRegistry()
    reg.publish(params, round_idx=-1)
    srv = ModelServer(model, reg, batch_width=width, max_len=16, device=cuda_device)
    reqs = TrafficSimulator(TrafficConfig(prompt_len=(1, 6), output_len=(2, 8), seed=3,
                                          max_requests=2 * width), vocab=512).take(2 * width)
    for r in reqs:
        srv.submit(r)
    recs = {rec.rid: rec for rec in srv.pump()}
    for r in reqs:
        assert recs[r.rid].tokens == tuple(generate(model, params, r.prompt[None],
                                                    r.output_len, r.draws, slots=width)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("slots", [1, 8])
def test_cuda_grouped_matmul_at_decode_row_counts(cuda_device, slots, dtype):
    """K6 at a decode tick's rows: each slot routes one token to 8 of 16
    experts (8 rows a slot, most groups empty or of one row), the slots
    folded by the vmap rule into one launch, against the plain version."""
    from repro_torch.kernels import moe_gmm as tgmm

    gen = torch.Generator(device=cuda_device).manual_seed(slots)
    g, k, n = 16, 256, 128
    xs = torch.randn(slots, 8, k, generator=gen, device=cuda_device).to(dtype)
    rhs = torch.randn(g, k, n, generator=gen, device=cuda_device).to(dtype)
    picks = torch.stack([torch.randperm(g, generator=gen, device=cuda_device)[:8]
                         for _ in range(slots)])
    sizes = (picks[:, :, None] == torch.arange(g, device=cuda_device)).sum(1).to(torch.int32)
    before = tgmm.LAUNCHES["grouped_matmul"]
    got = torch.func.vmap(lambda x, s: ops.grouped_matmul(x, rhs, s))(xs, sizes)
    torch.cuda.synchronize()
    assert tgmm.LAUNCHES["grouped_matmul"] == before + 1
    want = tgmm.gmm_plain_clients(xs.reshape(slots * 8, k), rhs, sizes)
    assert_gmm_close(got.reshape(slots * 8, n), want)


# ---------------------------------------------------------------------------
# Slice 10: K1 + K2 at K = 2048 under telemetry, int8 compression, churn
# ---------------------------------------------------------------------------


def _smoke_resnet():
    import dataclasses

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import build_model

    return build_model(dataclasses.replace(
        smoke_variant(get_config("resnet18-cifar10")), d_model=8, image_size=8))


@pytest.mark.cuda
def test_cuda_large_k_rounds_under_telemetry(cuda_device):
    """Lazy data at K = 2048 under heterosel_pallas with a TelemetryHook:
    K1 and K2 once a round, each cohort equal to the plain versions'
    selection on the same state and draws; the trace validates and its
    select/execute/aggregate spans are the *_ms clock readings; the run
    equals the bare run bitwise under deterministic algorithms."""
    import numpy as np

    from repro_torch.configs import FedConfig
    from repro_torch.core.state import score_inputs
    from repro_torch.data import make_lazy_vision_data
    from repro_torch.fed import FederatedSpec, RoundHook
    from repro_torch.obs import TelemetryHook, validate_trace_events

    fed = FedConfig(num_clients=2048, participation=16 / 2048, rounds=3, local_batch=8,
                    lr=0.05, mu=0.1, seed=0, client_chunk=8)
    data = make_lazy_vision_data(fed, image_size=8, test_per_class=4)
    model = _smoke_resnet()

    def noise(t, k):
        return gumbel_noise(torch.Generator(device=cuda_device).manual_seed(200 + t), k)

    class Check(RoundHook):
        def on_round_start(self, ctx):
            eng, t = ctx.engine, ctx.round_idx
            sel, _, _ = tss.fused_score_select_plain(
                *score_inputs(eng.state), round_idx=t,
                tau=dynamic_temperature(t, SelectorConfig()), m=16,
                gumbel=eng.round_noise(t), cfg=HeteRoScoreConfig())
            self.want = np.zeros(fed.num_clients, bool)
            self.want[sel.cpu().numpy()] = True
            self.before = dict(tss.LAUNCHES)

        def on_round_end(self, ctx):
            grew = {n: tss.LAUNCHES[n] - self.before[n] for n in ("score_stats", "score_select")}
            assert grew == {"score_stats": 1, "score_select": 1}, grew
            np.testing.assert_array_equal(ctx.mask, self.want)

    def run(hooks):
        return FederatedSpec(model, fed, data, selector="heterosel_pallas", steps_per_round=2,
                             device=cuda_device, noise=noise, hooks=hooks).build().run()

    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        tel = TelemetryHook()
        wired = run([tel, Check()])
        bare = run([])
    finally:
        torch.use_deterministic_algorithms(before)
    events = tel.recorder.events
    validate_trace_events(events)
    for name in ("select", "execute", "aggregate"):
        starts = [e["ts"] for e in events if e["name"] == name and e["ph"] == "B"]
        ends = [e["ts"] for e in events if e["name"] == name and e["ph"] == "E"]
        got = (np.asarray(ends) - np.asarray(starts)) / 1e3
        np.testing.assert_allclose(got, getattr(wired, f"{name}_ms"), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(wired.selected_history, bare.selected_history)
    for k, p in bare.params.items():
        assert torch.equal(p.view(torch.uint8), wired.params[k].view(torch.uint8)), k


@pytest.mark.cuda
def test_cuda_int8_codes_equal_the_cpu_codes(cuda_device):
    """int8 (per tensor and stacked per client) and top-k on the card give
    the CPU's codes, scales and indices bitwise (ties included)."""
    from repro_torch.fed import compression as comp

    gen = torch.Generator().manual_seed(0)
    delta = {"w": torch.randn(64, 3, 3, 32, generator=gen),
             "b": torch.randn(4, 513, generator=gen) * 1e-3,
             "t": torch.randint(-2, 3, (4, 1000), generator=gen).float() * 0.25}
    on = {k: v.to(cuda_device) for k, v in delta.items()}
    for fn in (comp.quantize_int8, comp.quantize_int8_stacked):
        (c_cpu, s_cpu), (c_gpu, s_gpu) = fn(delta), fn(on)
        assert tuple(s_cpu) == tuple(s_gpu)
        for k in delta:
            assert torch.equal(c_gpu.payload[k].cpu(), c_cpu.payload[k]), k
            assert torch.equal(c_gpu.meta[k].cpu(), c_cpu.meta[k]), k
    (c_cpu, r_cpu, _), (c_gpu, r_gpu, _) = (comp.topk_sparsify(delta, 0.1),
                                            comp.topk_sparsify(on, 0.1))
    for k in delta:
        assert torch.equal(c_gpu.payload[k][1].cpu(), c_cpu.payload[k][1]), k
        assert torch.equal(c_gpu.payload[k][0].cpu(), c_cpu.payload[k][0]), k
        assert torch.equal(r_gpu[k].cpu(), r_cpu[k]), k


@pytest.mark.cuda
def test_cuda_int8_batched_round_is_the_plain_aggregate(cuda_device):
    """int8 over the batched executor on the card: in the first round each
    client's decoded slice equals its delta coded on its own (scale
    max|delta| / 127, codes round(delta / scale)) bitwise, the aggregate is
    the weighted mean of the decoded clients up to summation order, and
    the run moves the weights."""
    import dataclasses

    from repro_torch.configs import FedConfig, get_config, smoke_variant
    from repro_torch.data import make_vision_data
    from repro_torch.fed import FederatedSpec
    from repro_torch.models import build_model

    fed = FedConfig(num_clients=6, participation=0.5, rounds=2, local_batch=8, lr=0.05,
                    mu=0.1, dirichlet_alpha=0.1, seed=0)
    model = build_model(dataclasses.replace(smoke_variant(get_config("resnet18-cifar10")),
                                            d_model=8))
    eng = FederatedSpec(model, fed, make_vision_data(fed, train_per_class=24, test_per_class=8),
                        selector="heterosel_pallas", steps_per_round=2, executor="batched",
                        compression="int8", aggregator="fedavgm", device=cuda_device).build()
    seen, outer, inner = {}, eng.executor.run_round, eng.executor.inner.run_round

    def inner_round(*args, **kwargs):
        cohort = inner(*args, **kwargs)
        seen.setdefault("raw", {k: v.clone() for k, v in cohort.stacked_params.items()})
        return cohort

    def outer_round(params, *args, **kwargs):
        cohort = outer(params, *args, **kwargs)
        if "cohort" not in seen:
            seen["anchor"], seen["cohort"] = {k: v.clone() for k, v in params.items()}, cohort
        return cohort

    eng.executor.inner.run_round, eng.executor.run_round = inner_round, outer_round
    res = eng.run()
    anchor, cohort = seen["anchor"], seen["cohort"]
    w = torch.ones(fed.num_selected, device=cuda_device) if cohort.weights is None \
        else cohort.weights.float()
    for k, stack in seen["raw"].items():
        rebuilt = []
        for i in range(stack.shape[0]):
            delta = stack[i] - anchor[k]
            scale = torch.clamp_min(delta.abs().max(), 1e-12) / torch.full(
                (), 127.0, device=cuda_device)
            rebuilt.append(anchor[k] + torch.clamp(torch.round(delta / scale), -127, 127) * scale)
            assert torch.equal(rebuilt[i], cohort.stacked_params[k][i]), (k, i)
        mean = sum(wi * r for wi, r in zip(w, rebuilt)) / w.sum()
        torch.testing.assert_close(cohort.avg_params[k], mean, rtol=1e-5, atol=1e-6)
    assert any(not torch.equal(res.params[k], anchor[k]) for k in anchor)


@pytest.mark.cuda
def test_cuda_hierarchical_churn_runs_k4_with_spans(cuda_device):
    """The hierarchical engine under the 'churn' scenario with a
    TelemetryHook on the card: K4 once a round, no offline client selected,
    outer_select + inner_select spans summing to select_ms."""
    import numpy as np

    from repro_torch.configs import FedConfig
    from repro_torch.data import make_vision_data
    from repro_torch.fed import FederatedSpec, HierarchyConfig, make_scenario
    from repro_torch.obs import TelemetryHook, validate_trace_events

    fed = FedConfig(num_clients=24, participation=0.5, rounds=3, local_batch=8, lr=0.05,
                    mu=0.1, seed=0, topology="hierarchical", edge_count=4)
    data = make_vision_data(fed, train_per_class=48, test_per_class=4, image_size=8)
    built = make_scenario("churn").build(fed)
    tel = TelemetryHook()
    before = tss.LAUNCHES["segment_probs"]
    res = FederatedSpec(_smoke_resnet(), fed, data, selector="heterosel_pallas",
                        steps_per_round=1, device=cuda_device,
                        hier_cfg=HierarchyConfig(edges_per_round=3), hooks=[tel],
                        **built.spec_kwargs()).build().run()
    assert tss.LAUNCHES["segment_probs"] == before + fed.rounds
    assert not (res.selected_history & ~built.availability).any()
    events = tel.recorder.events
    validate_trace_events(events)

    def durations(name):
        b = [e["ts"] for e in events if e["name"] == name and e["ph"] == "B"]
        e = [e["ts"] for e in events if e["name"] == name and e["ph"] == "E"]
        return (np.asarray(e) - np.asarray(b)) / 1e3

    np.testing.assert_allclose(durations("outer_select") + durations("inner_select"),
                               res.select_ms, rtol=0, atol=1e-6)
