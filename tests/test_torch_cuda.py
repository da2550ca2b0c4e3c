"""The port's CUDA kernels (K1–K4) against their plain PyTorch versions, on
the card.

Every test here is marked ``cuda`` and skips when torch sees no device. The
file imports neither JAX nor the reference package, so it also runs where
only the port is installed:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Selected sets are compared exactly; scores and probabilities to 1e-5
relative (K1 sums Σ‖Δw‖² in another order than ``torch.sum``).
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.scoring import HeteRoScoreConfig
from repro_torch.core.selection import SelectorConfig, dynamic_temperature, gumbel_noise
from repro_torch.core.state import NEVER
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
    """Per-block candidates come out value-descending, ties by column."""
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
