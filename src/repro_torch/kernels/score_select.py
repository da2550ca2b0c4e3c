"""Fused HeteRo-Select scoring, softmax and Gumbel-top-m selection (Eqs 1–12).

Port of the reference's ``repro.kernels.score_select``: four kernels and
the sharded select built on two of them.

  * K1 ``score_stats`` (replaces ``_stats_kernel``): each block of clients is
    reduced to five partials (loss min/max over observed clients, Σ‖Δw‖²
    and the observation count, the participation max); ``_combine_stats``
    folds the ``(nblocks, 5)`` table into the four global statistics.
  * K2 ``score_select`` (replaces ``_select_kernel``): each block computes
    the additive scores, the block softmax exponentials with their
    (m_b, l_b) normalizer pair, and its top-min(m, block) Gumbel-perturbed
    candidates. ``_normalize`` merges the normalizers and a top-m over the
    candidates (``merge_candidates``) picks the cohort. ``fused_score_select``
    runs K1 then K2: the flat engine's ``heterosel_pallas`` path.
  * K3 ``score_probs`` (replaces ``_score_kernel``): K2 without the
    sampling. ``fused_score_probs`` runs K1, K3 and ``_normalize`` and
    returns ``(probs, scores)``.
  * K4 ``segment_probs`` (replaces ``_segment_kernel``): E edges in one
    launch, each edge's statistics, scores and softmax inside its own slice
    of an edge-major ``(E·seg,)`` layout. ``segmented_score_probs`` is the
    hierarchical engine's inner stage under ``heterosel_pallas``.
  * K8 ``sharded_score_select`` (replaces the reference's
    ``sharded_score_select``): K1 and K2 on each client shard of a
    ``torch.distributed`` group, with the shard's global column offset,
    stitched by four all-gathers: the statistics, the normalizer pairs, each
    shard's merged top-m candidates and the probabilities and scores.
    ``SHARDED_LAUNCHES`` counts its calls on the card, ``LAUNCHES`` the K1
    and K2 launches.

All four kernels are CUDA C++ for sm_90a (``csrc/score_select.cu``, whose header
gives their bound and design). Each wrapper below takes its plain PyTorch
version for a tensor on the CPU, and launches its kernel for a CUDA tensor —
there is no fallback from one to the other. ``LAUNCHES`` counts kernel
launches; the plain versions do not count.

All (K,) operands travel as one stacked ``(9, kpad)`` operand (``_pack``),
bf16 when the ClientState is bf16. Row ``ROW_STALE`` carries a staleness
override switched on by ``use_ov``. The Gumbel noise is an input, drawn by
the caller, so a run can be held against the reference on the same noise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.scoring import HeteRoScoreConfig, diversity_decay
from repro_torch.kernels import _build
from repro_torch.kernels._math import exp as _exp
from repro_torch.kernels._math import log1p as _log1p

MAX_BLOCK = 2048    # clients per CTA: z of the whole block fits 8 KB of smem
MIN_BLOCK = 32      # one warp
BIG = 1e30

(ROW_LOSS, ROW_LOSS2, ROW_JS, ROW_CNT, ROW_LAST, ROW_SQ, ROW_HASL,
 ROW_HASM, ROW_STALE) = range(9)
NROWS = 9

# Columns of the (nblocks, NSTATS) K1 partial table.
(ST_LMIN, ST_LMAX, ST_SUMSQ, ST_NOBS, ST_HMAX) = range(5)
NSTATS = 5

# Kernel launches since the last reset, by kernel.
LAUNCHES = {"score_stats": 0, "score_select": 0, "score_probs": 0,
            "segment_probs": 0}
# K8's calls on the card (each launches K1 and K2 once, counted above).
SHARDED_LAUNCHES = {"sharded_score_select": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, SHARDED_LAUNCHES):
        for name in counts:
            counts[name] = 0


class _ScoreCfg(ctypes.Structure):
    """Mirror of ``struct ScoreCfg`` in csrc/score_select.cu."""

    _fields_ = [(n, ctypes.c_float) for n in (
        "w_value", "w_diversity", "w_momentum", "w_fairness", "w_staleness",
        "w_norm", "eta", "gamma", "alpha", "t_max")]


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (first use) and load csrc/score_select.cu, with its C types."""
    lib = _build.build("score_select").lib
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.hs_stats.argtypes = [i, p, ll, i, i, ll, ll, p, p]
    lib.hs_stats.restype = i
    lib.hs_select.argtypes = [i, p, p, p, ll, i, i, ll, ll, f, f, i, f,
                              ctypes.POINTER(_ScoreCfg), i, p, p, p, p, p, p]
    lib.hs_select.restype = i
    lib.hs_score.argtypes = [i, p, p, ll, i, i, ll, f, f, i, f,
                             ctypes.POINTER(_ScoreCfg), p, p, p, p]
    lib.hs_score.restype = i
    lib.hs_segment.argtypes = [i, p, p, ll, i, i, f, f, i, f,
                               ctypes.POINTER(_ScoreCfg), p, p, p]
    lib.hs_segment.restype = i
    lib.hs_error_string.argtypes = [i]
    lib.hs_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"({lib.hs_error_string(rc).decode()})")


def _dtype_code(x: torch.Tensor) -> int:
    return {torch.float32: 0, torch.bfloat16: 1}[x.dtype]


def _cfg_struct(cfg: HeteRoScoreConfig) -> _ScoreCfg:
    return _ScoreCfg(cfg.w_value, cfg.w_diversity, cfg.w_momentum, cfg.w_fairness,
                     cfg.w_staleness, cfg.w_norm, cfg.eta, cfg.gamma, cfg.alpha,
                     float(cfg.t_max))


def _scalars(round_idx, tau, cfg: HeteRoScoreConfig) -> tuple[float, float, float]:
    """(t, tau, decay) as exact f32 values, as the reference's scalar lanes."""
    t = float(torch.tensor(float(round_idx), dtype=torch.float32))
    tau = float(torch.as_tensor(tau, dtype=torch.float32))
    return t, tau, float(diversity_decay(round_idx, cfg))


# ---------------------------------------------------------------------------
# Layout and packing
# ---------------------------------------------------------------------------


def _layout(k: int, block: Optional[int] = None) -> tuple[int, int, int]:
    """(block, nblocks, kpad). ``block`` is a power of two in
    [MIN_BLOCK, MAX_BLOCK], shrunk to the smallest power of two ≥ K when the
    whole federation fits one block."""
    if k < 1:
        raise ValueError(f"need at least one client, got K={k}")
    blk = block or MAX_BLOCK
    if blk & (blk - 1) or not MIN_BLOCK <= blk <= MAX_BLOCK:
        raise ValueError(f"block must be a power of two in "
                         f"[{MIN_BLOCK}, {MAX_BLOCK}], got {blk}")
    blk = min(blk, max(MIN_BLOCK, 1 << (k - 1).bit_length()))
    nblocks = -(-k // blk)
    return blk, nblocks, nblocks * blk


def _pack(rows, staleness_override, k: int, kpad: int) -> torch.Tensor:
    """One stacked (NROWS, kpad) operand. A bf16 state streams as bf16; the
    int32 counters are cast to the feed type here, as the reference does."""
    feed = torch.bfloat16 if rows[0].dtype == torch.bfloat16 else torch.float32
    dev = rows[0].device
    if staleness_override is None:
        stale = torch.zeros(k, dtype=feed, device=dev)
    else:
        stale = staleness_override.to(device=dev, dtype=feed)
    stacked = torch.stack([r.to(feed) for r in rows] + [stale])
    return F.pad(stacked, (0, kpad - k))


def _check_stacked(stacked: torch.Tensor, block: int) -> int:
    if stacked.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"stacked operand must be float32 or bfloat16, "
                        f"got {stacked.dtype}")
    if stacked.dim() != 2 or stacked.shape[0] != NROWS or stacked.shape[1] % block:
        raise ValueError(f"stacked operand must be ({NROWS}, nblocks*{block}), "
                         f"got {tuple(stacked.shape)}")
    if not stacked.is_contiguous():
        raise ValueError("stacked operand must be contiguous")
    if stacked.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {stacked.device}")
    return stacked.shape[1] // block


# ---------------------------------------------------------------------------
# K1: per-block statistics
# ---------------------------------------------------------------------------


def score_stats_plain(stacked: torch.Tensor, *, k: int, block: int,
                      off: int = 0) -> torch.Tensor:
    """Plain version of K1: (nblocks, NSTATS) f32 per-block partials. Local
    column c is global client ``off + c``, valid while that is below ``k``."""
    nblocks = stacked.shape[1] // block
    x = stacked.to(torch.float32).view(NROWS, nblocks, block)
    col = torch.arange(nblocks * block, device=stacked.device).view(nblocks, block)
    valid = off + col < k
    obs = valid & (x[ROW_HASL] > 0)
    loss = x[ROW_LOSS]
    return torch.stack([
        torch.where(obs, loss, BIG).amin(1),
        torch.where(obs, loss, -BIG).amax(1),
        torch.where(obs, x[ROW_SQ], 0.0).sum(1),
        obs.to(torch.float32).sum(1),
        torch.where(valid, x[ROW_CNT], 0.0).amax(1),
    ], dim=1)


def score_stats(stacked: torch.Tensor, *, k: int, block: int,
                off: int = 0) -> torch.Tensor:
    """K1: per-block partials of the global scoring statistics; ``off`` is
    the global id of local column 0 (a K8 shard's offset, else 0).

    CPU tensor → ``score_stats_plain``; CUDA tensor → the sm_90a kernel.
    """
    nblocks = _check_stacked(stacked, block)
    if stacked.device.type == "cpu":
        return score_stats_plain(stacked, k=k, block=block, off=off)
    _build.check_card(stacked.device)
    lib = _library()
    out = torch.empty((nblocks, NSTATS), dtype=torch.float32, device=stacked.device)
    rc = lib.hs_stats(_dtype_code(stacked), stacked.data_ptr(), stacked.shape[1],
                      block, nblocks, off, k, out.data_ptr(),
                      _build.stream(stacked.device))
    _raise_on(lib, rc, "score_stats")
    LAUNCHES["score_stats"] += 1
    return out


def _combine_stats(stats: torch.Tensor) -> torch.Tensor:
    """Fold the (nblocks, NSTATS) table into (lmin, lmax, avgsq, hmax), f32,
    on the table's device (no host round trip)."""
    lmin = stats[:, ST_LMIN].amin()
    lmax = stats[:, ST_LMAX].amax()
    avgsq = stats[:, ST_SUMSQ].sum() / torch.clamp_min(stats[:, ST_NOBS].sum(), 1.0)
    hmax = torch.clamp_min(stats[:, ST_HMAX].amax(), 1.0)
    return torch.stack([lmin, lmax, avgsq, hmax])


# ---------------------------------------------------------------------------
# K2: scores, block softmax pieces, per-block Gumbel-top-m candidates
# ---------------------------------------------------------------------------


def _block_scores_plain(x: torch.Tensor, glob: torch.Tensor, *, t: float,
                        decay: float, use_ov: bool,
                        cfg: HeteRoScoreConfig) -> torch.Tensor:
    """Six score components + Eq (1) additive combination, f32 in the shape
    of one row of ``x``.

    ``glob`` holds (lmin, lmax, avgsq, hmax) on its first axis; each entry
    broadcasts against a row, so it is (4,) for one global set of
    statistics or (4, E, 1) for per-edge statistics over an (E, seg) view.
    The op order matches ``client_score`` in csrc/score_select.cu. Every
    divisor is a tensor on ``x``'s device: a CPU scalar divisor would let
    PyTorch's CUDA division multiply by a reciprocal instead. exp and log1p
    are ``kernels/_math``'s here and in every plain version below: on the
    CPU they do not go through MKL's vector math (ROADMAP queue 3 (f)), on
    the card they are ``torch.exp`` and ``torch.log1p``.
    """
    lmin, lmax, avgsq, hmax = glob[0], glob[1], glob[2], glob[3]
    loss = x[ROW_LOSS]
    loss2 = x[ROW_LOSS2]
    has_loss = x[ROW_HASL] > 0
    has_mom = x[ROW_HASM] > 0
    # Eq (3)
    v = torch.clamp((loss - lmin) / (lmax - lmin + 1e-8), 0.0, 1.0)
    v = torch.where(has_loss, v, 0.5)
    # Eq (4)
    div = x[ROW_JS] * decay
    # Eq (5)
    m = torch.where(has_mom, (loss2 - loss) / (loss2 + 1e-8), 0.0)
    mom = 2.0 / (1.0 + _exp(-5.0 * m)) - 0.5
    # Eq (6)
    f = 1.0 + cfg.eta * x[ROW_CNT] / hmax
    fair = 1.0 / (f * f)
    # Eq (7)
    if use_ov:
        delta = torch.clamp_min(x[ROW_STALE], 0.0)
    else:
        delta = torch.clamp_min(t - x[ROW_LAST], 0.0)
    delta = torch.clamp_max(delta, float(cfg.t_max))
    st = 1.0 + cfg.gamma * _log1p(delta)
    # Eq (11)
    r = torch.where(has_loss, x[ROW_SQ] / (avgsq + 1e-8), 1.0)
    npen = 1.0 - cfg.alpha * (2.0 / (1.0 + _exp(-3.0 * r)) - 1.0)
    # Eq (1)
    return (cfg.w_value * v + cfg.w_diversity * div + cfg.w_momentum * mom
            + cfg.w_fairness * (fair - 1.0) + cfg.w_staleness * (st - 1.0)
            + cfg.w_norm * (npen - 1.0))


def _block_softmax_plain(stacked, glob, *, k: int, block: int, t: float,
                         tau: float, use_ov: bool, decay: float,
                         cfg: HeteRoScoreConfig, off: int = 0):
    """Pass 2 shared by K2 and K3: scores (kpad,), z and e (nblocks, block),
    and the (nblocks, 2) (m_b, l_b) pairs."""
    dev = stacked.device
    kpad = stacked.shape[1]
    nblocks = kpad // block
    x = stacked.to(torch.float32)
    valid = (off + torch.arange(kpad, device=dev) < k).view(nblocks, block)
    s = _block_scores_plain(x, glob, t=t, decay=decay, use_ov=use_ov, cfg=cfg)
    tau_t = torch.tensor(tau, dtype=torch.float32, device=dev)
    z = torch.where(valid, (s / tau_t).view(nblocks, block), -BIG)
    m_b = z.amax(1)
    e = torch.where(valid, _exp(z - m_b[:, None]), 0.0)
    return s, z, e, torch.stack([m_b, e.sum(1)], dim=1)


def order_keys(v: torch.Tensor) -> torch.Tensor:
    """int32 keys ordered as the f32 values ``v`` are in IEEE total order:
    −0.0 below +0.0 and NaN above +inf, as XLA's ``lax.top_k`` ranks them on
    the CPU. K2's kernel ranks by the same order (``order_bits`` in
    csrc/score_select.cu: these keys + 2^31 as uint32)."""
    b = v.contiguous().view(torch.int32)
    return torch.where(b >= 0, b, b ^ 0x7FFFFFFF)


def score_select_plain(stacked, glob, gumbel, *, k: int, block: int, t: float,
                       tau: float, use_ov: bool, decay: float,
                       cfg: HeteRoScoreConfig, mb: int, off: int = 0):
    """Plain version of K2. Returns ``(scores (kpad,), e (kpad,),
    part (nblocks, 2) = (m_b, l_b), cval (nblocks, mb) f32,
    cidx (nblocks, mb) int32)``. Each block's candidates are its top mb
    perturbed values z + g by (value descending in ``order_keys``' order,
    column ascending), listed in ascending column order, with global ids
    (``off`` + column)."""
    s, z, e, part = _block_softmax_plain(stacked, glob, k=k, block=block, t=t,
                                         tau=tau, use_ov=use_ov, decay=decay, cfg=cfg,
                                         off=off)
    nblocks = z.shape[0]
    pert = z + gumbel.view(nblocks, block)
    top = torch.sort(order_keys(pert), dim=1, descending=True, stable=True).indices
    loc = torch.sort(top[:, :mb], dim=1).values
    first = torch.arange(nblocks, device=stacked.device)[:, None] * block + off
    return (s, e.reshape(-1), part, pert.gather(1, loc), (loc + first).to(torch.int32))


def _check_glob(glob: torch.Tensor, stacked: torch.Tensor) -> None:
    if glob.dtype != torch.float32 or tuple(glob.shape) != (4,) \
            or not glob.is_contiguous() or glob.device != stacked.device:
        raise ValueError(f"glob must be a contiguous float32 (4,) tensor on "
                         f"{stacked.device}")


def score_select(stacked, glob, gumbel, *, k: int, block: int, t: float,
                 tau: float, use_ov: bool, decay: float,
                 cfg: HeteRoScoreConfig, mb: int, off: int = 0):
    """K2: scores, softmax pieces and per-block candidates (see the plain
    version for the outputs); ``off`` as in ``score_stats``. CPU tensors →
    ``score_select_plain``; CUDA tensors → the sm_90a kernel."""
    nblocks = _check_stacked(stacked, block)
    kpad = stacked.shape[1]
    _check_glob(glob, stacked)
    if gumbel.dtype != torch.float32 or tuple(gumbel.shape) != (kpad,) \
            or not gumbel.is_contiguous() or gumbel.device != stacked.device:
        raise ValueError(f"gumbel must be a contiguous float32 ({kpad},) tensor "
                         f"on {stacked.device}")
    if not 1 <= mb <= block:
        raise ValueError(f"mb must be in [1, {block}], got {mb}")
    if stacked.device.type == "cpu":
        return score_select_plain(stacked, glob, gumbel, k=k, block=block, t=t,
                                  tau=tau, use_ov=use_ov, decay=decay, cfg=cfg,
                                  mb=mb, off=off)
    _build.check_card(stacked.device)
    lib = _library()
    dev = stacked.device
    f32 = dict(dtype=torch.float32, device=dev)
    scores = torch.empty(kpad, **f32)
    e = torch.empty(kpad, **f32)
    part = torch.empty((nblocks, 2), **f32)
    cval = torch.empty((nblocks, mb), **f32)
    cidx = torch.empty((nblocks, mb), dtype=torch.int32, device=dev)
    rc = lib.hs_select(_dtype_code(stacked), stacked.data_ptr(), gumbel.data_ptr(),
                       glob.data_ptr(), kpad, block, nblocks, off, k, t, tau,
                       int(use_ov), decay, ctypes.byref(_cfg_struct(cfg)), mb,
                       scores.data_ptr(),
                       e.data_ptr(), part.data_ptr(), cval.data_ptr(),
                       cidx.data_ptr(), _build.stream(dev))
    _raise_on(lib, rc, "score_select")
    LAUNCHES["score_select"] += 1
    return scores, e, part, cval, cidx


# ---------------------------------------------------------------------------
# K3: scores and block softmax pieces, no sampling
# ---------------------------------------------------------------------------


def score_probs_plain(stacked, glob, *, k: int, block: int, t: float, tau: float,
                      use_ov: bool, decay: float, cfg: HeteRoScoreConfig):
    """Plain version of K3: ``(scores (kpad,), e (kpad,), part (nblocks, 2))``,
    the first three outputs of K2."""
    s, _, e, part = _block_softmax_plain(stacked, glob, k=k, block=block, t=t,
                                         tau=tau, use_ov=use_ov, decay=decay, cfg=cfg)
    return s, e.reshape(-1), part


def score_probs(stacked, glob, *, k: int, block: int, t: float, tau: float,
                use_ov: bool, decay: float, cfg: HeteRoScoreConfig):
    """K3: scores and softmax pieces (see the plain version). CPU tensors →
    ``score_probs_plain``; CUDA tensors → the sm_90a kernel."""
    nblocks = _check_stacked(stacked, block)
    _check_glob(glob, stacked)
    if stacked.device.type == "cpu":
        return score_probs_plain(stacked, glob, k=k, block=block, t=t, tau=tau,
                                 use_ov=use_ov, decay=decay, cfg=cfg)
    _build.check_card(stacked.device)
    lib = _library()
    dev = stacked.device
    kpad = stacked.shape[1]
    scores = torch.empty(kpad, dtype=torch.float32, device=dev)
    e = torch.empty(kpad, dtype=torch.float32, device=dev)
    part = torch.empty((nblocks, 2), dtype=torch.float32, device=dev)
    rc = lib.hs_score(_dtype_code(stacked), stacked.data_ptr(), glob.data_ptr(),
                      kpad, block, nblocks, k, t, tau, int(use_ov), decay,
                      ctypes.byref(_cfg_struct(cfg)), scores.data_ptr(),
                      e.data_ptr(), part.data_ptr(), _build.stream(dev))
    _raise_on(lib, rc, "score_probs")
    LAUNCHES["score_probs"] += 1
    return scores, e, part


# ---------------------------------------------------------------------------
# K4: per-edge statistics, scores and softmax in one launch
# ---------------------------------------------------------------------------


def segment_probs_plain(stacked, sizes, *, seg: int, t: float, tau: float,
                        use_ov: bool, decay: float, cfg: HeteRoScoreConfig):
    """Plain version of K4 on an (E, seg) view. Returns ``(probs, scores)``,
    each (E·seg,) f32 in the operand's edge-major layout, 0.0 in every
    padding slot."""
    dev = stacked.device
    num_edges = stacked.shape[1] // seg
    x = stacked.to(torch.float32).view(NROWS, num_edges, seg)
    n = torch.clamp(sizes.to(torch.int64), 0, seg)
    valid = torch.arange(seg, device=dev)[None, :] < n[:, None]
    obs = valid & (x[ROW_HASL] > 0)
    loss = x[ROW_LOSS]
    nobs = obs.to(torch.float32).sum(1)
    glob = torch.stack([
        torch.where(obs, loss, BIG).amin(1),
        torch.where(obs, loss, -BIG).amax(1),
        torch.where(obs, x[ROW_SQ], 0.0).sum(1) / torch.clamp_min(nobs, 1.0),
        torch.clamp_min(torch.where(valid, x[ROW_CNT], 0.0).amax(1), 1.0),
    ])[:, :, None]
    s = _block_scores_plain(x, glob, t=t, decay=decay, use_ov=use_ov, cfg=cfg)
    tau_t = torch.tensor(tau, dtype=torch.float32, device=dev)
    z = torch.where(valid, s / tau_t, -BIG)
    e = torch.where(valid, _exp(z - z.amax(1, keepdim=True)), 0.0)
    probs = e / torch.clamp_min(e.sum(1, keepdim=True), 1e-30)
    return probs.reshape(-1), torch.where(valid, s, 0.0).reshape(-1)


def segment_probs(stacked, sizes, *, seg: int, t: float, tau: float,
                  use_ov: bool, decay: float, cfg: HeteRoScoreConfig):
    """K4: per-edge probabilities and scores (see the plain version).
    ``sizes`` is the (E,) int32 member count of each slice on the operand's
    device; counts beyond ``seg`` are clamped to it. CPU tensors →
    ``segment_probs_plain``; CUDA tensors → the sm_90a kernel."""
    if seg < 1:
        raise ValueError(f"seg must be ≥ 1, got {seg}")
    num_edges = _check_stacked(stacked, seg)
    if num_edges < 1:
        raise ValueError("need at least one edge slice")
    if sizes.dtype != torch.int32 or tuple(sizes.shape) != (num_edges,) \
            or not sizes.is_contiguous() or sizes.device != stacked.device:
        raise ValueError(f"sizes must be a contiguous int32 ({num_edges},) tensor "
                         f"on {stacked.device}")
    if stacked.device.type == "cpu":
        return segment_probs_plain(stacked, sizes, seg=seg, t=t, tau=tau,
                                   use_ov=use_ov, decay=decay, cfg=cfg)
    _build.check_card(stacked.device)
    lib = _library()
    dev = stacked.device
    kpad = stacked.shape[1]
    probs = torch.empty(kpad, dtype=torch.float32, device=dev)
    scores = torch.empty(kpad, dtype=torch.float32, device=dev)
    rc = lib.hs_segment(_dtype_code(stacked), stacked.data_ptr(), sizes.data_ptr(),
                        kpad, num_edges, seg, t, tau, int(use_ov), decay,
                        ctypes.byref(_cfg_struct(cfg)), probs.data_ptr(),
                        scores.data_ptr(), _build.stream(dev))
    _raise_on(lib, rc, "segment_probs")
    LAUNCHES["segment_probs"] += 1
    return probs, scores


# ---------------------------------------------------------------------------
# The candidate merge
# ---------------------------------------------------------------------------

MAX_CLIENTS = 2**31 - 1   # candidate ids are int32


def top_candidates(cval: torch.Tensor, cidx: torch.Tensor, n: int):
    """(values, ids) of the top n of K2's candidates by value descending, then
    id ascending, in that order. The candidates must be listed in ascending
    id order, as K2 lists them (blocks in id order, each block's candidates
    by column): then a stable sort by value orders equal values by id."""
    flat = cval.reshape(-1)
    pos = torch.sort(order_keys(flat), descending=True, stable=True).indices[:n]
    return flat[pos], cidx.reshape(-1)[pos]


def merge_candidates(cval: torch.Tensor, cidx: torch.Tensor, m: int) -> torch.Tensor:
    """The cohort from K2's candidates (``top_candidates``' ids). That is the
    reference's ``lax.top_k`` over its candidate layout
    (``score_select.py:394``, :539), where a block's candidates sit by value
    then column and blocks by id, so equal values go to the smaller id.
    ``torch.topk`` on the values would leave ties unordered."""
    return top_candidates(cval, cidx, m)[1]


def candidate_keys(vals: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """One unique int64 key per candidate, ``order_keys(value)·2^32 +
    (2^31 − 1 − id)``: a larger key is a larger value, then a smaller id. K8
    gathers its shards' top candidates as such keys."""
    return (order_keys(vals).to(torch.int64) * 2**32
            + (MAX_CLIENTS - ids.to(torch.int64)))


def merge_keys(keys: torch.Tensor, m: int) -> torch.Tensor:
    """The int32 ids packed into the m largest of the unique
    ``candidate_keys``, largest first (there are no ties to break)."""
    top = torch.topk(keys.reshape(-1), m).values
    return (MAX_CLIENTS - (top & 0xFFFFFFFF)).to(torch.int32)


# ---------------------------------------------------------------------------
# The fused entry points
# ---------------------------------------------------------------------------


def _normalize(e_flat: torch.Tensor, part: torch.Tensor, nblocks: int,
               block: int) -> torch.Tensor:
    """Merge per-block (m_b, l_b) into global probabilities (flash-attention
    normalizer merge; with one block this is e / Σe)."""
    m_b = part[:, 0]
    l_b = part[:, 1]
    scale = _exp(m_b - m_b.amax())
    lglob = torch.clamp_min(torch.sum(l_b * scale), 1e-30)
    return (e_flat.view(nblocks, block) * scale[:, None] / lglob).reshape(-1)


def _pass1(stats_fn: Callable, rows, *, round_idx, tau, cfg: HeteRoScoreConfig,
           staleness_override, block: Optional[int]):
    """Pack the rows and run K1: ``(stacked, glob, nblocks, kw)``, ``kw``
    being the keyword arguments pass 2 (K2 or K3) takes."""
    k = rows[0].shape[0]
    blk, nblocks, kpad = _layout(k, block)
    stacked = _pack(rows, staleness_override, k, kpad)
    glob = _combine_stats(stats_fn(stacked, k=k, block=blk))
    t, tau, decay = _scalars(round_idx, tau, cfg)
    return stacked, glob, nblocks, dict(
        k=k, block=blk, t=t, tau=tau, use_ov=staleness_override is not None,
        decay=decay, cfg=cfg)


def _fused_select(stats_fn: Callable, select_fn: Callable, *rows, round_idx, tau,
                  m: int, gumbel: torch.Tensor, cfg: HeteRoScoreConfig,
                  staleness_override=None, block: Optional[int] = None):
    k = rows[0].shape[0]
    if not 1 <= m <= k:
        raise ValueError(f"m must be in [1, K={k}], got {m}")
    stacked, glob, nblocks, kw = _pass1(
        stats_fn, rows, round_idx=round_idx, tau=tau, cfg=cfg,
        staleness_override=staleness_override, block=block)
    blk = kw["block"]
    gpad = F.pad(gumbel.to(device=stacked.device, dtype=torch.float32),
                 (0, stacked.shape[1] - k))
    scores, e, part, cval, cidx = select_fn(stacked, glob, gpad, mb=min(m, blk), **kw)
    probs = _normalize(e, part, nblocks, blk)[:k]
    return merge_candidates(cval, cidx, m), probs, scores[:k]


def _fused_probs(stats_fn: Callable, probs_fn: Callable, *rows, round_idx, tau,
                 cfg: HeteRoScoreConfig, staleness_override=None,
                 block: Optional[int] = None):
    k = rows[0].shape[0]
    stacked, glob, nblocks, kw = _pass1(
        stats_fn, rows, round_idx=round_idx, tau=tau, cfg=cfg,
        staleness_override=staleness_override, block=block)
    scores, e, part = probs_fn(stacked, glob, **kw)
    return _normalize(e, part, nblocks, kw["block"])[:k], scores[:k]


def _segmented(segment_fn: Callable, *rows, sizes, round_idx, tau,
               cfg: HeteRoScoreConfig, seg: int, staleness_override=None):
    num_edges = len(sizes)
    k_total = num_edges * seg
    if rows[0].shape[0] != k_total:
        raise ValueError(f"edge-major operands must be (E*seg,) = ({k_total},), "
                         f"got {tuple(rows[0].shape)}")
    stacked = _pack(rows, staleness_override, k_total, k_total)
    sizes_t = torch.as_tensor(sizes).to(device=stacked.device, dtype=torch.int32)
    t, tau, decay = _scalars(round_idx, tau, cfg)
    return segment_fn(stacked, sizes_t.contiguous(), seg=seg, t=t, tau=tau,
                      use_ov=staleness_override is not None, decay=decay, cfg=cfg)


def fused_score_select(*rows, round_idx, tau, m: int, gumbel: torch.Tensor,
                       cfg: HeteRoScoreConfig, staleness_override=None,
                       block: Optional[int] = None):
    """Fused scoring + softmax + Gumbel-top-m selection through K1 and K2.

    ``rows`` are the eight (K,) state vectors in ``score_inputs`` order;
    ``gumbel`` is the (K,) f32 noise. Returns ``(selected (m,) int32,
    probs (K,), scores (K,))``; ``selected`` is ordered by perturbed value
    descending, then id ascending, as the reference's (``merge_candidates``).
    """
    return _fused_select(score_stats, score_select, *rows, round_idx=round_idx,
                         tau=tau, m=m, gumbel=gumbel, cfg=cfg,
                         staleness_override=staleness_override, block=block)


def fused_score_select_plain(*rows, round_idx, tau, m: int, gumbel: torch.Tensor,
                             cfg: HeteRoScoreConfig, staleness_override=None,
                             block: Optional[int] = None):
    """``fused_score_select`` through the plain versions of K1 and K2 on any
    device — what a kernel run is held against."""
    return _fused_select(score_stats_plain, score_select_plain, *rows,
                         round_idx=round_idx, tau=tau, m=m, gumbel=gumbel, cfg=cfg,
                         staleness_override=staleness_override, block=block)


def fused_score_probs(*rows, round_idx, tau, cfg: HeteRoScoreConfig,
                      staleness_override=None, block: Optional[int] = None):
    """Fused scores + selection probabilities for K clients through K1 and K3.

    Returns ``(probs (K,), scores (K,))``, both f32.
    """
    return _fused_probs(score_stats, score_probs, *rows, round_idx=round_idx,
                        tau=tau, cfg=cfg, staleness_override=staleness_override,
                        block=block)


def fused_score_probs_plain(*rows, round_idx, tau, cfg: HeteRoScoreConfig,
                            staleness_override=None, block: Optional[int] = None):
    """``fused_score_probs`` through the plain versions of K1 and K3."""
    return _fused_probs(score_stats_plain, score_probs_plain, *rows,
                        round_idx=round_idx, tau=tau, cfg=cfg,
                        staleness_override=staleness_override, block=block)


def segmented_score_probs(*rows, sizes, round_idx, tau, cfg: HeteRoScoreConfig,
                          seg: int, staleness_override=None):
    """Per-edge fused scoring for E edge slices in one launch of K4.

    ``rows`` are (E·seg,) edge-major: edge e's members occupy
    ``[e·seg, e·seg + sizes[e])``, the rest of each slice is padding. ``seg``
    may be any width ≥ the largest edge. Returns ``(probs, scores)`` in the
    same layout, each edge's probabilities summing to 1 and every padding
    slot 0.0.
    """
    return _segmented(segment_probs, *rows, sizes=sizes, round_idx=round_idx,
                      tau=tau, cfg=cfg, seg=seg,
                      staleness_override=staleness_override)


def segmented_score_probs_plain(*rows, sizes, round_idx, tau,
                                cfg: HeteRoScoreConfig, seg: int,
                                staleness_override=None):
    """``segmented_score_probs`` through the plain version of K4."""
    return _segmented(segment_probs_plain, *rows, sizes=sizes, round_idx=round_idx,
                      tau=tau, cfg=cfg, seg=seg,
                      staleness_override=staleness_override)


# ---------------------------------------------------------------------------
# K8: the sharded select — K1 + K2 on each client shard, collectives between
# ---------------------------------------------------------------------------

SHARD_ALIGN = 128   # a shard's width is a multiple of this (the reference's LANE)


class _GroupComm:
    """K8's all-gather over a ``torch.distributed`` process group: this
    process holds the one shard of its rank. CUDA tensors need an NCCL
    group, CPU tensors a gloo group."""

    def __init__(self, group, device: torch.device):
        import torch.distributed as dist

        self.dist, self.group = dist, group
        backend = dist.get_backend(group)
        want = {"cuda": "nccl", "cpu": "gloo"}[device.type]
        if backend != want:
            raise ValueError(f"state on {device} needs a {want} group for the "
                             f"sharded select, got {backend}")
        self.world = dist.get_world_size(group)
        self.ranks = (dist.get_rank(group),)

    def gather(self, parts):
        """One all-gather: every rank's tensor, stacked in rank order, into
        one output tensor (no per-rank copies)."""
        t = parts[0].contiguous()
        out = t.new_empty((self.world,) + tuple(t.shape))
        # all_gather_single is all_gather_into_tensor's newer name.
        gather = (getattr(self.dist, "all_gather_single", None)
                  or self.dist.all_gather_into_tensor)
        gather(out.view((-1,) + tuple(t.shape[1:])), t, group=self.group)
        return out


class _LocalComm:
    """The same all-gather over all ``world`` shards held in one process:
    what one card can check of a world size above 1."""

    def __init__(self, world: int):
        if world < 1:
            raise ValueError(f"world must be ≥ 1, got {world}")
        self.world = world
        self.ranks = range(world)

    def gather(self, parts):
        return torch.stack(parts)


def shard_layout(k: int, world: int, block: Optional[int] = None):
    """(local_k, block, nblocks, local_pad) of one of ``world`` client shards:
    ``local_k = ceil(K / (world·128))·128`` clients each, as the reference
    splits them (``score_select.py:465``), then the single-device block
    layout of that width, padded to ``local_pad``."""
    local_k = -(-k // (world * SHARD_ALIGN)) * SHARD_ALIGN
    blk, nblocks, local_pad = _layout(local_k, block)
    return local_k, blk, nblocks, local_pad


def shard_operands(rows, gumbel, staleness_override, *, rank: int, world: int,
                   block: Optional[int] = None):
    """Shard ``rank``'s operands: ``(stacked (NROWS, local_pad), gumbel
    (local_pad,), off, klim)``. Shard r holds global clients
    ``[off, klim)`` with ``off = r·local_k`` and ``klim = min(off + local_k,
    K)``, the limit clamped to the shard's own extent so its padding never
    aliases the next shard's ids (reference :487-489); a shard past K is all
    padding."""
    k = rows[0].shape[0]
    local_k, _, _, local_pad = shard_layout(k, world, block)
    off = rank * local_k
    klim = min(off + local_k, k)
    n = max(klim - off, 0)
    part = [r[off:off + n] for r in rows]
    stale = None if staleness_override is None else staleness_override[off:off + n]
    stacked = _pack(part, stale, n, local_pad)
    g = gumbel.to(device=stacked.device, dtype=torch.float32)[off:off + n]
    return stacked, F.pad(g, (0, local_pad - n)), off, klim


def _shard_stats(st: torch.Tensor) -> torch.Tensor:
    """A shard's (−lmin, lmax, hmax, Σ‖Δw‖², nobs) from its K1 table."""
    return torch.stack([-st[:, ST_LMIN].amin(), st[:, ST_LMAX].amax(),
                        st[:, ST_HMAX].amax(), st[:, ST_SUMSQ].sum(),
                        st[:, ST_NOBS].sum()])


def _global_stats(g: torch.Tensor) -> torch.Tensor:
    """(lmin, lmax, avgsq, hmax) from the (W, 5) gathered shard statistics,
    the reference's pmin/pmax/psum (:496-500), the same on every rank."""
    return torch.stack([-g[:, 0].amax(), g[:, 1].amax(),
                        g[:, 3].sum() / torch.clamp_min(g[:, 4].sum(), 1.0),
                        torch.clamp_min(g[:, 2].amax(), 1.0)])


def _shard_normalizer(part: torch.Tensor) -> torch.Tensor:
    """A shard's (M, L) = (max m_b, Σ_b l_b·exp(m_b − M)) from its K2 pairs."""
    mx = part[:, 0].amax()
    return torch.stack([mx, torch.sum(part[:, 1] * _exp(part[:, 0] - mx))])


def _global_normalizer(ml: torch.Tensor):
    """(mglob, lglob) from the (W, 2) gathered (M, L) pairs (:529-531)."""
    mglob = ml[:, 0].amax()
    return mglob, torch.clamp_min(torch.sum(ml[:, 1] * _exp(ml[:, 0] - mglob)), 1e-30)


def _shard_probs(e: torch.Tensor, part: torch.Tensor, mglob, lglob) -> torch.Tensor:
    """A shard's probabilities: its exps rescaled to the global normalizer."""
    scale = _exp(part[:, 0] - mglob)
    return (e.view(part.shape[0], -1) * scale[:, None] / lglob).reshape(-1)


def _sharded_select(stats_fn: Callable, select_fn: Callable, comm, *rows, round_idx,
                    tau, m: int, gumbel: torch.Tensor, cfg: HeteRoScoreConfig,
                    staleness_override=None, block: Optional[int] = None):
    k = rows[0].shape[0]
    if not 1 <= m <= k:
        raise ValueError(f"m must be in [1, K={k}], got {m}")
    if k > MAX_CLIENTS:
        raise ValueError(f"K={k} exceeds the int32 candidate ids ({MAX_CLIENTS})")
    local_k, blk, nblocks, _ = shard_layout(k, comm.world, block)
    t, tau, decay = _scalars(round_idx, tau, cfg)
    mb = min(m, blk)
    kw = dict(block=blk, t=t, tau=tau, use_ov=staleness_override is not None,
              decay=decay, cfg=cfg, mb=mb)
    shards = []
    for rank in comm.ranks:
        stacked, gpad, off, klim = shard_operands(
            rows, gumbel, staleness_override, rank=rank, world=comm.world, block=block)
        shards.append((stacked, gpad, off, klim,
                       stats_fn(stacked, k=klim, block=blk, off=off)))
    # Four all-gathers, each reduced alike on every rank. 1: the pass-1
    # statistics.
    glob = _global_stats(comm.gather([_shard_stats(st) for *_, st in shards]))
    outs = [select_fn(stacked, glob, gpad, k=klim, off=off, **kw)
            for stacked, gpad, off, klim, _ in shards]
    # 2: the softmax normalizer, merged over the shards' (M, L) pairs.
    mglob, lglob = _global_normalizer(
        comm.gather([_shard_normalizer(o[2]) for o in outs]))
    # 3: each shard's own top min(m, candidates), as merge keys; the same
    # merge of all of them on every rank (:537-539).
    keep = min(m, nblocks * mb)
    keys = comm.gather([candidate_keys(*top_candidates(o[3], o[4], keep))
                        for o in outs])
    selected = merge_keys(keys, m)
    # 4: probabilities and scores.
    ps = comm.gather([
        torch.stack([_shard_probs(e, part, mglob, lglob), scores])[:, :local_k]
        for scores, e, part, _, _ in outs])
    return selected, ps[:, 0].reshape(-1)[:k], ps[:, 1].reshape(-1)[:k]


def sharded_score_select(*rows, round_idx, tau, m: int, gumbel: torch.Tensor,
                         cfg: HeteRoScoreConfig, group, staleness_override=None,
                         block: Optional[int] = None):
    """K8: ``fused_score_select`` with the client axis split over the ranks
    of ``group`` (reference ``score_select.py:448``, ``sharded_score_select``).

    Every rank passes the same (K,) rows and Gumbel row (the reference draws
    that row inside, at :474); rank r scores clients
    ``[r·local_k, min((r+1)·local_k, K))`` through K1 and K2 with that
    offset (``shard_operands``). Four all-gathers stitch the shards, each
    reduced in rank order on every rank: the pass-1 statistics; each shard's
    normalizer pair (max m_b, Σ l_b·exp(m_b − max)); each shard's top
    min(m, candidates) (``top_candidates``, as the fused path's merge takes
    them) as ``candidate_keys``, merged into the cohort; and the
    probabilities and scores. Returns ``(selected (m,) int32, probs (K,),
    scores (K,))``, the same on every rank; on one rank bitwise
    ``fused_score_select``. CUDA state needs an NCCL group, CPU state a gloo
    group.
    """
    comm = _GroupComm(group, rows[0].device)
    out = _sharded_select(score_stats, score_select, comm, *rows,
                          round_idx=round_idx, tau=tau, m=m, gumbel=gumbel, cfg=cfg,
                          staleness_override=staleness_override, block=block)
    if rows[0].device.type == "cuda":   # K1 and K2 ran on the card
        SHARDED_LAUNCHES["sharded_score_select"] += 1
    return out


def sharded_score_select_plain(*rows, round_idx, tau, m: int, gumbel: torch.Tensor,
                               cfg: HeteRoScoreConfig, group,
                               staleness_override=None, block: Optional[int] = None):
    """``sharded_score_select`` through the plain versions of K1 and K2."""
    comm = _GroupComm(group, rows[0].device)
    return _sharded_select(score_stats_plain, score_select_plain, comm, *rows,
                           round_idx=round_idx, tau=tau, m=m, gumbel=gumbel, cfg=cfg,
                           staleness_override=staleness_override, block=block)


def sharded_score_select_in_process(*rows, world: int, round_idx, tau, m: int,
                                    gumbel: torch.Tensor, cfg: HeteRoScoreConfig,
                                    staleness_override=None,
                                    block: Optional[int] = None):
    """K8's arithmetic with all ``world`` shards in this process: each shard
    through K1 and K2, the collectives replaced by the same reductions over
    local tensors."""
    return _sharded_select(score_stats, score_select, _LocalComm(world), *rows,
                           round_idx=round_idx, tau=tau, m=m, gumbel=gumbel, cfg=cfg,
                           staleness_override=staleness_override, block=block)
