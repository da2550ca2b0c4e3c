"""Public wrappers around the hand-written kernels (K1–K8)."""

from __future__ import annotations

import torch

from repro_torch.core.scoring import HeteRoScoreConfig
from repro_torch.core.state import ClientState, score_inputs
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import score_select as _ss
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels._math import exp as _exp


def flash_mha(q, k, v, *, causal: bool = True, window: int = 0):
    """GQA flash attention (K5). q: (B,S,H,D); k,v: (B,T,KVH,D) → (B,S,H,D).

    Unlike the reference's ``flash_mha`` there is no KV-head repeat and no
    head-major transpose: the kernel reads the model's layout through its
    strides, query head h reading KV head h // (H / KVH). Differentiable and
    vmappable (``kernels.flash_attention.FlashAttention``).
    """
    return _fa.FlashAttention.apply(q, k, v, causal, window)[0]


def grouped_matmul(xs, rhs, group_sizes, *, block_m: int = _gmm.DEFAULT_BLOCK_M):
    """Grouped matmul (K6), the reference's ``ragged_dot`` drop-in: xs (M, K)
    rows sorted by group; rhs (G, K, N); group_sizes (G,) int32. Returns
    (M, N) in xs.dtype, each row of group g times rhs[g] in f32 and rounded
    once; rows past the last group are 0. Differentiable and vmappable
    (``kernels.moe_gmm.GroupedMatmul``: a vmapped cohort is one launch).
    """
    return _gmm.GroupedMatmul.apply(xs, rhs, group_sizes, block_m)


def ssd_forward(x, dt, a_neg, b_in, c_in, *, chunk: int = 256, h0=None):
    """Full SSD: K7 for the intra-chunk part, then the cross-chunk recurrence
    and the inter-chunk correction in plain PyTorch (jnp in the reference,
    outside any Pallas kernel).

    x: (B,S,NH,HP) f32; dt: (B,S,NH) f32 post-softplus; a_neg: (NH,);
    b/c: (B,S,N); h0: (B,NH,HP,N) state entering the first chunk, or None
    for zeros. Returns (y (B,S,NH,HP) f32, h_final (B,NH,HP,N)).

    S is padded to a multiple of ``chunk`` with zeros (a padded row has
    dt = 0, so it adds nothing and leaves cum_last at the last real row's).
    The correction C_i·(e^{cum_i}·H_enter) is one einsum over N times
    e^{cum}: the reference's three-operand einsum, contracted left to right,
    would form a (B, NC, CL, N, NH) product first. With one chunk and no h0
    the state entering it is 0 and the correction is skipped (it is exactly
    0). Differentiable and vmappable (``kernels.ssd_scan.SSDChunk``).
    """
    bsz, s, nh, hp = x.shape
    n = b_in.shape[-1]
    xc, dtc, bc, cc = _ssd.to_chunks(x, dt, b_in, c_in, chunk)
    nc = xc.shape[1]
    y_intra, states, cum_last = _ssd.SSDChunk.apply(xc, dtc, a_neg.expand(bsz, nh), bc, cc)
    if nc == 1 and h0 is None:
        return y_intra[:, 0, :s], states[:, 0]

    # Cross-chunk recurrence: the state entering each chunk.
    chunk_decay = _exp(cum_last)                                 # (B, NC, NH)
    h = torch.zeros((bsz, nh, hp, n), dtype=torch.float32, device=x.device) \
        if h0 is None else h0
    h_enter = []
    for ci in range(nc):
        h_enter.append(h)
        h = chunk_decay[:, ci, :, None, None] * h + states[:, ci]
    h_enter = torch.stack(h_enter, 1)                            # (B, NC, NH, HP, N)

    cum = _ssd.chunk_cumsum(dtc * a_neg)
    y_inter = torch.einsum("bcin,bchpn->bcihp", cc, h_enter) * _exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(bsz, nc * chunk, nh, hp)
    return y[:, :s], h


def heterosel_topm(state: ClientState, round_idx, tau, m: int, gumbel,
                   cfg: HeteRoScoreConfig, *, staleness_override=None):
    """Fused scoring + softmax + Gumbel-top-m selection (K1 + K2).

    Returns ``(selected_idx (m,), probs (K,), scores (K,))``. For the same
    (K,) Gumbel noise the cohort equals ``sample_clients`` over the plain
    probabilities: ranking the unnormalized logits ranks the log-probs.
    """
    return _ss.fused_score_select(
        *score_inputs(state),
        round_idx=round_idx, tau=tau, m=m, gumbel=gumbel, cfg=cfg,
        staleness_override=staleness_override,
    )


def heterosel_topm_sharded(state: ClientState, round_idx, tau, m: int, gumbel,
                           cfg: HeteRoScoreConfig, *, group, staleness_override=None,
                           block=None):
    """``heterosel_topm`` with the client axis split over the ranks of the
    ``torch.distributed`` process group ``group`` (K8). Counterpart of the
    reference's ``ops.heterosel_topm_sharded`` (``kernels/ops.py:139``):
    ``group`` takes the place of its ``mesh, axis``, and the group's size is
    the client axis's (the reference's ``sharding/rules.axis_size``). CUDA
    state needs an NCCL group, CPU state a gloo group; a mismatch raises.
    Same return contract, the same on every rank.
    """
    return _ss.sharded_score_select(
        *score_inputs(state),
        round_idx=round_idx, tau=tau, m=m, gumbel=gumbel, cfg=cfg, group=group,
        staleness_override=staleness_override, block=block,
    )


def heterosel_probs(state: ClientState, round_idx, tau, cfg: HeteRoScoreConfig, *,
                    staleness_override=None, block=None):
    """Fused additive scoring + softmax (Eqs 1–12) through K1 and K3.

    Returns ``(probs (K,), scores (K,))``; ``block`` overrides the client
    block width (a power of two in [32, 2048]).
    """
    return _ss.fused_score_probs(
        *score_inputs(state),
        round_idx=round_idx, tau=tau, cfg=cfg,
        staleness_override=staleness_override, block=block,
    )


def heterosel_probs_segmented(state: ClientState, sizes, *, round_idx, tau,
                              cfg: HeteRoScoreConfig, seg: int,
                              staleness_override=None):
    """Per-edge fused scoring over an edge-major (E·seg,) state in one launch
    of K4 — the hierarchical engine's inner stage.

    ``state`` is laid out edge-major with ``seg``-wide slices (see
    ``fed.hierarchy``); ``sizes`` is the (E,) member count of each slice.
    Returns ``(probs, scores)`` in the same layout, 0.0 in padding slots.
    """
    return _ss.segmented_score_probs(
        *score_inputs(state),
        sizes=sizes, round_idx=round_idx, tau=tau, cfg=cfg, seg=seg,
        staleness_override=staleness_override,
    )
