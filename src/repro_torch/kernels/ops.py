"""Public wrappers around the hand-written kernels (K1–K5)."""

from __future__ import annotations

from repro_torch.core.scoring import HeteRoScoreConfig
from repro_torch.core.state import ClientState, score_inputs
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import score_select as _ss


def flash_mha(q, k, v, *, causal: bool = True, window: int = 0):
    """GQA flash attention (K5). q: (B,S,H,D); k,v: (B,T,KVH,D) → (B,S,H,D).

    Unlike the reference's ``flash_mha`` there is no KV-head repeat and no
    head-major transpose: the kernel reads the model's layout through its
    strides, query head h reading KV head h // (H / KVH). Differentiable and
    vmappable (``kernels.flash_attention.FlashAttention``).
    """
    return _fa.FlashAttention.apply(q, k, v, causal, window)[0]


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
