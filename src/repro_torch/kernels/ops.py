"""Public wrappers around the hand-written kernels."""

from __future__ import annotations

from repro_torch.core.scoring import HeteRoScoreConfig
from repro_torch.core.state import ClientState, score_inputs
from repro_torch.kernels import score_select as _ss


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
