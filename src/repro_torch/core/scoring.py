"""HeteRo-Select multi-phase scoring — paper Sec III-B, Eqs (1)–(11).

The components are ``(K,)`` float32 tensors computed from
:class:`repro_torch.core.state.ClientState`, op for op as in
``repro.core.scoring``. The additive combination (Eq 1) is the champion
configuration; the multiplicative variant (Eq 2) is kept for the ablation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core.state import ClientState, staleness as _staleness, to_f32
from repro_torch.kernels._math import exp as _exp
from repro_torch.kernels._math import log as _log
from repro_torch.kernels._math import log1p as _log1p

EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class HeteRoScoreConfig:
    """Weights/hyper-parameters of the scoring function (paper defaults)."""

    w_value: float = 1.0
    w_diversity: float = 1.0
    w_momentum: float = 1.0
    w_fairness: float = 1.0
    w_staleness: float = 1.0
    w_norm: float = 1.0
    eta: float = 0.3        # fairness weight η (Eq 6)
    gamma: float = 0.7      # staleness weight γ (Eq 7)
    alpha: float = 0.5      # update-norm penalty weight α (Eq 11)
    t_max: int = 20         # max staleness bonus window T_max
    diversity_decay_rounds: int = 100  # the /100 in Eq 4 and τ(t)


def diversity_decay(round_idx, cfg: HeteRoScoreConfig) -> torch.Tensor:
    """The Eq (4) weight 2·(1 − 0.5·min(t/100, 1)), a 0-d f32 CPU tensor."""
    t = torch.tensor(round_idx, dtype=torch.float32)
    return 2.0 * (1.0 - 0.5 * torch.clamp_max(t / cfg.diversity_decay_rounds, 1.0))


def information_value(state: ClientState) -> torch.Tensor:
    """Eq (3): min-max normalized local loss; 0.5 before the first contact."""
    losses = state.loss_prev
    have = state.has_loss > 0
    big = 1e30
    lmin = torch.amin(torch.where(have, losses, big))
    lmax = torch.amax(torch.where(have, losses, -big))
    v = (losses - lmin) / (lmax - lmin + EPS)
    v = torch.clamp(v, 0.0, 1.0)
    return torch.where(have, v, 0.5)


def diversity(state: ClientState, round_idx, cfg: HeteRoScoreConfig) -> torch.Tensor:
    """Eq (4): JS(P_k || P_avg) with decaying weight."""
    return state.label_js * diversity_decay(round_idx, cfg).item()


def momentum(state: ClientState) -> torch.Tensor:
    """Eq (5): sigmoid-bounded relative loss improvement, range [-0.5, 1.5]."""
    m = (state.loss_prev2 - state.loss_prev) / (state.loss_prev2 + EPS)
    m = torch.where(state.has_momentum > 0, m, 0.0)
    return 2.0 / (1.0 + _exp(-5.0 * m)) - 0.5


def fairness(state: ClientState, cfg: HeteRoScoreConfig) -> torch.Tensor:
    """Eq (6): F_k = (1 + η · h_k / max_j h_j)^{-2} ∈ (0, 1]."""
    h = state.part_count.to(torch.float32)
    hmax = torch.clamp_min(torch.amax(h), 1.0)
    f = 1.0 + cfg.eta * h / hmax
    return 1.0 / (f * f)


def staleness_factor(state: ClientState, round_idx, cfg: HeteRoScoreConfig,
                     override: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq (7): St_k = 1 + γ · log(1 + min(Δ_k, T_max)).

    ``override`` substitutes an externally measured (K,) float Δ.
    """
    if override is None:
        delta = _staleness(state, round_idx).to(torch.float32)
    else:
        delta = torch.clamp_min(override.to(torch.float32), 0.0)
    delta = torch.clamp_max(delta, float(cfg.t_max))
    return 1.0 + cfg.gamma * _log1p(delta)


def norm_penalty(state: ClientState, cfg: HeteRoScoreConfig) -> torch.Tensor:
    """Eq (11): N_k = 1 − α·(2/(1+e^{−3·r_k}) − 1), r_k = ||Δw_k||²/avg."""
    sq = state.update_sqnorm
    have = state.has_loss > 0
    denom = torch.sum(torch.where(have, sq, 0.0)) / torch.clamp_min(
        torch.sum(have.to(torch.float32)), 1.0)
    r = torch.where(have, sq / (denom + EPS), 1.0)
    sig = 2.0 / (1.0 + _exp(-3.0 * r)) - 1.0
    return 1.0 - cfg.alpha * sig


def compute_score_components(
    state: ClientState, round_idx, cfg: HeteRoScoreConfig, *,
    staleness_override: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """All six multiplicative-form components as a dict of (K,) tensors.

    A bf16-compacted state is upcast to f32 here, so all arithmetic is f32.
    """
    state = to_f32(state)
    return {
        "value": information_value(state),
        "diversity": diversity(state, round_idx, cfg),
        "momentum": momentum(state),
        "fairness": fairness(state, cfg),
        "staleness": staleness_factor(state, round_idx, cfg, staleness_override),
        "norm": norm_penalty(state, cfg),
    }


def combine_additive(comp: Dict[str, torch.Tensor],
                     cfg: HeteRoScoreConfig) -> torch.Tensor:
    """Eq (1) with the additive transformations of Eqs (8)–(10)."""
    return (
        cfg.w_value * comp["value"]
        + cfg.w_diversity * comp["diversity"]
        + cfg.w_momentum * comp["momentum"]
        + cfg.w_fairness * (comp["fairness"] - 1.0)
        + cfg.w_staleness * (comp["staleness"] - 1.0)
        + cfg.w_norm * (comp["norm"] - 1.0)
    )


def combine_multiplicative(comp: Dict[str, torch.Tensor],
                           cfg: HeteRoScoreConfig) -> torch.Tensor:
    """Eq (2): S = (V'·D)·M·F·St·N, first factors floored at EPS."""
    vd = torch.clamp_min(comp["value"], EPS) * torch.clamp_min(comp["diversity"], EPS)
    m = torch.clamp_min(comp["momentum"] + 0.5, EPS)
    return vd * m * comp["fairness"] * comp["staleness"] * comp["norm"]


def compute_scores(state: ClientState, round_idx, cfg: HeteRoScoreConfig, *,
                   additive: bool = True,
                   staleness_override: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full HeteRo-Select score S_k(t) for every client (paper Eq 1 / Eq 2)."""
    comp = compute_score_components(state, round_idx, cfg,
                                    staleness_override=staleness_override)
    if additive:
        return combine_additive(comp, cfg)
    return combine_multiplicative(comp, cfg)


def score_bounds(cfg: HeteRoScoreConfig) -> tuple[float, float]:
    """(S_min, S_max) of the non-staleness part of the additive score, from
    the component ranges (JS ≤ log 2); Thm III.3's exploration bound
    (``core.theory``) uses them. Reference ``core/scoring.py:211``."""
    js_max = float(_log(torch.tensor(2.0)))
    s_min = (cfg.w_value * 0.0 + cfg.w_diversity * 0.0 + cfg.w_momentum * (-0.5)
             + cfg.w_fairness * (-1.0) + cfg.w_norm * (-cfg.alpha))
    s_max = (cfg.w_value * 1.0 + cfg.w_diversity * 2.0 * js_max + cfg.w_momentum * 1.5
             + cfg.w_fairness * 0.0 + cfg.w_norm * 0.0)
    return float(s_min), float(s_max)
