"""Probabilistic client selection — paper Eq (12) + the uniform baseline.

HeteRo-Select: softmax over scores with dynamic temperature
τ(t) = τ0·(1 − 0.5·min(t/100, 1)), then m clients without replacement by
Gumbel-top-m. torch cannot reproduce ``jax.random``, so every selector takes
its (K,) f32 Gumbel noise as an argument: ``(gumbel, state, round_idx) ->
(selected_mask, probs)``. The engine draws it (``gumbel_noise``) or takes it
from the caller.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.scoring import HeteRoScoreConfig, compute_scores
from repro_torch.core.state import ClientState

SelectFn = Callable[[torch.Tensor, ClientState, int],
                    Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class SelectorConfig:
    """Selection-policy hyper-parameters (paper Sec III-B.6)."""

    num_selected: int = 6          # m — clients per round (50% of 12)
    tau0: float = 1.0              # base softmax temperature τ0
    tau_decay_rounds: int = 100    # the /100 in τ(t)
    additive: bool = True          # Eq (1) vs Eq (2)
    # Score + softmax + sampling through the fused kernels
    # (kernels.score_select); additive form only.
    use_fused_kernel: bool = False


def gumbel_noise(generator: torch.Generator, k: int) -> torch.Tensor:
    """(K,) standard Gumbel draws on the generator's device."""
    u = torch.rand(k, generator=generator, device=generator.device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def dynamic_temperature(round_idx, cfg: SelectorConfig) -> torch.Tensor:
    """τ(t) = τ0 · (1 − 0.5·min(t/100, 1)) as a 0-d f32 CPU tensor."""
    t = torch.tensor(float(round_idx), dtype=torch.float32)
    return cfg.tau0 * (1.0 - 0.5 * torch.clamp_max(t / cfg.tau_decay_rounds, 1.0))


def selection_probabilities(scores: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Eq (12): p_k = softmax(S_k / τ)."""
    return torch.softmax(scores / torch.as_tensor(tau).to(scores.device), dim=0)


def sample_clients(gumbel: torch.Tensor, probs: torch.Tensor, m: int) -> torch.Tensor:
    """m distinct clients ∝ probs via Gumbel-top-m; returns a (K,) bool mask."""
    perturbed = torch.log(probs + 1e-30) + gumbel.to(probs.device)
    idx = torch.topk(perturbed, m).indices
    mask = torch.zeros(probs.shape, dtype=torch.bool, device=probs.device)
    mask[idx] = True
    return mask


def heterosel_select(
    gumbel: torch.Tensor,
    state: ClientState,
    round_idx: int,
    *,
    sel_cfg: SelectorConfig,
    score_cfg: HeteRoScoreConfig,
    staleness_override: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """HeteRo-Select: Algorithm 1, phases 1–2.

    With ``sel_cfg.use_fused_kernel`` scoring, softmax and Gumbel-top-m run
    through the fused kernels (``kernels.ops.heterosel_topm``); the cohort
    equals the plain branch's for the same noise.
    """
    tau = dynamic_temperature(round_idx, sel_cfg)
    if sel_cfg.use_fused_kernel:
        if not sel_cfg.additive:
            raise ValueError("fused scoring kernel implements the additive form only")
        from repro_torch.kernels import ops as kernel_ops

        selected, probs, _ = kernel_ops.heterosel_topm(
            state, round_idx, tau, sel_cfg.num_selected, gumbel, score_cfg,
            staleness_override=staleness_override)
        mask = torch.zeros(state.num_clients, dtype=torch.bool, device=state.device)
        mask[selected.to(torch.int64)] = True
        return mask, probs
    scores = compute_scores(state, round_idx, score_cfg,
                            additive=sel_cfg.additive,
                            staleness_override=staleness_override)
    probs = selection_probabilities(scores, tau)
    return sample_clients(gumbel, probs, sel_cfg.num_selected), probs


def random_select(gumbel: torch.Tensor, state: ClientState, round_idx: int, *,
                  sel_cfg: SelectorConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform m-of-K sampling (FedAvg baseline)."""
    k = state.num_clients
    probs = torch.full((k,), 1.0 / k, dtype=torch.float32, device=state.device)
    return sample_clients(gumbel, probs, sel_cfg.num_selected), probs


def edge_selection_probs(pooled_state: ClientState, round_idx,
                         sel_cfg: SelectorConfig,
                         score_cfg: HeteRoScoreConfig) -> torch.Tensor:
    """(E,) cross-edge selection probabilities for the hierarchical outer
    stage: Eqs 1–12 on the pooled pseudo-client state
    (``core.state.pool_client_state``). Sampling stays with the caller,
    which masks busy edges before its Gumbel-top-m draw."""
    scores = compute_scores(pooled_state, round_idx, score_cfg,
                            additive=sel_cfg.additive)
    return selection_probabilities(scores, dynamic_temperature(round_idx, sel_cfg))


# Names make_selector serves; the reference's other selectors are not ported.
SELECTORS = ("heterosel", "heterosel_pallas", "heterosel_mult", "random")


def make_selector(name: str, sel_cfg: SelectorConfig,
                  score_cfg: HeteRoScoreConfig | None = None) -> SelectFn:
    """Factory over ``SELECTORS``. ``heterosel_pallas`` is the name the
    reference gives its fused-kernel branch; here it runs the CUDA kernels."""
    score_cfg = score_cfg or HeteRoScoreConfig()
    if name == "heterosel":
        return functools.partial(heterosel_select, sel_cfg=sel_cfg, score_cfg=score_cfg)
    if name == "heterosel_pallas":
        fused = dataclasses.replace(sel_cfg, use_fused_kernel=True, additive=True)
        return functools.partial(heterosel_select, sel_cfg=fused, score_cfg=score_cfg)
    if name == "heterosel_mult":
        mult = dataclasses.replace(sel_cfg, additive=False)
        return functools.partial(heterosel_select, sel_cfg=mult, score_cfg=score_cfg)
    if name == "random":
        return functools.partial(random_select, sel_cfg=sel_cfg)
    raise ValueError(f"unknown or not yet ported selector '{name}': the port "
                     f"serves {SELECTORS}")
