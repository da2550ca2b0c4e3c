"""Closed forms from the paper's theory section (Sec III-D + Appendix A).

Counterpart of the reference's ``repro.core.theory``; library utilities
(e.g. suggesting μ via Lemma A.4) and oracles for property tests:

  * Thm III.3 — exploration lower bound ε_k(t) on selection probability.
  * Thm III.4 — FedProx local-drift bound 2E²η²(G²+B²)/(1+Eημ).
  * Lemma A.4 — optimal proximal coefficient μ*.
  * Thm III.2 / A.1 — effective heterogeneity B_sel² of a selected subset.
  * Prop A.5 — CV(softmax), the concentration of selection.
"""

from __future__ import annotations

import torch

from repro_torch.core.scoring import HeteRoScoreConfig, score_bounds
from repro_torch.core.selection import SelectorConfig, dynamic_temperature
from repro_torch.kernels._math import exp as _exp
from repro_torch.kernels._math import log1p as _log1p


def exploration_lower_bound(staleness: torch.Tensor, round_idx, sel_cfg: SelectorConfig,
                            score_cfg: HeteRoScoreConfig) -> torch.Tensor:
    """Thm III.3 / Eq (20): ε_k(t) ≤ p_k(t) for a client Δ_k rounds stale.

    ε_k = e^{(S_min + γ·log(1+Δ_k))/τ} /
          (e^{(S_min + γ·log(1+Δ_k))/τ} + (m−1)·e^{(S_max + γ·log(1+T_max))/τ})
    """
    s_min, s_max = score_bounds(score_cfg)
    tau = dynamic_temperature(round_idx, sel_cfg)
    delta = torch.clamp_max(torch.as_tensor(staleness), score_cfg.t_max).to(torch.float32)
    tau = tau.to(delta.device)
    mine = _exp((s_min + score_cfg.gamma * _log1p(delta)) / tau)
    t_max = torch.tensor(float(score_cfg.t_max), dtype=torch.float32, device=delta.device)
    other = _exp((s_max + score_cfg.gamma * _log1p(t_max)) / tau)
    return mine / (mine + (sel_cfg.num_selected - 1) * other)


def fedprox_drift_bound(local_steps: int, lr: float, mu: float, g_sq: float,
                        b_sq: float) -> float:
    """Thm III.4 / Eq (15): E||w_k^{t,E} − w_t||² ≤ 2E²η²(G²+B²)/(1+Eημ)."""
    e, eta = float(local_steps), float(lr)
    return 2.0 * e * e * eta * eta * (g_sq + b_sq) / (1.0 + e * eta * mu)


def optimal_mu(local_steps: int, lr: float, g_sq: float, b_sel_sq: float,
               dist_sq: float) -> float:
    """Lemma A.4 / Eq (21): μ* = E·η·(G² + B_sel²) / ||w0 − w*||²."""
    return float(local_steps) * float(lr) * (g_sq + b_sel_sq) / max(dist_sq, 1e-12)


def effective_heterogeneity(client_grads: torch.Tensor,
                            selected_mask: torch.Tensor) -> torch.Tensor:
    """Thm III.2 / Eq (A.1): B_sel² = (1/m) Σ_{k∈C_t} ||∇f_k − ∇f||², with
    ``client_grads`` (K, d) and ∇f the population mean (f = (1/K) Σ f_k)."""
    gbar = torch.mean(client_grads, dim=0)
    b_k = torch.sum((client_grads - gbar) ** 2, dim=-1)
    m = torch.clamp_min(torch.sum(selected_mask.to(torch.float32)), 1.0)
    return torch.sum(torch.where(selected_mask, b_k, 0.0)) / m


def population_heterogeneity(client_grads: torch.Tensor) -> torch.Tensor:
    """B² = (1/K) Σ_k ||∇f_k − ∇f||² (Assumption A4)."""
    gbar = torch.mean(client_grads, dim=0)
    return torch.mean(torch.sum((client_grads - gbar) ** 2, dim=-1))


def softmax_cv(scores: torch.Tensor, tau: float = 1.0) -> torch.Tensor:
    """Coefficient of variation of the softmax probabilities (Prop A.5
    proxy): higher means more concentrated, less fair selection. The
    standard deviation is the population one, as ``jnp.std`` takes it."""
    p = torch.softmax(scores / tau, dim=0)
    return torch.std(p, correction=0) / (torch.mean(p) + 1e-12)
