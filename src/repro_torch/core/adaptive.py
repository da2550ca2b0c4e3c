"""Adaptive μ controller — the paper's declared future work ("developing
adaptive hyperparameter tuning mechanisms", Sec VI), instantiated from its
own Lemma A.4 (counterpart of ``repro.core.adaptive``; numpy only):

    μ* = E·η_l·(G² + B_sel²) / ||w_0 − w*||².

All three quantities on the right are observable during training:
  * G²      ← running mean of client gradient-norm² (we reuse the update
              sqnorm metadata the server already tracks for N_k(t), scaled
              by 1/(E·η_l)² — an SGD update is ≈ E·η_l·ḡ),
  * B_sel²  ← dispersion of selected-client updates around their mean,
  * ||w−w*||² ← proxied by the global update norm trend (distance-to-go
              shrinks as updates shrink; we use an EMA of round-update
              norms times remaining rounds).

The controller clips μ to [μ_min, μ_max] and moves by at most ×2 per round
— regularization schedules must be slow relative to the selection dynamics
they stabilize.

The same machinery pattern (observe → EMA → clipped slow move) drives
`AdaptiveBudgets`, the hierarchical edge-budget controller used by the
``adaptive`` selector (heterogeneity-guided sampling, arXiv:2310.00198):
per-edge cohort utility is smoothed with the same EMA discipline and the
global cohort size m is re-apportioned across edges by largest remainder,
so Σ m_e ≤ m and 0 ≤ m_e ≤ |edge e| hold at every round by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def apportion(total: int, weights: np.ndarray, caps: np.ndarray) -> np.ndarray:
    """Largest-remainder apportionment of ``total`` integer slots.

    Each entry receives ``floor(total·w_i/Σw)`` capped at ``caps[i]``, then
    leftover slots go to the largest fractional remainders first (stable
    order on ties), never exceeding a cap. Guarantees
    ``Σ out ≤ min(total, Σ caps)`` and ``0 ≤ out_i ≤ caps_i``; with spare
    capacity the sum is exactly ``min(total, Σ caps)``.
    """
    weights = np.asarray(weights, dtype=np.float64)
    caps = np.asarray(caps, dtype=np.int64)
    if total <= 0 or weights.size == 0:
        return np.zeros_like(caps)
    total = int(min(total, caps.sum()))
    wsum = float(weights.sum())
    if wsum <= 0:
        weights = np.ones_like(weights)
        wsum = float(weights.sum())
    quota = total * weights / wsum
    base = np.minimum(np.floor(quota).astype(np.int64), caps)
    remainder = int(total - base.sum())
    order = np.argsort(-(quota - np.floor(quota)), kind="stable")
    while remainder > 0:
        progressed = False
        for e in order:
            if remainder == 0:
                break
            if base[e] < caps[e]:
                base[e] += 1
                remainder -= 1
                progressed = True
        if not progressed:  # every entry at capacity
            break
    return base


@dataclasses.dataclass
class AdaptiveMu:
    local_steps: int
    local_lr: float
    mu: float = 0.1
    mu_min: float = 0.01
    mu_max: float = 1.0
    ema: float = 0.8
    _g_sq: Optional[float] = None
    _b_sq: Optional[float] = None
    _dist_sq: Optional[float] = None

    def observe_round(self, update_sqnorms: np.ndarray,
                      rounds_remaining: int) -> float:
        """Update estimates from the selected clients' ||Δw_k||² and return μ.

        Δw_k ≈ −E·η_l·ḡ_k  ⇒  ||ḡ_k||² ≈ ||Δw_k||² / (E·η_l)².
        """
        sq = np.asarray(update_sqnorms, dtype=np.float64)
        sq = sq[sq > 0]
        if len(sq) == 0:
            return self.mu
        scale = (self.local_steps * self.local_lr) ** 2
        g_sq = float(sq.mean() / scale)
        # dispersion of updates ≈ (E·η_l)²·B_sel² (Thm III.2's b_k² proxy)
        b_sq = float(sq.std() / scale) if len(sq) > 1 else 0.0
        # distance-to-go proxy: mean per-round movement × remaining rounds
        dist_sq = float(sq.mean()) * max(rounds_remaining, 1)

        def mix(old, new):
            return new if old is None else self.ema * old + (1 - self.ema) * new

        self._g_sq = mix(self._g_sq, g_sq)
        self._b_sq = mix(self._b_sq, b_sq)
        self._dist_sq = mix(self._dist_sq, dist_sq)

        mu_star = (self.local_steps * self.local_lr
                   * (self._g_sq + self._b_sq) / max(self._dist_sq, 1e-12))
        # slow, clipped move toward μ*
        target = float(np.clip(mu_star, self.mu_min, self.mu_max))
        self.mu = float(np.clip(target, self.mu / 2, self.mu * 2))
        return self.mu


@dataclasses.dataclass
class AdaptiveBudgets:
    """Online hierarchical edge-budget controller (arXiv:2310.00198 flavor).

    Reapportions the global cohort size ``num_selected`` across edges from
    *observed* edge utility (mean cohort loss per edge) instead of the
    static size-proportional split. The slow-move contract lives in
    utility space: utilities are EMA-smoothed exactly like `AdaptiveMu`'s
    Lemma-A.4 estimates, so budgets drift gradually even when one round's
    observation spikes. A relative floor (``explore_frac`` of the mean
    smoothed utility) keeps currently-unselected edges apportionable, so a
    starved edge can win slots back when the others' utility decays.

    Invariants, held at every `budgets()` call (property-tested):
      * ``Σ m_e ≤ num_selected``  (exactly ``min(m, Σ sizes)`` in fact),
      * ``0 ≤ m_e ≤ sizes[e]``.

    Unobserved edges (no cohort arrived this round, e.g. zero budget or
    churned-out members) keep their previous smoothed utility — frozen,
    not zeroed.
    """

    num_selected: int
    sizes: np.ndarray
    ema: float = 0.8
    explore_frac: float = 0.1
    _util: Optional[np.ndarray] = None

    def __post_init__(self):
        self.sizes = np.asarray(self.sizes, dtype=np.int64)
        if self.num_selected < 0:
            raise ValueError("num_selected must be >= 0")

    @property
    def utilities(self) -> Optional[np.ndarray]:
        """Smoothed per-edge utilities (None until the first observation)."""
        return None if self._util is None else self._util.copy()

    def budgets(self) -> np.ndarray:
        """Current (E,) integer budgets under the invariants above."""
        if self._util is None:
            weights = self.sizes.astype(np.float64)
        else:
            floor = self.explore_frac * float(self._util.mean())
            weights = self.sizes * (self._util + max(floor, 1e-12))
        return apportion(self.num_selected, weights, self.sizes)

    def observe_round(self, edge_utility: np.ndarray) -> np.ndarray:
        """EMA-fold one round's per-edge utilities; returns fresh budgets.

        ``edge_utility`` is (E,) with NaN (or negative) marking edges that
        reported nothing this round — those keep their previous estimate.
        """
        u = np.asarray(edge_utility, dtype=np.float64).copy()
        observed = np.isfinite(u) & (u >= 0)
        if self._util is None:
            if observed.any():
                # seed unobserved edges at the observed mean (neutral start)
                u[~observed] = u[observed].mean()
                self._util = u
        elif observed.any():
            mixed = self.ema * self._util + (1 - self.ema) * u
            self._util = np.where(observed, mixed, self._util)
        return self.budgets()

    def state_dict(self) -> dict:
        return {"util": None if self._util is None else self._util.copy()}

    def load_state_dict(self, state: dict) -> None:
        util = state.get("util")
        self._util = None if util is None else np.asarray(util, np.float64)
