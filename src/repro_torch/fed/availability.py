"""Client availability and system heterogeneity — relaxing Assumption A5.

Counterpart of ``repro.fed.availability``. The paper assumes every client is
available every round (A5); a production federation churns. This module
provides

  * ``AvailabilityTrace`` — per-round availability masks from a two-state
    (online/offline) Markov model, the standard churn simulator;
  * ``SystemProfile`` — per-client speed multipliers (compute × network),
    for Oort's system utility and the asynchronous engine's latencies;
  * ``mask_selector`` / ``mask_async_selector`` — wrap any selector so that
    unavailable clients get zero probability and the m slots are re-sampled
    over the available ones, while the metadata (the staleness of Eq 7)
    keeps accruing.

The re-sample takes its Gumbel row from the round's draws under the name
``"remask"`` (``core.selection.DRAW_NAMES``), the reference's
``gumbel(fold_in(key, 1), (K,))``; the wrapped selector gets the rest of the
draws as it would without the wrapper. The masks and the re-sample run
outside the kernels, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import numpy as np
import torch

from repro_torch.core.selection import (AsyncSelectFn, Draws, SelectFn, named_draw,
                                        sample_clients)


@dataclasses.dataclass
class AvailabilityTrace:
    """Two-state Markov churn: P(stay online)=p_oo, P(come online)=p_fo."""

    num_clients: int
    p_stay_online: float = 0.9
    p_come_online: float = 0.6
    seed: int = 0

    def masks(self, rounds: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        m = np.zeros((rounds, self.num_clients), bool)
        state = rng.uniform(size=self.num_clients) < 0.8
        for t in range(rounds):
            # guarantee a quorum: if fewer than 2 online, wake two at random
            if state.sum() < 2:
                state[rng.integers(0, self.num_clients, size=2)] = True
            m[t] = state
            p = np.where(state, self.p_stay_online, self.p_come_online)
            state = rng.uniform(size=self.num_clients) < p
        return m


@dataclasses.dataclass
class SystemProfile:
    """Per-client wall-clock multipliers (compute × network), log-normal."""

    num_clients: int
    sigma: float = 0.5
    seed: int = 0

    def speeds(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        return np.exp(rng.normal(0.0, self.sigma, self.num_clients))

    def round_time(self, selected_mask: np.ndarray) -> float:
        """Synchronous round ⇒ the straggler sets the pace."""
        sp = self.speeds()
        sel = np.flatnonzero(selected_mask)
        return float(sp[sel].max()) if len(sel) else 0.0


def split_remask(draws: Draws) -> Tuple[Draws, torch.Tensor]:
    """(the wrapped selector's draws, the re-sample's Gumbel row). The
    selector's draws are the bare Gumbel row when that is all that is left."""
    remask = named_draw(draws, "remask")
    rest = {n: v for n, v in draws.items() if n != "remask"}
    return (rest["gumbel"] if set(rest) == {"gumbel"} else rest), remask


def remask(gumbel: torch.Tensor, probs: torch.Tensor, avail, num_selected: int):
    """Zero the unavailable clients' mass and re-sample the m slots.

    ``avail`` is the round's (K,) bool mask. If the selector's mass vanished
    the re-sample is uniform over the available clients; with fewer than m
    online the overflow picks are stripped by the final mask (a short round).
    Returns ``(mask, probs)``.
    """
    m = num_selected or int(probs.shape[0] // 2)
    avail = torch.as_tensor(avail).to(device=probs.device, dtype=torch.bool)
    probs = torch.where(avail, probs, 0.0)
    norm = torch.sum(probs)
    probs = torch.where(norm > 1e-9, probs / torch.clamp_min(norm, 1e-9),
                        avail.to(torch.float32) / torch.clamp_min(torch.sum(avail), 1))
    return sample_clients(gumbel, probs, m) & avail, probs


def mask_selector(select: SelectFn, availability: np.ndarray,
                  num_selected: int = 0) -> SelectFn:
    """Restrict any selector to the available set A_t.

    ``availability``: (rounds, K) bool. Unavailable clients get zero
    probability and the m slots are re-sampled from the available
    distribution (``remask``). The round's draws must hold ``"remask"``.
    """
    availability = np.asarray(availability, bool)

    def wrapped(draws: Mapping, state, round_idx):
        inner, g = split_remask(draws)
        _, probs = select(inner, state, round_idx)
        return remask(g, probs, availability[round_idx], num_selected)

    return wrapped


def mask_async_selector(select: AsyncSelectFn, availability: np.ndarray,
                        num_selected: int = 0) -> AsyncSelectFn:
    """``mask_selector`` for the asynchronous engine's 4-argument selectors.

    The clock-measured staleness passes through to the wrapped selector, so
    an offline client keeps accruing real staleness and gets the Eq-7
    freshness bonus the moment it reappears in A_t.
    """
    availability = np.asarray(availability, bool)

    def wrapped(draws: Mapping, state, round_idx, staleness):
        inner, g = split_remask(draws)
        _, probs = select(inner, state, round_idx, staleness)
        return remask(g, probs, availability[round_idx], num_selected)

    return wrapped
