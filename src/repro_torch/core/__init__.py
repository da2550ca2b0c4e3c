"""Core: HeteRo-Select scoring, selection and the per-client state."""

from repro_torch.core.scoring import HeteRoScoreConfig, compute_scores
from repro_torch.core.selection import SELECTORS, SelectorConfig, make_selector
from repro_torch.core.state import (ClientState, init_client_state,
                                    pool_client_state, update_client_state)

__all__ = [
    "ClientState",
    "init_client_state",
    "update_client_state",
    "pool_client_state",
    "HeteRoScoreConfig",
    "compute_scores",
    "SelectorConfig",
    "make_selector",
    "SELECTORS",
]
