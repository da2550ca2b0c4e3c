"""PyTorch/CUDA port of the HeteRo-Select federation (``repro`` on JAX/TPU).

The module layout mirrors ``repro``: each module here is the counterpart of
the module of the same path there. The port imports ``torch`` and numpy,
never ``jax`` and nothing of ``repro``. Public entry points run on
``device="cuda"`` unless the caller passes ``device="cpu"``; a CUDA run on
a machine without a card raises (``repro_torch.device.resolve_device``).

The public API re-exports the pieces a user composes, as ``repro`` does:

    from repro_torch import (
        ClientState, compute_scores, sample_clients, make_selector,
        optimal_mu,
    )
"""

from repro_torch.core.scoring import (
    HeteRoScoreConfig,
    combine_additive,
    combine_multiplicative,
    compute_score_components,
    compute_scores,
)
from repro_torch.core.selection import (
    SelectorConfig,
    dynamic_temperature,
    make_selector,
    sample_clients,
    selection_probabilities,
)
from repro_torch.core.state import ClientState, init_client_state
from repro_torch.core.theory import (
    exploration_lower_bound,
    fedprox_drift_bound,
    optimal_mu,
)

__version__ = "1.0.0"

__all__ = [
    "ClientState",
    "init_client_state",
    "HeteRoScoreConfig",
    "compute_score_components",
    "combine_additive",
    "combine_multiplicative",
    "compute_scores",
    "SelectorConfig",
    "dynamic_temperature",
    "selection_probabilities",
    "sample_clients",
    "make_selector",
    "exploration_lower_bound",
    "fedprox_drift_bound",
    "optimal_mu",
]
