"""Adversarial scenario layer: named, seeded stress conditions for the
selector zoo. Counterpart of ``repro.fed.scenarios`` (numpy only).

The paper's Table-1 story (peak / final / stability drop) is measured under
benign conditions; production federations are not benign. Each scenario
here is a *pure config* — a frozen `ScenarioConfig` that, given the
federation's `FedConfig`, builds exactly the extra pieces a
`fed.engine.FederatedSpec` composes with, and nothing else:

  * ``baseline``    — nothing: the benign control cell.
  * ``churn``       — Markov client availability (`fed.availability.
    AvailabilityTrace`): every selector's cohort is re-masked onto the
    online set each round, flat and hierarchical alike.
  * ``stragglers``  — a log-normal device-speed profile (`fed.availability.
    SystemProfile`) feeding the async engine's virtual clock (sync engines
    have no wall clock to apply it to — `needs_clock` flags the
    constraint; the matrix runner marks those cells unsupported).
  * ``drift``       — label-distribution drift: clients' Dirichlet skew
    rotates every ``drift_period`` rounds (`data.synthetic.
    DriftingVisionFedData`), advanced by a `LabelDriftHook` riding the
    engine's round loop.

Everything is seeded: two builds of the same config produce bitwise
identical availability masks, speed profiles and drift datasets, so
scenario cells are as checkpoint-resumable and replayable as benign runs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.configs.base import FedConfig
from repro_torch.fed.availability import AvailabilityTrace, SystemProfile
from repro_torch.fed.engine import RoundHook

SCENARIOS = ("baseline", "churn", "stragglers", "drift")


class LabelDriftHook(RoundHook):
    """Advances a drift-capable dataset's clock at every round start.

    Idempotent and stateless (the round index is the whole state, and the
    engine checkpoints that), so resumed runs re-position the drift clock
    correctly without any hook state of their own.
    """

    # Run before same-priority hooks (e.g. CheckpointHook) so anything that
    # snapshots or reads the dataset this round sees the drifted state.
    priority = 5

    def __init__(self, data: Any):
        if not hasattr(data, "set_round"):
            raise TypeError(
                "LabelDriftHook needs a drift-capable dataset with "
                "set_round(t), e.g. data.synthetic.DriftingVisionFedData")
        self.data = data

    def on_round_start(self, ctx) -> None:
        self.data.set_round(ctx.round_idx)


@dataclasses.dataclass
class BuiltScenario:
    """The concrete pieces one scenario contributes to a FederatedSpec."""

    config: "ScenarioConfig"
    availability: Optional[np.ndarray] = None   # (rounds, K) bool
    system: Optional[SystemProfile] = None
    hooks: Tuple[RoundHook, ...] = ()
    data: Any = None

    def spec_kwargs(self) -> Dict[str, Any]:
        """Keyword arguments to merge into the FederatedSpec call (only the
        fields this scenario actually sets; ``hooks`` and ``data`` are
        exposed as attributes because the caller owns their composition)."""
        kw: Dict[str, Any] = {}
        if self.availability is not None:
            kw["availability"] = self.availability
        if self.system is not None:
            kw["system"] = self.system
        return kw


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """One named adversarial condition; `build` makes it concrete."""

    name: str
    # churn: Markov on/off chain per client
    p_stay_online: float = 0.7
    p_come_online: float = 0.4
    # stragglers: log-normal sigma of per-client latency multipliers
    straggler_sigma: float = 1.0
    # drift: rotate each client's label skew by drift_shift classes every
    # drift_period rounds
    drift_period: int = 10
    drift_shift: int = 3
    seed: int = 0

    def __post_init__(self):
        if self.name not in SCENARIOS:
            raise ValueError(
                f"unknown scenario '{self.name}': valid names are {SCENARIOS}")

    @property
    def needs_clock(self) -> bool:
        """True if this scenario only composes with the async virtual clock."""
        return self.name == "stragglers"

    def build(self, fed: FedConfig, *, data: Any = None,
              data_kwargs: Optional[Dict[str, Any]] = None) -> BuiltScenario:
        """Materialize the scenario for one federation.

        ``data`` is passed through untouched for every scenario except
        ``drift``, which either wraps a drift-capable dataset you provide
        (anything with ``set_round``) or synthesizes its own
        `DriftingVisionFedData` from ``data_kwargs`` (sizing knobs for
        `make_drifting_vision_data`).
        """
        if self.name == "baseline":
            return BuiltScenario(config=self, data=data)
        if self.name == "churn":
            masks = AvailabilityTrace(
                fed.num_clients,
                p_stay_online=self.p_stay_online,
                p_come_online=self.p_come_online,
                seed=self.seed,
            ).masks(fed.rounds)
            return BuiltScenario(config=self, availability=masks, data=data)
        if self.name == "stragglers":
            profile = SystemProfile(fed.num_clients,
                                    sigma=self.straggler_sigma,
                                    seed=self.seed)
            return BuiltScenario(config=self, system=profile, data=data)
        # drift
        if data is not None and not hasattr(data, "set_round"):
            raise ValueError(
                "the 'drift' scenario needs a drift-capable dataset "
                "(set_round); pass data=None to have it build one via "
                "make_drifting_vision_data(**data_kwargs)")
        if data is None:
            # Deferred: data.synthetic imports fed.partition, so importing
            # it at module scope would be circular via fed/__init__.
            from repro_torch.data.synthetic import make_drifting_vision_data

            data = make_drifting_vision_data(
                fed, drift_period=self.drift_period,
                drift_shift=self.drift_shift, seed=self.seed,
                **(data_kwargs or {}))
        return BuiltScenario(config=self, data=data,
                             hooks=(LabelDriftHook(data),))


def make_scenario(name: str, seed: int = 0, **overrides) -> ScenarioConfig:
    """Registry constructor; unknown names fail listing ``SCENARIOS``."""
    return ScenarioConfig(name=name, seed=seed, **overrides)
