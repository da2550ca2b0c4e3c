"""``run_federated``: the keyword entry point over ``fed.engine``.

    from repro_torch.fed import FederatedSpec
    res = FederatedSpec(model, fed, data, selector="heterosel_pallas",
                        executor="batched").build().run()

``topology='hierarchical'`` (or ``fed.topology``) with ``fed.edge_count``
runs two-tier rounds (``fed.hierarchy``); ``hier_cfg`` holds the partition
and outer-budget knobs and ``edge_noise`` the per-edge draws.
``round_policy='async'`` (or ``fed.round_policy``) runs event-driven rounds
on a virtual clock (``fed.async_engine``) with latencies from ``system`` and
knobs in ``async_cfg``; ``availability`` masks the clients offline each
round; ``adaptive_mu=True`` adds the ``'adaptive_mu'`` hook, and ``hooks``
takes more (``CheckpointHook(dir)`` for mid-run resume).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core.scoring import HeteRoScoreConfig
from repro_torch.core.selection import SelectorConfig
from repro_torch.fed.engine import EdgeNoiseFn, FederatedSpec, FLResult, NoiseFn
from repro_torch.models.model import Model


def run_federated(
    model: Model,
    fed: FedConfig,
    data: Any,
    *,
    score_cfg: Optional[HeteRoScoreConfig] = None,
    sel_cfg: Optional[SelectorConfig] = None,
    selector: Optional[str] = None,
    steps_per_round: Optional[int] = None,
    eval_fn: Optional[Callable[..., float]] = None,
    aggregator: str = "fedavg",
    client_execution: Optional[str] = None,  # None ⇒ fed.client_execution
    verbose: bool = False,
    availability: Optional[np.ndarray] = None,  # (rounds, K) bool masks
    adaptive_mu: bool = False,
    round_policy: Optional[str] = None,
    async_cfg: Optional[Any] = None,         # fed.async_engine.AsyncConfig
    system: Optional[Any] = None,            # SystemProfile | (K,) multipliers
    topology: Optional[str] = None,
    hooks: Any = (),
    device: str | torch.device = "cuda",
    noise: Optional[NoiseFn] = None,
    init_params: Optional[Dict[str, Any]] = None,
    hier_cfg: Optional[Any] = None,          # fed.hierarchy.HierarchyConfig
    edge_noise: Optional[EdgeNoiseFn] = None,
) -> FLResult:
    """Run ``fed.rounds`` federated rounds and collect the paper's metrics."""
    return FederatedSpec(
        model=model, fed=fed, data=data, selector=selector,
        score_cfg=score_cfg, sel_cfg=sel_cfg, steps_per_round=steps_per_round,
        eval_fn=eval_fn, executor=client_execution, aggregator=aggregator,
        hooks=(["adaptive_mu"] if adaptive_mu else []) + list(hooks), verbose=verbose,
        availability=availability, round_policy=round_policy, async_cfg=async_cfg,
        system=system, topology=topology, device=device,
        noise=noise, init_params=init_params,
        hier_cfg=hier_cfg, edge_noise=edge_noise,
    ).build().run()
