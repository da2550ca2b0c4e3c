"""Server-side aggregation (paper Algorithm 1, line 26).

Unweighted FedAvg over the selected subset, w_t ← (1/m) Σ_{k∈S_t} w_t^k,
as one fused reduction per leaf over the batched cohort's leading client
axis (``fedavg_fused``, which also takes |D_k| weights), or over a list of
client dicts (``fedavg``). ``params_delta_f32`` and
``apply_weighted_deltas`` are the hierarchical cloud stage and the
buffered-async server step: updates travel as f32 deltas and combine
weighted by cohort size and staleness.
``ServerMomentum`` is FedAvgM's server step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

Params = Dict[str, torch.Tensor]


def fedavg(client_params: Sequence[Params]) -> Params:
    """Unweighted mean of client parameter dicts."""
    n = float(len(client_params))
    return {k: (sum(p[k].to(torch.float32) for p in client_params) / n
                ).to(client_params[0][k].dtype)
            for k in client_params[0]}


def weighted_sum_stacked(stacked_params: Params, weights: torch.Tensor) -> Params:
    """Σ_m w_m · x_m over the leading client axis — one contraction per leaf.

    Leaves come back float32; weights are used as given.
    """
    w = weights.to(torch.float32)
    return {k: torch.tensordot(w, x.to(torch.float32), dims=1)
            for k, x in stacked_params.items()}


def fedavg_fused(stacked_params: Params,
                 weights: Optional[torch.Tensor] = None) -> Params:
    """Weighted FedAvg over a leading (M,) client axis.

    ``weights=None`` → the paper's unweighted mean; otherwise weights are
    normalized to sum to 1. Output leaves keep the input dtype.
    """
    first = next(iter(stacked_params.values()))
    m = first.shape[0]
    if weights is None:
        w = torch.full((m,), 1.0 / m, dtype=torch.float32, device=first.device)
    else:
        w = weights.to(device=first.device, dtype=torch.float32)
        w = w / torch.clamp_min(torch.sum(w), 1e-30)
    summed = weighted_sum_stacked(stacked_params, w)
    return {k: s.to(stacked_params[k].dtype) for k, s in summed.items()}


def params_delta_f32(new_params: Params, anchor: Params) -> Params:
    """Δ = new − anchor, in f32 whatever the param dtype."""
    return {k: new_params[k].to(torch.float32) - anchor[k].to(torch.float32)
            for k in anchor}


def apply_weighted_deltas(global_params: Params, deltas: Sequence[Params],
                          weights: torch.Tensor, server_lr: float = 1.0) -> Params:
    """w ← w + η_s · Σ_i w̄_i Δ_i, weights normalized to sum to 1.

    The buffered-async server step (``fed.async_engine``): each Δ_i is an
    update relative to the global version its client trained on, weighted
    by the FedBuff staleness discount. Also the hierarchical cloud stage:
    per-edge aggregates weighted by edge cohort size. Accumulation runs in
    f32; output leaves keep the param dtype.
    """
    dev = next(iter(global_params.values())).device
    w = torch.as_tensor(weights).to(device=dev, dtype=torch.float32)
    w = w / torch.clamp_min(torch.sum(w), 1e-30)

    def upd(g: torch.Tensor, ds) -> torch.Tensor:
        s = sum(wi * d.to(torch.float32) for wi, d in zip(w, ds))
        return (g.to(torch.float32) + server_lr * s).to(g.dtype)

    return {k: upd(g, [d[k] for d in deltas]) for k, g in global_params.items()}


@dataclasses.dataclass
class ServerMomentum:
    """FedAvgM: w_t = w_{t-1} − v_t,  v_t = β v_{t-1} + (w_{t-1} − w̄_t)
    (reference ``fed/server.py:125``). A beyond-paper aggregator that damps
    the round-to-round oscillation the paper measures as stability drop.
    The velocity is f32; parameters keep their dtype."""

    beta: float = 0.9
    velocity: Optional[Params] = None

    def apply(self, prev_global: Params, avg: Params) -> Params:
        delta = {k: p.to(torch.float32) - avg[k].to(torch.float32)
                 for k, p in prev_global.items()}
        if self.velocity is None:
            self.velocity = delta
        else:
            self.velocity = {k: self.beta * v + delta[k] for k, v in self.velocity.items()}
        return {k: (p.to(torch.float32) - self.velocity[k]).to(p.dtype)
                for k, p in prev_global.items()}
