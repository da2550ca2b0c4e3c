"""Batched client execution: the whole selected cohort in one call.

Counterpart of ``repro.fed.batched``: the cohort's batches are stacked on a
leading (M,) client axis and ``fed.client.local_train`` runs under
``torch.func.vmap`` over that axis, with the round's global params
broadcast to every client (``in_dims=(None, 0)``). ``train_clients_batched``
drives one round, optionally in fixed-size chunks (bounded memory at large
M), and aggregates with the fused reduction of ``fed.server``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.fed import server as fed_server
from repro_torch.fed.client import LocalResult, LossFn, Params, local_train

BatchedTrainFn = Callable[[Params, Any], LocalResult]


def stack_client_trees(trees: Sequence[dict]) -> dict:
    """[dict] * M → dict whose leaves gain a leading (M,) client axis."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def gather_stacked_batches(data: Any, selected: np.ndarray, steps: int,
                           batch: int, rng: np.random.Generator) -> dict:
    """Stacked (M, steps, batch, ...) batches for the selected clients.

    Takes the data source's vectorized ``stacked_client_batches`` where it
    has one (the lazy large-K generators make the whole cohort in one numpy
    pass); otherwise draws client by client in ``selected`` order (ascending
    ids). Either way the host RNG is consumed exactly as the reference does.
    """
    fn = getattr(data, "stacked_client_batches", None)
    if fn is not None:
        return fn(selected, steps, batch, rng)
    return stack_client_trees(
        [data.client_batches(int(k), steps, batch, rng) for k in selected])


def make_batched_local_train(loss_fn: LossFn, *, lr: float, mu: float) -> BatchedTrainFn:
    """(params, stacked_batches) → LocalResult with (M, ...) params and (M,)
    metadata: ``local_train`` vmapped over the client axis."""
    step = functools.partial(local_train, loss_fn, lr=lr, mu=mu)
    return torch.func.vmap(step, in_dims=(None, 0))


class CohortResult(NamedTuple):
    """One round's cohort outcome (client axis already reduced for params)."""

    avg_params: Params
    stacked_params: Optional[Params]   # (M, ...) per-client params (None if chunked)
    mean_loss: torch.Tensor            # (M,)
    update_sqnorm: torch.Tensor        # (M,)


def _pad_cohort(stacked_batches: dict, m: int, target: int) -> dict:
    """Pad the client axis to ``target`` by repeating client 0 (weight 0)."""
    return {k: torch.cat([x, x[:1].expand((target - m,) + tuple(x.shape[1:]))])
            for k, x in stacked_batches.items()}


def train_clients_batched(
    batched_train: BatchedTrainFn,
    params: Params,
    stacked_batches: dict,
    *,
    weights: Optional[torch.Tensor] = None,
    chunk: int = 0,
    pad_to: int = 0,
    keep_client_params: bool = False,
) -> CohortResult:
    """Train one round's cohort and fuse-aggregate its updates.

    ``chunk > 0`` runs the cohort in ⌈M/chunk⌉ calls of a fixed shape, each
    chunk's weighted parameter sum folded into the running aggregate — the
    full (M, ...) stacked params never materialize. ``pad_to > 1`` makes
    every call's client axis a multiple of it (zero-weight repeats).
    """
    m = next(iter(stacked_batches.values())).shape[0]
    if pad_to and pad_to > 1:
        if chunk:
            chunk = -(-chunk // pad_to) * pad_to
        elif m % pad_to:
            chunk = -(-m // pad_to) * pad_to  # one padded call via chunk path

    if not chunk or (chunk >= m and m % max(pad_to, 1) == 0):
        res = batched_train(params, stacked_batches)
        return CohortResult(
            avg_params=fed_server.fedavg_fused(res.params, weights),
            stacked_params=res.params if keep_client_params else None,
            mean_loss=res.mean_loss,
            update_sqnorm=res.update_sqnorm,
        )

    dev = next(iter(params.values())).device
    if weights is None:
        w = torch.full((m,), 1.0 / m, dtype=torch.float32, device=dev)
    else:
        w = weights.to(device=dev, dtype=torch.float32)
        w = w / torch.clamp_min(torch.sum(w), 1e-30)
    padded_m = -(-m // chunk) * chunk
    if padded_m != m:
        stacked_batches = _pad_cohort(stacked_batches, m, padded_m)
        w = torch.cat([w, torch.zeros(padded_m - m, dtype=torch.float32, device=dev)])

    acc: Optional[Params] = None
    losses, sqnorms = [], []
    for start in range(0, padded_m, chunk):
        sl = {k: x[start:start + chunk] for k, x in stacked_batches.items()}
        res = batched_train(params, sl)
        part = fed_server.weighted_sum_stacked(res.params, w[start:start + chunk])
        acc = part if acc is None else {k: acc[k] + part[k] for k in acc}
        losses.append(res.mean_loss)
        sqnorms.append(res.update_sqnorm)
    return CohortResult(
        avg_params={k: s.to(params[k].dtype) for k, s in acc.items()},
        stacked_params=None,
        mean_loss=torch.cat(losses)[:m],
        update_sqnorm=torch.cat(sqnorms)[:m],
    )
