"""Client-side FedProx local training (paper Algorithm 1, lines 17–23).

Local objective (Eq 13):  min_w  L_k(w) + (μ/2)·||w − w_global||², by plain
SGD:  w ← w − lr·(∇L_k(w) + μ(w − w_global)). Optimizer-state-free, which is
what lets ``fed.batched`` vmap a whole cohort of visits into one call.
Params are dicts of tensors; the reference's ``lax.scan`` over steps is a
Python loop here, and gradients come from ``torch.func.vjp`` so the visit
composes with ``torch.func.vmap``. The pullback runs under ``no_grad``, so
it records no graph of the backward (``torch.func.grad`` would: it runs
every backward with ``create_graph=True``), and without ``retain_graph``,
so each saved activation is freed as soon as the backward has used it.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, NamedTuple, Tuple

import torch

Params = Dict[str, torch.Tensor]
LossFn = Callable[[Params, Dict[str, torch.Tensor]], torch.Tensor]


class LocalResult(NamedTuple):
    params: Params                # w_k after the visit
    mean_loss: torch.Tensor       # mean train loss over the visit
    last_loss: torch.Tensor       # final mini-batch loss
    update_sqnorm: torch.Tensor   # ||w_k − w_global||²


def tree_sqnorm(leaves: Iterable[torch.Tensor]) -> torch.Tensor:
    """Σ over leaves of Σ x², in the order given; pass the leaves in sorted
    key order (as JAX flattens). A generator holds one leaf at a time."""
    return sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves)


def fedprox_grad(loss_fn: LossFn, params: Params, anchor: Params, batch,
                 mu: float) -> Tuple[torch.Tensor, Params]:
    """Value and FedProx gradient: ∇L + μ(w − w_anchor). The pullback runs
    under ``no_grad``: its wrapper then calls autograd with
    ``create_graph=False``, and nothing of the backward is kept; with
    ``retain_graph=False`` the forward's saved tensors go as the backward
    consumes them, before the proximal term is formed."""
    loss, pullback = torch.func.vjp(lambda p: loss_fn(p, batch), params)
    with torch.no_grad():
        (grads,) = pullback(torch.ones_like(loss), retain_graph=False)
    del pullback
    if mu:
        grads = {k: g + mu * (params[k].to(torch.float32)
                              - anchor[k].to(torch.float32)).to(g.dtype)
                 for k, g in grads.items()}
    return loss, grads


def sgd_step(params: Params, grads: Params, lr: float) -> Params:
    return {k: (w.to(torch.float32) - lr * grads[k].to(torch.float32)).to(w.dtype)
            for k, w in params.items()}


def local_train(loss_fn: LossFn, params: Params, batches: Dict[str, torch.Tensor],
                *, lr: float, mu: float) -> LocalResult:
    """One client visit: SGD+prox over the stacked batches.

    ``batches`` leaves have a leading (num_steps,) axis. ``params`` doubles
    as the FedProx anchor w_global (the round's global model on entry).
    """
    anchor = params
    w = params
    losses = []
    steps = next(iter(batches.values())).shape[0]
    for s in range(steps):
        loss, grads = fedprox_grad(loss_fn, w, anchor,
                                   {k: v[s] for k, v in batches.items()}, mu)
        w = sgd_step(w, grads, lr)
        losses.append(loss)
    losses_t = torch.stack(losses)
    delta_sq = tree_sqnorm(w[k].to(torch.float32) - anchor[k].to(torch.float32)
                           for k in sorted(w))
    return LocalResult(params=w, mean_loss=torch.mean(losses_t),
                       last_loss=losses_t[-1], update_sqnorm=delta_sq)
