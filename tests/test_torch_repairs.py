"""The client visit's gradient and update norm, as repaired.

``fed.client.fedprox_grad`` takes its gradient through ``torch.func.vjp``
with the pullback under ``no_grad``, where it used
``torch.func.grad_and_value`` (which runs every backward with
``create_graph=True`` and so keeps a graph of it), and ``tree_sqnorm`` sums
a generator of f32 deltas, where it built all of them at once. Both are
held here, bitwise, against the visit as it was, written out below, on the
smoke variants of the three LM families under the batched executor's vmap.
The module imports no JAX.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import FedConfig
from repro_torch.configs.registry import get_config, smoke_variant
from repro_torch.data import make_lm_data
from repro_torch.fed import client as fed_client
from repro_torch.fed.batched import gather_stacked_batches
from repro_torch.models import build_model

LR, MU, CLIENTS, STEPS = 0.05, 0.1, 3, 2


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def visit_as_it_was(loss_fn, params, batches, *, lr, mu):
    """The visit before the repairs: ``grad_and_value`` and every leaf's f32
    delta held at once for ‖Δw‖²."""
    anchor, w, losses = params, params, []
    for s in range(next(iter(batches.values())).shape[0]):
        grads, loss = torch.func.grad_and_value(loss_fn)(
            w, {k: v[s] for k, v in batches.items()})
        grads = {k: g + mu * (w[k].to(torch.float32)
                              - anchor[k].to(torch.float32)).to(g.dtype)
                 for k, g in grads.items()}
        w = fed_client.sgd_step(w, grads, lr)
        losses.append(loss)
    deltas = {k: w[k].to(torch.float32) - anchor[k].to(torch.float32) for k in w}
    delta_sq = sum(torch.sum(torch.square(deltas[k])) for k in sorted(deltas))
    losses = torch.stack(losses)
    return fed_client.LocalResult(params=w, mean_loss=torch.mean(losses),
                                  last_loss=losses[-1], update_sqnorm=delta_sq)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-370m", "kimi-k2-1t-a32b"])
def test_vmapped_visit_is_bitwise_the_visit_as_it_was(arch):
    cfg = smoke_variant(get_config(arch))
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(1))
    fed = FedConfig(num_clients=CLIENTS, participation=1.0, rounds=1, local_batch=2,
                    lr=LR, mu=MU, seed=0)
    data = make_lm_data(fed, vocab=cfg.vocab_size, seq_len=16)
    batches = gather_stacked_batches(data, np.arange(CLIENTS), STEPS, 2,
                                     np.random.default_rng(0))
    run = lambda visit: torch.func.vmap(
        functools.partial(visit, model.loss, lr=LR, mu=MU), in_dims=(None, 0))(
            params, batches)
    new, old = run(fed_client.local_train), run(visit_as_it_was)
    assert torch.equal(new.mean_loss, old.mean_loss)
    assert torch.equal(new.last_loss, old.last_loss)
    assert torch.equal(new.update_sqnorm, old.update_sqnorm)
    assert new.params.keys() == old.params.keys()
    for k in new.params:
        assert torch.equal(new.params[k], old.params[k]), k
    assert bool((new.update_sqnorm > 0).all())


def test_fedprox_grad_leaves_no_graph():
    """Under ``no_grad`` nothing fedprox_grad returns carries a ``grad_fn``,
    and the gradient is the ``grad_and_value`` one."""
    cfg = smoke_variant(get_config("qwen2-0.5b"))
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(2))
    anchor = {k: v + 0.01 for k, v in params.items()}
    fed = FedConfig(num_clients=1, participation=1.0, rounds=1, local_batch=2, seed=0)
    batch = make_lm_data(fed, vocab=cfg.vocab_size, seq_len=16).client_batches(
        0, 1, 2, np.random.default_rng(0))
    batch = {k: v[0] for k, v in batch.items()}
    with torch.no_grad():
        loss, grads = fed_client.fedprox_grad(model.loss, params, anchor, batch, MU)
    assert loss.grad_fn is None and not loss.requires_grad
    assert all(g.grad_fn is None and not g.requires_grad for g in grads.values())
    want, want_loss = torch.func.grad_and_value(model.loss)(params, batch)
    assert torch.equal(loss, want_loss)
    for k, g in grads.items():
        prox = MU * (params[k].float() - anchor[k].float()).to(want[k].dtype)
        assert torch.equal(g, want[k] + prox), k


def test_tree_sqnorm_sums_a_generator_in_order():
    leaves = {"b": torch.tensor([3.0, 4.0]), "a": torch.tensor([1.0], dtype=torch.bfloat16)}
    got = fed_client.tree_sqnorm(leaves[k] for k in sorted(leaves))
    assert got.dtype == torch.float32 and float(got) == 26.0
