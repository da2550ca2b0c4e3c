"""K5's autograd Function under ``torch.func.vmap`` (the client axis of a
cohort call) against a loop over clients, and the vmap rule that folds the
client axis into one call; the kernel's plain version against the
reference's Pallas kernel is in ``test_torch_flash.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops

from test_torch_slice import jax_compile_cache  # noqa: F401  (autouse fixture)
from test_torch_flash import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("kv_batched", [True, False], ids=["kv-batched", "kv-unbatched"])
def test_vmap_of_grad_equals_loop_over_clients(kv_batched):
    """torch.func.vmap over a client axis, composed with torch.func.grad (as
    ``fed.batched`` composes them), equals one call per client — exactly, as
    the vmap rule only folds the client axis into the batch axis. Unbatched
    k and v (``in_dims=None``, as params are at a cohort's first step) are
    broadcast."""
    n, b, s, h, kvh, d = 3, 2, 40, 4, 2, 16
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(n, b, s, h, d)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(n, b, s, kvh, d)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(n, b, s, kvh, d)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(n, b, s, h, d)).astype(np.float32))
    if not kv_batched:
        k, v = k[0], v[0]

    def loss(q, k, v, w):
        return (tops.flash_mha(q, k, v, causal=True) * w).sum()

    kv_dim = 0 if kv_batched else None
    grads = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)),
                            in_dims=(0, kv_dim, kv_dim, 0))(q, k, v, w)
    for i in range(n):
        ki, vi = (k[i], v[i]) if kv_batched else (k, v)
        one = torch.func.grad(loss, argnums=(0, 1, 2))(q[i], ki, vi, w[i])
        for got, want in zip(grads, one):
            assert torch.equal(got[i], want)


def test_vmap_folds_the_client_axis_into_one_call(monkeypatch):
    """The vmap rule calls the forward once on the folded (n·B, ...) batch."""
    calls = []
    plain = tfa.flash_attention_plain

    def counting(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return plain(q, k, v, **kw)

    monkeypatch.setattr(tfa, "flash_attention_plain", counting)
    q = torch.randn(4, 2, 8, 2, 8)
    k = torch.randn(4, 2, 8, 1, 8)
    out = torch.func.vmap(lambda q, k: tops.flash_mha(q, k, k))(q, k)
    assert calls == [(8, 8, 2, 8)]
    assert out.shape == (4, 2, 8, 2, 8)
