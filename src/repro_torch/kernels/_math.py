"""exp, log, log1p and logsumexp for the port's CPU paths, without MKL's
vector math.

A CPU float ``torch.exp``, ``torch.log``, ``torch.log1p`` or
``torch.logsumexp`` runs MKL's vector math library (VML, the ``*_vml_cpu``
kernels). The first VML call of a process made on several intra-op threads
at once can compute one thread's share with ~1e-4 relative error (ROADMAP
queue 3 (f); ``tests/test_torch_flash_threads.py --torch-only``).
``torch.exp2`` and ``torch.special.xlogy`` do not go through VML, so on the
CPU ``exp`` is 2^(x·log2 e) and ``log`` is xlogy(1, x), both in f64 and
rounded once to x's dtype: within 1 ulp of ``torch.exp`` and ``torch.log``.
``log1p`` and ``logsumexp`` are built from them in f64 the same way. On any
other device each is the ``torch`` function of its name. All are
differentiable and vmap.
"""

from __future__ import annotations

import torch

LOG2E = 1.4426950408889634


def exp(x: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cpu":
        return torch.exp(x)
    return torch.exp2(x.double() * LOG2E).to(x.dtype)


def log(x: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cpu":
        return torch.log(x)
    return torch.special.xlogy(1.0, x.double()).to(x.dtype)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """log(1 + x). On the CPU in f64 as log(u)·x / (u − 1) with u = 1 + x
    (exact where u = 1: x itself; the quotient restores the low bits of x
    that 1 + x drops), rounded once to x's dtype."""
    if x.device.type != "cpu":
        return torch.log1p(x)
    xd = x.double()
    u = 1.0 + xd
    d = u - 1.0
    exact = (d == 0) | torch.isinf(u)
    safe = torch.where(exact, 1.0, d)
    out = torch.where(d == 0, xd, torch.where(
        exact, torch.special.xlogy(1.0, u), torch.special.xlogy(1.0, u) * (xd / safe)))
    return out.to(x.dtype)


def logsumexp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """log Σ exp(x) over ``dim``. On the CPU in f64 around the detached row
    max (0 where the max is not finite, as ``torch.logsumexp`` does), rounded
    once to x's dtype; its gradient is the softmax, as there."""
    if x.device.type != "cpu":
        return torch.logsumexp(x, dim=dim)
    xd = x.double()
    m = torch.amax(xd, dim=dim, keepdim=True).detach()
    m = torch.where(torch.isfinite(m), m, 0.0)
    s = torch.sum(torch.exp2((xd - m) * LOG2E), dim=dim)
    return (torch.special.xlogy(1.0, s) + m.squeeze(dim)).to(x.dtype)
