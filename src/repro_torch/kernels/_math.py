"""exp and log for the port's CPU paths, without MKL's vector math.

A CPU float ``torch.exp`` or ``torch.log`` runs MKL's vector math library
(VML, the ``*_vml_cpu`` kernels). The first VML call of a process made on
several intra-op threads at once can compute one thread's share with ~1e-4
relative error (ROADMAP queue 3 (f); ``tests/test_torch_flash_threads.py
--torch-only``). ``torch.exp2`` and ``torch.special.xlogy`` do not go
through VML, so on the CPU ``exp`` is 2^(x·log2 e) and ``log`` is
xlogy(1, x), both in f64 and rounded once to x's dtype: within 1 ulp of
``torch.exp`` and ``torch.log``. On any other device they are
``torch.exp`` and ``torch.log``. Both are differentiable and vmap.
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
