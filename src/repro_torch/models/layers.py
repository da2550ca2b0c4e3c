"""Shared building blocks. Only ``group_norm`` is ported so far."""

from __future__ import annotations

import torch


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the channel axis of an NCHW tensor.

    As ``repro.models.layers.group_norm`` (which takes NHWC): ``groups``
    contiguous channel groups, statistics in f32 over (H, W, C/G), the
    population variance (``correction=0``), output in the input dtype.
    Written out with reshapes so it runs under ``torch.func.vmap``.
    """
    dt = x.dtype
    b, c, h, w = x.shape
    xf = x.to(torch.float32).reshape(b, groups, c // groups, h, w)
    var, mu = torch.var_mean(xf, dim=(2, 3, 4), correction=0, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(b, c, h, w)
    scale = weight.to(torch.float32).reshape(1, c, 1, 1)
    shift = bias.to(torch.float32).reshape(1, c, 1, 1)
    return (y * scale + shift).to(dt)
