"""ResNet-18 (CIFAR variant) with GroupNorm — the paper's model (Sec IV).

Counterpart of ``repro.models.resnet``: stem 3×3, 4 stages × 2 basic
blocks, widths (w, 2w, 4w, 8w) with w = cfg.d_model (64 for the paper).
The ``nn.Module`` holds no weights of its own (it lives on the meta device);
it names and shapes them, and every call goes through
``torch.func.functional_call`` with a params dict keyed as the reference's
pytree (``stem``, ``gn_stem.scale``, ``block{i}.conv1``, …, ``fc_w``,
``fc_b``). Conv weights are OIHW; images enter NHWC, as in the reference,
and run NCHW inside.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels._math import logsumexp
from repro_torch.models.layers import group_norm

Params = Dict[str, torch.Tensor]

_STAGES = ((1, 1), (2, 1), (2, 1), (2, 1))  # (first-block stride, second stride)


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of XLA's "SAME" for one spatial dimension.

    For a stride-2 3×3 conv on an even size this is (0, 1), not the
    symmetric padding=1 that torch's convs take.
    """
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NCHW conv with "SAME" padding; ``w`` is OIHW."""
    k = w.shape[-1]
    ph = _same_pads(x.shape[-2], k, stride)
    pw = _same_pads(x.shape[-1], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w.to(x.dtype), stride=stride, padding=(ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w.to(x.dtype), stride=stride)


class _GroupNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(c, device="meta"))
        self.bias = nn.Parameter(torch.empty(c, device="meta"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.scale, self.bias)


class _Block(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Parameter(torch.empty(cout, cin, 3, 3, device="meta"))
        self.gn1 = _GroupNorm(cout)
        self.conv2 = nn.Parameter(torch.empty(cout, cout, 3, 3, device="meta"))
        self.gn2 = _GroupNorm(cout)
        self.has_proj = stride != 1 or cin != cout
        if self.has_proj:
            self.proj = nn.Parameter(torch.empty(cout, cin, 1, 1, device="meta"))
            self.gn_proj = _GroupNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.gn1(_conv(x, self.conv1, self.stride)))
        y = self.gn2(_conv(y, self.conv2))
        if self.has_proj:
            x = self.gn_proj(_conv(x, self.proj, self.stride))
        return F.relu(x + y)


class ResNet(nn.Module):
    """images (B, H, W, 3) NHWC → logits (B, num_classes)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        w = cfg.d_model
        self.stem = nn.Parameter(torch.empty(w, 3, 3, 3, device="meta"))
        self.gn_stem = _GroupNorm(w)
        cin = w
        i = 0
        for stage, (s1, s2) in enumerate(_STAGES):
            cout = w * (2 ** stage)
            self.add_module(f"block{i}", _Block(cin, cout, s1)); i += 1
            self.add_module(f"block{i}", _Block(cout, cout, s2)); i += 1
            cin = cout
        self.num_blocks = i
        self.fc_w = nn.Parameter(torch.empty(cin, cfg.num_classes, device="meta"))
        self.fc_b = nn.Parameter(torch.empty(cfg.num_classes, device="meta"))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        # Contiguous NCHW: a channels-last-strided input makes the CPU
        # (oneDNN) conv backward of torch 2.13 corrupt memory at some shapes.
        x = images.to(torch.float32).permute(0, 3, 1, 2).contiguous()
        x = F.relu(self.gn_stem(_conv(x, self.stem)))
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        x = torch.mean(x, dim=(2, 3))
        return x @ self.fc_w + self.fc_b


def init_params(module: ResNet, generator: torch.Generator) -> Params:
    """Fresh weights on the generator's device, drawn as the reference draws
    them (He-normal convs, 1/√fan_in head, unit/zero GroupNorm affine) —
    from torch's stream, so not the reference's values."""
    dev = generator.device
    params: Params = {}
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            params[name] = torch.ones(p.shape, device=dev)
        elif leaf in ("bias", "fc_b"):
            params[name] = torch.zeros(p.shape, device=dev)
        elif name == "fc_w":
            params[name] = torch.randn(p.shape, generator=generator, device=dev) \
                * (1.0 / math.sqrt(p.shape[0]))
        else:  # conv, OIHW
            fan_in = p.shape[1] * p.shape[2] * p.shape[3]
            params[name] = torch.randn(p.shape, generator=generator, device=dev) \
                * math.sqrt(2.0 / fan_in)
    return params


def forward(module: ResNet, params: Params, images: torch.Tensor) -> torch.Tensor:
    return torch.func.functional_call(module, params, (images,))


def loss_fn(module: ResNet, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    logits = forward(module, params, batch["images"]).to(torch.float32)
    labels = batch["labels"].to(torch.int64)
    logz = logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    return torch.mean(logz - gold)
