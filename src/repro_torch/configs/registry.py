"""Architecture registry. Only the resnet family is ported so far."""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import resnet18_cifar10
from repro_torch.configs.base import ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (resnet18_cifar10,)
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown or not yet ported arch '{arch}'; "
                       f"available: {sorted(ARCHS)}")
    return ARCHS[arch]


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (resnet: width 16)."""
    if cfg.family != "resnet":
        raise NotImplementedError(
            f"family '{cfg.family}' is not ported; only 'resnet' is")
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", d_model=16,
                               num_layers=8)
