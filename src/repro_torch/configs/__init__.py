"""Configs: model architectures, input shapes and federated setup."""

from repro_torch.configs.base import ExpertShareConfig, FedConfig, ModelConfig, ShapeConfig
from repro_torch.configs.registry import (ARCHS, ASSIGNED, expert_share, get_config,
                                          get_shape, list_archs, smoke_variant)

__all__ = ["ARCHS", "ASSIGNED", "ExpertShareConfig", "FedConfig", "ModelConfig",
           "ShapeConfig", "expert_share", "get_config", "get_shape", "list_archs",
           "smoke_variant"]
