"""Configs: model architecture and federated setup (resnet, dense, ssm and moe families)."""

from repro_torch.configs.base import ExpertShareConfig, FedConfig, ModelConfig
from repro_torch.configs.registry import expert_share, get_config, smoke_variant

__all__ = ["ExpertShareConfig", "FedConfig", "ModelConfig", "expert_share", "get_config",
           "smoke_variant"]
