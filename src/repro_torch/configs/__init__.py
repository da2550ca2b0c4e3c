"""Configs: model architecture and federated setup (resnet, dense and ssm families)."""

from repro_torch.configs.base import FedConfig, ModelConfig
from repro_torch.configs.registry import get_config, smoke_variant

__all__ = ["FedConfig", "ModelConfig", "get_config", "smoke_variant"]
