"""Uniform model facade: ``build_model(cfg)`` dispatches to the family impl.

Same surface as ``repro.models.model`` for the ported families:

  init_params(generator)   → params dict on the generator's device
  loss(params, batch)      → scalar f32 loss
  forward(params, batch)   → logits

The resnet, dense, ssm (mamba2) and moe families are ported; decode steps
wait for the serving slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dense, mamba2, moe, resnet


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    module: torch.nn.Module
    init_params: Callable[[torch.Generator], Any]
    loss: Callable[..., torch.Tensor]
    forward: Callable[..., torch.Tensor]


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "resnet":
        module = resnet.ResNet(cfg)
        return Model(
            cfg=cfg,
            module=module,
            init_params=lambda gen: resnet.init_params(module, gen),
            loss=lambda p, b: resnet.loss_fn(module, p, b),
            forward=lambda p, b: resnet.forward(module, p, b["images"]),
        )
    if cfg.family == "dense":
        return Model(
            cfg=cfg,
            module=dense.DenseLM(cfg),
            init_params=lambda gen: dense.init_params(cfg, gen),
            loss=lambda p, b: dense.loss_fn(cfg, p, b),
            forward=lambda p, b: dense.forward(cfg, p, b["tokens"]),
        )
    if cfg.family == "ssm":
        return Model(
            cfg=cfg,
            module=mamba2.Mamba2LM(cfg),
            init_params=lambda gen: mamba2.init_params(cfg, gen),
            loss=lambda p, b: mamba2.loss_fn(cfg, p, b),
            forward=lambda p, b: mamba2.forward(cfg, p, b["tokens"]),
        )
    if cfg.family == "moe":
        return Model(
            cfg=cfg,
            module=moe.MoeLM(cfg),
            init_params=lambda gen: moe.init_params(cfg, gen),
            loss=lambda p, b: moe.loss_fn(cfg, p, b),
            forward=lambda p, b: moe.forward(cfg, p, b["tokens"])[0],
        )
    raise NotImplementedError(
        f"model family '{cfg.family}' is not ported; only 'resnet', 'dense', 'ssm' "
        "and 'moe' are")
