"""Uniform model facade: ``build_model(cfg)`` dispatches to the family impl.

Same surface as ``repro.models.model`` for the ported families:

  init_params(generator)   → params dict on the generator's device
  loss(params, batch)      → scalar f32 loss
  forward(params, batch)   → logits

Every family of the reference is ported (resnet, dense, ssm (mamba2), moe,
hybrid, encoder, vlm); decode steps wait for the serving slice. The
encoder's ``forward`` reads ``batch["frames"]`` (no mask, as the
reference's), the vlm's ``batch["tokens"]`` and ``batch["vision_embeds"]``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dense, encoder, hybrid, mamba2, moe, resnet, vlm


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
    if cfg.family == "hybrid":
        return Model(
            cfg=cfg,
            module=hybrid.HybridLM(cfg),
            init_params=lambda gen: hybrid.init_params(cfg, gen),
            loss=lambda p, b: hybrid.loss_fn(cfg, p, b),
            forward=lambda p, b: hybrid.forward(cfg, p, b["tokens"]),
        )
    if cfg.family == "encoder":
        return Model(
            cfg=cfg,
            module=encoder.EncoderLM(cfg),
            init_params=lambda gen: encoder.init_params(cfg, gen),
            loss=lambda p, b: encoder.loss_fn(cfg, p, b),
            forward=lambda p, b: encoder.forward(cfg, p, b["frames"]),
        )
    if cfg.family == "vlm":
        return Model(
            cfg=cfg,
            module=vlm.VisionLM(cfg),
            init_params=lambda gen: vlm.init_params(cfg, gen),
            loss=lambda p, b: vlm.loss_fn(cfg, p, b),
            forward=lambda p, b: vlm.forward(cfg, p, b["tokens"], b["vision_embeds"]),
        )
    raise ValueError(f"unknown family '{cfg.family}'")
