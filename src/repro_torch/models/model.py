"""Uniform model facade: ``build_model(cfg)`` dispatches to the family impl.

Same surface as ``repro.models.model``:

  init_params(generator)                  → params dict on the generator's device
  loss(params, batch)                     → scalar f32 loss
  forward(params, batch)                  → logits
  init_cache(batch, max_len, device)      → cache dict (decoding families)
  decode_step(params, cache, tokens, pos) → (logits, cache)
  has_decode                              → False for the encoder and resnet

Every family of the reference is ported (resnet, dense, ssm (mamba2), moe,
hybrid, encoder, vlm). The encoder's ``forward`` reads ``batch["frames"]``
(no mask, as the reference's), the vlm's ``batch["tokens"]`` and
``batch["vision_embeds"]``. ``init_cache`` puts the cache on ``device``
(``"cuda"`` unless the caller asks for the CPU; a card that is not there
raises); ``decode_step`` is pure, so ``torch.func.vmap`` maps it over
slots (``serve.ModelServer``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import dense, encoder, hybrid, mamba2, moe, resnet, vlm


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    module: torch.nn.Module
    init_params: Callable[[torch.Generator], Any]
    loss: Callable[..., torch.Tensor]
    forward: Callable[..., torch.Tensor]
    init_cache: Optional[Callable[..., Any]] = None
    decode_step: Optional[Callable[..., Any]] = None

    @property
    def has_decode(self) -> bool:
        return self.decode_step is not None


def _decode(cfg: ModelConfig, family) -> dict:
    """``init_cache`` and ``decode_step`` of a decoding family's module."""
    def init_cache(batch: int, max_len: int, device="cuda"):
        return family.init_cache(cfg, batch, max_len, device=resolve_device(device))

    def decode_step(params, cache, tokens, pos):
        return family.decode_step(cfg, params, cache, tokens, pos)

    return {"init_cache": init_cache, "decode_step": decode_step}


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
            **_decode(cfg, dense),
        )
    if cfg.family == "ssm":
        return Model(
            cfg=cfg,
            module=mamba2.Mamba2LM(cfg),
            init_params=lambda gen: mamba2.init_params(cfg, gen),
            loss=lambda p, b: mamba2.loss_fn(cfg, p, b),
            forward=lambda p, b: mamba2.forward(cfg, p, b["tokens"]),
            **_decode(cfg, mamba2),
        )
    if cfg.family == "moe":
        return Model(
            cfg=cfg,
            module=moe.MoeLM(cfg),
            init_params=lambda gen: moe.init_params(cfg, gen),
            loss=lambda p, b: moe.loss_fn(cfg, p, b),
            forward=lambda p, b: moe.forward(cfg, p, b["tokens"])[0],
            **_decode(cfg, moe),
        )
    if cfg.family == "hybrid":
        return Model(
            cfg=cfg,
            module=hybrid.HybridLM(cfg),
            init_params=lambda gen: hybrid.init_params(cfg, gen),
            loss=lambda p, b: hybrid.loss_fn(cfg, p, b),
            forward=lambda p, b: hybrid.forward(cfg, p, b["tokens"]),
            **_decode(cfg, hybrid),
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
            **_decode(cfg, vlm),
        )
    raise ValueError(f"unknown family '{cfg.family}'")
