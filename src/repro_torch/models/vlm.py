"""Llama-3.2-Vision-style VLM decoder: self-attention layers and a gated
cross-attention image layer every ``cross_attn_every`` layers
[hf:meta-llama/Llama-3.2-*-Vision]: training and eval forward.

Counterpart of ``repro.models.vlm``. The vision tower (ViT + projector) is
a stub, as there: the data gives projected patch embeddings (B,
vision_tokens, d_model). L layers are grouped into super-blocks of
(cross_attn_every − 1) self layers (``dense._layer_body``) and one
cross-attention layer: no RoPE, non-causal over the vision tokens (K5 with
S ≠ T), its attention and MLP residuals each scaled by tanh of a gate that
starts at 0 (so a fresh cross layer adds exactly nothing). Params are a
flat dict keyed by the reference pytree's dotted paths: ``embed.*``,
``self_layers.*`` stacked (n_super, per, …), ``cross_layers.*`` stacked
(n_super, …), ``final_norm``. Decode and ``warm_cross_cache`` wait for the
serving slice; the reference's ``jax.checkpoint`` (remat) is not ported.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import dense
from repro_torch.models.layers import (DEFAULT_DTYPE, Params, cross_entropy,
                                       embed_tokens, flatten, gated_mlp,
                                       init_embeddings, meta_param, nest, rms_norm,
                                       split_layers, unembed)


def layer_plan(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_super, self_per_super). num_layers must be divisible by the period."""
    every = cfg.cross_attn_every
    assert cfg.num_layers % every == 0, "vlm layers must tile into super-blocks"
    return cfg.num_layers // every, every - 1


class VisionLM(nn.Module):
    """Names, shapes and dtypes of the vlm decoder's weights."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        n_super, per = layer_plan(cfg)
        dense.meta_embed(self, cfg)
        self.self_layers = nn.Module()
        dense.meta_block(self.self_layers, cfg, n_super, per, qkv_bias=cfg.qkv_bias)
        self.cross_layers = nn.Module()
        dense.meta_block(self.cross_layers, cfg, n_super)
        self.cross_layers.gate_attn = meta_param(n_super, dtype=torch.float32)
        self.cross_layers.gate_mlp = meta_param(n_super, dtype=torch.float32)
        self.final_norm = meta_param(cfg.d_model, dtype=torch.float32)


def _init_cross_layer(generator: torch.Generator, cfg: ModelConfig) -> Params:
    zero = torch.zeros((), dtype=torch.float32, device=generator.device)
    return {**dense.init_block(generator, cfg), "gate_attn": zero, "gate_mlp": zero.clone()}


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Fresh weights on the generator's device, drawn as the reference draws
    them (shapes, dtypes, distributions) from torch's stream; both gates of
    every cross layer 0."""
    n_super, per = layer_plan(cfg)
    params = flatten({"embed": init_embeddings(generator, cfg.padded_vocab, cfg.d_model,
                                               cfg.tie_embeddings)})

    def stacked(prefix, layers, shape):
        return {f"{prefix}{k}": torch.stack([lp[k] for lp in layers]).reshape(
            *shape, *layers[0][k].shape) for k in layers[0]}

    params.update(stacked("self_layers.", [flatten(dense.init_layer(generator, cfg))
                                           for _ in range(n_super * per)], (n_super, per)))
    params.update(stacked("cross_layers.", [flatten(_init_cross_layer(generator, cfg))
                                            for _ in range(n_super)], (n_super,)))
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=torch.float32,
                                      device=generator.device)
    return params


def _cross_sub(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
               cp: Dict[str, Params], vision: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, cp["ln1"], cfg.norm_eps)
    y = attn.attention_block(cp["attn"], h, positions, rope_theta=cfg.rope_theta,
                             causal=False, kv_x=vision, use_rope=False)
    x = x + torch.tanh(cp["gate_attn"]).to(y.dtype) * y
    h = rms_norm(x, cp["ln2"], cfg.norm_eps)
    return x + torch.tanh(cp["gate_mlp"]).to(x.dtype) * gated_mlp(cp["mlp"], h)


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            vision_embeds: torch.Tensor) -> torch.Tensor:
    """Token ids (B,S) and vision embeddings (B,T,d) → logits (B,S,V_padded)."""
    n_super, per = layer_plan(cfg)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = embed_tokens({"tok_embed": params["embed.tok_embed"]}, tokens).to(DEFAULT_DTYPE)
    vision = vision_embeds.to(DEFAULT_DTYPE)
    selfs = split_layers(params, n_super, prefix="self_layers.", per=per) if per \
        else [[]] * n_super
    for stack, cp in zip(selfs, split_layers(params, n_super, prefix="cross_layers.")):
        for lp in stack:
            x = dense._layer_body(cfg, x, positions, lp)
        x = _cross_sub(cfg, x, positions, cp, vision)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(nest(params, "embed."), x, cfg.vocab_size)


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    logits = forward(cfg, params, batch["tokens"], batch["vision_embeds"])
    return cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
