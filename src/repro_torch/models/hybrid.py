"""Zamba2-style hybrid: a Mamba2 backbone and one *shared* attention block
applied every ``shared_attn_every`` layers [arXiv:2411.15242]: training and
eval forward.

Counterpart of ``repro.models.hybrid``. For L = 81, every = 6 the layers
6, 12, …, 78 apply the shared attention block (one set of weights for all
13 applications) and the other 68 are Mamba2 blocks: 13 super-blocks of 5
Mamba2 layers and the shared block, then 3 trailing Mamba2 layers. Params
are a flat dict keyed by the reference pytree's dotted paths:
``embed.*``, ``super_mamba.*`` stacked (n_super, per, …), ``tail_mamba.*``
stacked (max(tail, 1), …), ``shared_attn.*`` unstacked, ``final_norm``.
With no trailing layer the reference still holds a one-layer
``tail_mamba`` stack that no layer reads; the port keeps that leaf (so
conversion is a copy) and its gradient is exactly 0.

The Mamba2 blocks run K7 (``mamba2.block_forward``), the shared block K5
(``attention.attention_block``): this is the one family with both kernels
in a forward. The shared block's gradient is the sum over its applications
(autograd adds the gradient of each use of the same leaf). Under
``torch.func.vmap`` each application is one K5 launch for the cohort. The
reference's ``jax.checkpoint`` (remat) is not ported; neither is decode.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import dense, mamba2
from repro_torch.models.layers import (DEFAULT_DTYPE, Params, cross_entropy,
                                       embed_tokens, flatten, gated_mlp,
                                       init_embeddings, meta_param, nest, rms_norm,
                                       split_layers, unembed)


def layer_plan(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_super, mamba_per_super, n_tail_mamba)."""
    every = cfg.shared_attn_every
    n_super = cfg.num_layers // every
    tail = cfg.num_layers - n_super * every
    return n_super, every - 1, tail


class HybridLM(nn.Module):
    """Names, shapes and dtypes of the hybrid's weights."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        n_super, per, tail = layer_plan(cfg)
        dense.meta_embed(self, cfg)
        self.super_mamba = nn.Module()
        mamba2.meta_layer(self.super_mamba, cfg, n_super, per)
        self.tail_mamba = nn.Module()
        mamba2.meta_layer(self.tail_mamba, cfg, max(tail, 1))
        self.shared_attn = nn.Module()
        dense.meta_block(self.shared_attn, cfg)
        self.final_norm = meta_param(cfg.d_model, dtype=torch.float32)


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Fresh weights on the generator's device, drawn as the reference draws
    them (shapes, dtypes, distributions) from torch's stream."""
    n_super, per, tail = layer_plan(cfg)
    params = flatten({"embed": init_embeddings(generator, cfg.padded_vocab, cfg.d_model,
                                               cfg.tie_embeddings)})

    def stacked(prefix, n):
        layers = [flatten(mamba2.init_layer(generator, cfg)) for _ in range(n)]
        return {f"{prefix}{k}": torch.stack([lp[k] for lp in layers]) for k in layers[0]}

    sup = stacked("super_mamba.", n_super * per)
    params.update({k: v.reshape(n_super, per, *v.shape[1:]) for k, v in sup.items()})
    params.update(stacked("tail_mamba.", max(tail, 1)))
    params.update(flatten({"shared_attn": dense.init_block(generator, cfg)}))
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=torch.float32,
                                      device=generator.device)
    return params


def _mamba_sub(cfg: ModelConfig, x: torch.Tensor, lp: Dict[str, Params]) -> torch.Tensor:
    h = rms_norm(x, lp["ln"], cfg.norm_eps)
    return x + mamba2.block_forward(cfg, lp["block"], h)


def _attn_sub(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
              sp: Dict[str, Params]) -> torch.Tensor:
    h = rms_norm(x, sp["ln1"], cfg.norm_eps)
    x = x + attn.attention_block(sp["attn"], h, positions, rope_theta=cfg.rope_theta,
                                 causal=True, window=cfg.sliding_window)
    h = rms_norm(x, sp["ln2"], cfg.norm_eps)
    return x + gated_mlp(sp["mlp"], h)


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Token ids (B,S) → logits (B,S,V_padded)."""
    n_super, per, tail = layer_plan(cfg)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = embed_tokens({"tok_embed": params["embed.tok_embed"]}, tokens).to(DEFAULT_DTYPE)
    shared = nest(params, "shared_attn.")
    supers = split_layers(params, n_super, prefix="super_mamba.", per=per) if per \
        else [[]] * n_super
    for stack in supers:
        for lp in stack:
            x = _mamba_sub(cfg, x, lp)
        x = _attn_sub(cfg, x, positions, shared)
    if tail:
        for lp in split_layers(params, tail, prefix="tail_mamba."):
            x = _mamba_sub(cfg, x, lp)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(nest(params, "embed."), x, cfg.vocab_size)


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    logits = forward(cfg, params, batch["tokens"])
    return cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
