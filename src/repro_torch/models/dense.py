"""Dense llama-family decoder (qwen2 and kin): training and eval forward.

Counterpart of ``repro.models.dense``: pre-norm GQA transformer with SwiGLU
MLP, RoPE, optional QKV bias and sliding-window attention, tied or untied
embeddings. Params are a flat dict keyed by the dotted paths of the
reference's pytree (``embed.tok_embed``, ``layers.attn.wq``, …,
``final_norm``), and every per-layer leaf is stacked on a leading (L, …)
axis as ``dense.init_params`` stacks it, so conversion is a copy.
``DenseLM`` (on the meta device) names and shapes them; the forward is a
plain function over the dict, and the reference's ``lax.scan`` over layers
is a Python loop over the stacked axis. Every activation is kept: the
reference's per-layer ``jax.checkpoint`` (remat) is not ported.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (DEFAULT_DTYPE, Params, cross_entropy,
                                       embed_tokens, gated_mlp, init_gated_mlp,
                                       init_lm_params, meta_param, rms_norm,
                                       split_layers, unembed)


def meta_decoder(module: nn.Module, cfg: ModelConfig) -> None:
    """The weights a pre-norm attention decoder has whatever its FFN: the
    embeddings, the stacked attention and norms, the final norm (on the meta
    device, under ``module``)."""
    L, d, hd = cfg.num_layers, cfg.d_model, cfg.resolved_head_dim
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    module.embed = nn.Module()
    module.embed.tok_embed = meta_param(cfg.padded_vocab, d)
    if not cfg.tie_embeddings:
        module.embed.unembed = meta_param(d, cfg.padded_vocab)
    module.layers = nn.Module()
    module.layers.attn = nn.Module()
    for name, shape in (("wq", (d, h, hd)), ("wk", (d, kvh, hd)),
                        ("wv", (d, kvh, hd)), ("wo", (h, hd, d))):
        setattr(module.layers.attn, name, meta_param(L, *shape))
    if cfg.qkv_bias:
        for name, heads in (("bq", h), ("bk", kvh), ("bv", kvh)):
            setattr(module.layers.attn, name, meta_param(L, heads, hd))
    module.layers.ln1 = meta_param(L, d, dtype=torch.float32)
    module.layers.ln2 = meta_param(L, d, dtype=torch.float32)
    module.final_norm = meta_param(d, dtype=torch.float32)


class DenseLM(nn.Module):
    """Names, shapes and dtypes of the dense decoder's weights."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        meta_decoder(self, cfg)
        L, d = cfg.num_layers, cfg.d_model
        self.layers.mlp = nn.Module()
        for name, shape in (("w_gate", (d, cfg.d_ff)), ("w_up", (d, cfg.d_ff)),
                            ("w_down", (cfg.d_ff, d))):
            setattr(self.layers.mlp, name, meta_param(L, *shape))


def init_layer(generator: torch.Generator, cfg: ModelConfig) -> Params:
    dev = generator.device
    return {
        "attn": attn.init_attention(
            generator, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias),
        "mlp": init_gated_mlp(generator, cfg.d_model, cfg.d_ff),
        "ln1": torch.ones((cfg.d_model,), dtype=torch.float32, device=dev),
        "ln2": torch.ones((cfg.d_model,), dtype=torch.float32, device=dev),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Params:
    return init_lm_params(cfg, generator, init_layer)


def _layer_body(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                lp: Dict[str, Params]) -> torch.Tensor:
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + attn.attention_block(lp["attn"], h, positions, rope_theta=cfg.rope_theta,
                                 causal=True, window=cfg.sliding_window)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + gated_mlp(lp["mlp"], h)


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Token ids (B,S) → logits (B,S,V_padded)."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = embed_tokens({"tok_embed": params["embed.tok_embed"]}, tokens).to(DEFAULT_DTYPE)
    for lp in split_layers(params, cfg.num_layers):
        x = _layer_body(cfg, x, positions, lp)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    embed = {k[len("embed."):]: v for k, v in params.items() if k.startswith("embed.")}
    return unembed(embed, x, cfg.vocab_size)


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    logits = forward(cfg, params, batch["tokens"])
    return cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
