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

Decode (``cache_len``, ``init_cache``, ``decode_step``) runs one token
through every layer against a per-layer KV cache (``attention``'s decode
functions, plain torch as the reference's): a ring buffer of
``sliding_window`` positions when the config sets one. ``decode_step`` is
pure, so the serving tier vmaps it over its slots.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (DEFAULT_DTYPE, Params, cross_entropy,
                                       embed_tokens, gated_mlp, init_gated_mlp,
                                       init_lm_params, meta_param, nest, rms_norm,
                                       rope_tables, split_layers, unembed)


def meta_embed(module: nn.Module, cfg: ModelConfig) -> None:
    """The token embedding and, unless tied, the unembedding (meta device)."""
    module.embed = nn.Module()
    module.embed.tok_embed = meta_param(cfg.padded_vocab, cfg.d_model)
    if not cfg.tie_embeddings:
        module.embed.unembed = meta_param(cfg.d_model, cfg.padded_vocab)


def meta_block(module: nn.Module, cfg: ModelConfig, *stack: int, qkv_bias: bool = False,
               mlp: bool = True) -> None:
    """A pre-norm attention block's weights under ``module`` (meta device),
    each with the leading ``stack`` dims: attention (with QKV biases if
    ``qkv_bias``), the gated MLP if ``mlp``, and the two norms."""
    d, hd, h, kvh = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    module.attn = nn.Module()
    for name, shape in (("wq", (d, h, hd)), ("wk", (d, kvh, hd)),
                        ("wv", (d, kvh, hd)), ("wo", (h, hd, d))):
        setattr(module.attn, name, meta_param(*stack, *shape))
    if qkv_bias:
        for name, heads in (("bq", h), ("bk", kvh), ("bv", kvh)):
            setattr(module.attn, name, meta_param(*stack, heads, hd))
    if mlp:
        module.mlp = nn.Module()
        for name, shape in (("w_gate", (d, cfg.d_ff)), ("w_up", (d, cfg.d_ff)),
                            ("w_down", (cfg.d_ff, d))):
            setattr(module.mlp, name, meta_param(*stack, *shape))
    module.ln1 = meta_param(*stack, d, dtype=torch.float32)
    module.ln2 = meta_param(*stack, d, dtype=torch.float32)


def meta_decoder(module: nn.Module, cfg: ModelConfig, mlp: bool = False) -> None:
    """The weights of a pre-norm attention decoder (on the meta device,
    under ``module``): the embeddings, the stacked attention and norms (and
    the gated MLP if ``mlp``), the final norm."""
    meta_embed(module, cfg)
    module.layers = nn.Module()
    meta_block(module.layers, cfg, cfg.num_layers, qkv_bias=cfg.qkv_bias, mlp=mlp)
    module.final_norm = meta_param(cfg.d_model, dtype=torch.float32)


class DenseLM(nn.Module):
    """Names, shapes and dtypes of the dense decoder's weights."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        meta_decoder(self, cfg, mlp=True)


def init_block(generator: torch.Generator, cfg: ModelConfig, qkv_bias: bool = False
               ) -> Params:
    """One pre-norm attention block as the reference initialises it: the
    attention (QKV biases if ``qkv_bias``), the gated MLP, norms of 1."""
    dev = generator.device
    return {
        "attn": attn.init_attention(
            generator, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, qkv_bias=qkv_bias),
        "mlp": init_gated_mlp(generator, cfg.d_model, cfg.d_ff),
        "ln1": torch.ones((cfg.d_model,), dtype=torch.float32, device=dev),
        "ln2": torch.ones((cfg.d_model,), dtype=torch.float32, device=dev),
    }


def init_layer(generator: torch.Generator, cfg: ModelConfig) -> Params:
    return init_block(generator, cfg, cfg.qkv_bias)


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


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Effective cache length: the sliding window bounds it when set."""
    return min(cfg.sliding_window, max_len) if cfg.sliding_window else max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> Params:
    return attn.init_kv_cache(cfg.num_layers, batch, cache_len(cfg, max_len),
                              cfg.num_kv_heads, cfg.resolved_head_dim, device=device)


def embed_one(params: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """The token embedding of (B, S) ids in ``dtype`` (the caller's
    ``DEFAULT_DTYPE``)."""
    return embed_tokens({"tok_embed": params["embed.tok_embed"]}, tokens).to(dtype)


def logits_out(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Final norm and unembedding of a decode step: (B, 1, d) → (B, 1, V_padded)."""
    return unembed(nest(params, "embed."), rms_norm(x, params["final_norm"], cfg.norm_eps),
                   cfg.vocab_size)


def position_tables(cfg: ModelConfig, pos, device):
    """``pos`` as an int64 tensor and its RoPE tables, made once per step."""
    pos = attn.as_index(pos, device)
    return pos, rope_tables(pos.reshape(1), cfg.resolved_head_dim, cfg.rope_theta)


def decode_block(cfg: ModelConfig, lp: Dict[str, Params], x: torch.Tensor,
                 ck: torch.Tensor, cv: torch.Tensor, pos, rope,
                 ffn=None) -> Tuple[torch.Tensor, ...]:
    """One pre-norm decoder layer at decode: attention against the layer's
    KV cache (``rope``: the step's ``position_tables``), then ``ffn(lp, h)``
    (the layer's ``gated_mlp`` when None, or the MoE FFN). Returns (x, new k
    cache, new v cache)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    y, ck, cv = attn.decode_attention_block(lp["attn"], h, ck, cv, pos,
                                            rope_theta=cfg.rope_theta,
                                            ring=bool(cfg.sliding_window), rope=rope)
    x = x + y
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + (gated_mlp(lp["mlp"], h) if ffn is None else ffn(lp, h)), ck, cv


def decode_layers(cfg: ModelConfig, params: Params, cache: Params, tokens: torch.Tensor,
                  pos, ffn, dtype) -> Tuple[torch.Tensor, Params]:
    """A decode step of the dense layer stack with ``ffn`` as each layer's
    FFN (``decode_block``'s: None for the dense family, the MoE FFN),
    activations in ``dtype`` (the family's ``DEFAULT_DTYPE``): tokens (B,1)
    at ``pos`` → (logits (B,1,V_padded), new cache)."""
    x = embed_one(params, tokens, dtype)
    pos, rope = position_tables(cfg, pos, x.device)
    ks, vs = [], []
    for lp, ck, cv in zip(split_layers(params, cfg.num_layers), cache["k"].unbind(0),
                          cache["v"].unbind(0)):
        x, ck, cv = decode_block(cfg, lp, x, ck, cv, pos, rope, ffn)
        ks.append(ck)
        vs.append(cv)
    return logits_out(cfg, params, x), {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step(cfg: ModelConfig, params: Params, cache: Params, tokens: torch.Tensor,
                pos) -> Tuple[torch.Tensor, Params]:
    """One decode step: tokens (B,1) at position ``pos`` → (logits, cache')."""
    return decode_layers(cfg, params, cache, tokens, pos, None, DEFAULT_DTYPE)
