"""Mixture-of-Experts decoder (Kimi-K2, Grok-1): training and eval forward.

Counterpart of ``repro.models.moe`` without a mesh: the dense decoder's
pre-norm GQA attention (through K5) with a dropless top-k MoE FFN in place
of the MLP, the experts' SwiGLU run as three grouped matmuls (K6,
``ops.grouped_matmul``) where the reference calls ``jax.lax.ragged_dot``.
Params are a flat dict keyed by the dotted paths of the reference's pytree
(``layers.moe.router``, ``layers.moe.w_gate``, …), every per-layer leaf
stacked on a leading (L, …) axis, so conversion is a copy.

A config may hold one device's share of the experts (``ExpertShareConfig``,
``cfg.expert_range``): the expert weights hold only those experts, the router
still scores all ``num_experts`` and routes top-k over them, and a pair
whose expert is absent adds nothing. That is the per-shard expert set of
the reference's expert-parallel ``_moe_ffn_a2a``, run without its
all-to-all: what the absent experts would add is not computed here.

Not ported, each raising ``NotImplementedError`` where reached: the mesh
paths (``_moe_ffn_a2a`` and the shard_map layouts), remat and decode.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import grouped_matmul
from repro_torch.models import attention as attn
from repro_torch.models.dense import meta_decoder
from repro_torch.models.layers import (DEFAULT_DTYPE, Params, cross_entropy, dense_init,
                                       embed_tokens, init_lm_params, meta_param, rms_norm,
                                       split_layers, unembed)

AUX_COEF = 0.01


class MoeLM(nn.Module):
    """Names, shapes and dtypes of the MoE decoder's weights."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        meta_decoder(self, cfg)
        L, d, f, e = cfg.num_layers, cfg.d_model, cfg.d_ff, len(cfg.expert_range)
        self.layers.moe = nn.Module()
        self.layers.moe.router = meta_param(L, d, cfg.num_experts, dtype=torch.float32)
        for name, shape in (("w_gate", (e, d, f)), ("w_up", (e, d, f)), ("w_down", (e, f, d))):
            setattr(self.layers.moe, name, meta_param(L, *shape))


def init_moe_ffn(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """Router (d, E) in f32 over all experts; expert weights in bf16 for the
    experts here only."""
    e, d, f = len(cfg.expert_range), cfg.d_model, cfg.d_ff
    return {
        "router": dense_init(generator, (d, cfg.num_experts), dtype=torch.float32),
        "w_gate": dense_init(generator, (e, d, f), in_axis=1, dtype=DEFAULT_DTYPE),
        "w_up": dense_init(generator, (e, d, f), in_axis=1, dtype=DEFAULT_DTYPE),
        "w_down": dense_init(generator, (e, f, d), in_axis=1, dtype=DEFAULT_DTYPE),
    }


def _route(router: torch.Tensor, x_flat: torch.Tensor,
           k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing. Returns (gates [T,k] f32, experts [T,k] int64, aux).

    Top-k in ``lax.top_k``'s order: descending, the lower index first among
    equal probabilities (a stable descending sort; ``torch.topk`` does not
    promise that order on ties)."""
    logits = x_flat.to(torch.float32) @ router              # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :k], experts[:, :k]
    gates = gates / torch.clamp_min(torch.sum(gates, dim=-1, keepdim=True), 1e-9)
    # Switch-style load-balance aux: E * Σ_e (frac tokens to e) · (mean prob e)
    e = probs.shape[-1]
    sel = (experts[:, :1] == torch.arange(e, device=probs.device)).to(torch.float32)
    aux = e * torch.mean(torch.mean(sel, dim=0) * torch.mean(probs, dim=0))
    return gates, experts, aux


def _grouped_ffn(xs: torch.Tensor, group_sizes: torch.Tensor, wg: torch.Tensor,
                 wu: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """SwiGLU through per-expert weights: three K6 grouped matmuls, the gate
    in f32 between them and one cast back (rows past the last group stay 0)."""
    g = grouped_matmul(xs, wg, group_sizes)
    u = grouped_matmul(xs, wu, group_sizes)
    g32 = g.to(torch.float32)
    h = (g32 * torch.sigmoid(g32) * u.to(torch.float32)).to(xs.dtype)
    return grouped_matmul(h, wd, group_sizes)


def _moe_ffn_local(cfg: ModelConfig, lp: Params, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_moe_ffn_local`` with no mesh axes, on the experts
    here. x: (B, S, d). Returns (out (B, S, d), aux)."""
    b, s, d = x.shape
    k = cfg.num_experts_per_tok
    here = cfg.expert_range
    t = b * s
    x_flat = x.reshape(t, d)
    gates, experts, aux = _route(lp["router"], x_flat, k)

    # Pairs sorted by their expert here, as jnp.argsort (stable) sorts them;
    # a pair whose expert is absent sorts last, into rows past the last group.
    local = experts.reshape(t * k) - here.start
    local = torch.where((local >= 0) & (local < len(here)), local, len(here))
    pair_token = torch.arange(t, device=x.device).repeat_interleave(k)
    order = torch.argsort(local, stable=True)
    sorted_token = pair_token[order]
    sorted_gate = gates.reshape(t * k)[order]
    xs = x_flat[sorted_token]
    # Group sizes as a one-hot sum (torch.bincount does not run under vmap).
    group_sizes = (local[:, None] == torch.arange(len(here), device=x.device)
                   ).sum(0).to(torch.int32)

    ys = _grouped_ffn(xs, group_sizes, lp["w_gate"], lp["w_up"], lp["w_down"])
    ys = ys * sorted_gate[:, None].to(ys.dtype)
    # The reference's zeros.at[sorted_token].add(ys) adds each token's k rows
    # into a zero row in sorted order, rounding after each add. Gather each
    # token's rows in that order and add them one after another: the same
    # sums in the same order, deterministic on the card (index_add_ is not).
    pos = torch.sort(torch.argsort(order).reshape(t, k), dim=1).values
    ys_tk = ys[pos]                                         # (T, k, d)
    out = ys_tk[:, 0]
    for j in range(1, k):
        out = out + ys_tk[:, j]
    return out.reshape(b, s, d), aux


def moe_ffn(cfg: ModelConfig, lp: Params, x: torch.Tensor, *,
            mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN sub-layer on one device (the reference's ``mesh=None`` path)."""
    if mesh is not None:
        raise NotImplementedError("the shard_map MoE paths (expert-parallel a2a, "
                                  "FSDP gather) are not ported")
    return _moe_ffn_local(cfg, lp, x)


# ---------------------------------------------------------------------------
# Full MoE decoder
# ---------------------------------------------------------------------------


def init_layer(generator: torch.Generator, cfg: ModelConfig) -> Params:
    dev = generator.device
    return {
        "attn": attn.init_attention(
            generator, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias),
        "moe": init_moe_ffn(generator, cfg),
        "ln1": torch.ones((cfg.d_model,), dtype=torch.float32, device=dev),
        "ln2": torch.ones((cfg.d_model,), dtype=torch.float32, device=dev),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Params:
    return init_lm_params(cfg, generator, init_layer)


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *, mesh=None,
            remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token ids (B,S) → (logits (B,S,V_padded), total aux loss)."""
    if remat:
        raise NotImplementedError("remat (per-layer activation checkpointing) is not "
                                  "ported; every activation is kept")
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = embed_tokens({"tok_embed": params["embed.tok_embed"]}, tokens).to(DEFAULT_DTYPE)
    aux_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for lp in split_layers(params, cfg.num_layers):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + attn.attention_block(lp["attn"], h, positions, rope_theta=cfg.rope_theta,
                                     causal=True, window=cfg.sliding_window)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        y, aux = moe_ffn(cfg, lp["moe"], h, mesh=mesh)
        x = x + y
        aux_sum = aux_sum + aux
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    embed = {k[len("embed."):]: v for k, v in params.items() if k.startswith("embed.")}
    return unembed(embed, x, cfg.vocab_size), aux_sum


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor], *,
            mesh=None) -> torch.Tensor:
    logits, aux = forward(cfg, params, batch["tokens"], mesh=mesh)
    return cross_entropy(logits[:, :-1], batch["labels"][:, 1:]) + AUX_COEF * aux


def _no_decode(*_args, **_kwargs):
    raise NotImplementedError("MoE decode (KV cache, decode_step) is not ported; it "
                              "belongs to the serving slice")


cache_len = init_cache = decode_step = _no_decode
