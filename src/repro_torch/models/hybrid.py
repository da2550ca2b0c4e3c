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
reference's ``jax.checkpoint`` (remat) is not ported.

Decode (``init_cache``, ``decode_step``) keeps one KV cache per
application of the shared block (``attn_k``/``attn_v``, (n_super, …)) and
one recurrent state per Mamba2 layer (``super_*`` (n_super, per, …) and
``tail_*``, whose leading dim is max(tail, 1) as the tail params' is).
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


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> Params:
    n_super, per, tail = layer_plan(cfg)
    di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    km1 = mamba2.CONV_K - 1
    t = dense.cache_len(cfg, max_len)
    kv = (n_super, batch, t, cfg.num_kv_heads, cfg.resolved_head_dim)

    def zeros(*shape, dtype=DEFAULT_DTYPE):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "super_conv_x": zeros(n_super, per, batch, km1, di),
        "super_conv_bc": zeros(n_super, per, batch, km1, 2 * n),
        "super_ssm": zeros(n_super, per, batch, nh, cfg.ssm_headdim, n, dtype=torch.float32),
        "tail_conv_x": zeros(max(tail, 1), batch, km1, di),
        "tail_conv_bc": zeros(max(tail, 1), batch, km1, 2 * n),
        "tail_ssm": zeros(max(tail, 1), batch, nh, cfg.ssm_headdim, n, dtype=torch.float32),
        "attn_k": zeros(*kv),
        "attn_v": zeros(*kv),
    }


def _decode_mamba_stack(cfg: ModelConfig, x: torch.Tensor, lps, cx, cbc, ss):
    """Mamba2 layers ``lps`` at decode over their stacked states (one per
    layer on the leading dim); returns (x, conv_x, conv_bc, ssm) stacked."""
    out = ([], [], [])
    for lp, *state in zip(lps, cx.unbind(0), cbc.unbind(0), ss.unbind(0)):
        x, *state = mamba2.decode_layer(cfg, lp, x, *state)
        for acc, leaf in zip(out, state):
            acc.append(leaf)
    return (x, *(torch.stack(acc) for acc in out))


def decode_step(cfg: ModelConfig, params: Params, cache: Params, tokens: torch.Tensor,
                pos) -> Tuple[torch.Tensor, Params]:
    """One decode step: tokens (B,1) at position ``pos`` → (logits, cache')."""
    n_super, per, tail = layer_plan(cfg)
    x = dense.embed_one(params, tokens, DEFAULT_DTYPE)
    pos, rope = dense.position_tables(cfg, pos, x.device)
    shared = nest(params, "shared_attn.")
    supers = split_layers(params, n_super, prefix="super_mamba.", per=per) if per \
        else [[]] * n_super
    names = ("super_conv_x", "super_conv_bc", "super_ssm", "attn_k", "attn_v")
    new = {name: [] for name in names}
    for stack, *state in zip(supers, *(cache[name].unbind(0) for name in names)):
        cx, cbc, ss, ck, cv = state
        if per:
            x, cx, cbc, ss = _decode_mamba_stack(cfg, x, stack, cx, cbc, ss)
        x, ck, cv = dense.decode_block(cfg, shared, x, ck, cv, pos, rope)
        for name, leaf in zip(names, (cx, cbc, ss, ck, cv)):
            new[name].append(leaf)
    out = {name: torch.stack(leaves) for name, leaves in new.items()}
    tcx, tcbc, tss = cache["tail_conv_x"], cache["tail_conv_bc"], cache["tail_ssm"]
    if tail:
        x, tcx, tcbc, tss = _decode_mamba_stack(
            cfg, x, split_layers(params, tail, prefix="tail_mamba."), tcx, tcbc, tss)
    out.update(tail_conv_x=tcx, tail_conv_bc=tcbc, tail_ssm=tss)
    return dense.logits_out(cfg, params, x), out
