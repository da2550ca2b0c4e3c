"""Mamba-2 decoder (ssm family, SSD — state-space duality): training and
eval forward.

Counterpart of ``repro.models.mamba2`` [arXiv:2405.21060]: separate z / x /
B / C / Δ projections (one group for B and C), a depthwise causal conv of
width ``CONV_K`` on x and on B‖C, the chunked SSD scan, a D skip, a gated
RMSNorm and the output projection, in a pre-norm residual stack with tied or
untied embeddings. Params are a flat dict keyed by the dotted paths of the
reference's pytree (``embed.tok_embed``, ``layers.block.in_z``, …,
``layers.ln``, ``final_norm``), each per-layer leaf stacked on a leading
(L, …) axis as ``mamba2.init_params`` stacks it, so conversion is a copy.
``Mamba2LM`` (on the meta device) names and shapes them; the forward is a
plain function over the dict and the reference's ``lax.scan`` over layers a
Python loop over the stacked axis.

Dtypes follow the reference at every step: the projections are
``DEFAULT_DTYPE`` (bf16) einsums; the conv, SiLU, softplus, the SSD and the
D skip run in f32; the gate is ``rms_norm(y.to(DEFAULT_DTYPE) · silu(z))``
before ``out_proj``. The SSD's intra-chunk part is K7
(``ops.ssd_forward``). Every activation is kept: the reference's per-layer
``jax.checkpoint`` (remat) is not ported.

Decode is the reference's O(1) single-token recurrence, plain torch as
there: per layer the last CONV_K − 1 projected inputs of each conv
(``DEFAULT_DTYPE``) and the SSM state (B, nh, hp, N) in f32,
h ← exp(Δ·A)·h + Δ·x⊗B, y = C·h + D·x (``block_decode``, ``init_cache``,
``decode_step``; exp through ``kernels._math`` as in the forward).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import dense
from repro_torch.kernels._math import exp as _exp
from repro_torch.models.layers import (DEFAULT_DTYPE, Params, cross_entropy,
                                       dense_init, einsum, embed_tokens,
                                       init_lm_params, linear, meta_param, rms_norm,
                                       split_layers, unembed)

CONV_K = 4  # depthwise causal conv kernel width


def _block_shapes(cfg: ModelConfig):
    """(name, shape, dtype) of one block's weights, in ``init_block`` order."""
    d, di, n, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    f32 = torch.float32
    return (("in_z", (d, di), DEFAULT_DTYPE), ("in_x", (d, di), DEFAULT_DTYPE),
            ("in_b", (d, n), DEFAULT_DTYPE), ("in_c", (d, n), DEFAULT_DTYPE),
            ("in_dt", (d, nh), DEFAULT_DTYPE),
            ("conv_x_w", (CONV_K, di), f32), ("conv_x_b", (di,), f32),
            ("conv_bc_w", (CONV_K, 2 * n), f32), ("conv_bc_b", (2 * n,), f32),
            ("A_log", (nh,), f32), ("D", (nh,), f32), ("dt_bias", (nh,), f32),
            ("norm", (di,), f32), ("out_proj", (di, d), DEFAULT_DTYPE))


def meta_layer(module: nn.Module, cfg: ModelConfig, *stack: int) -> None:
    """One Mamba2 layer's weights (its block and pre-norm) under ``module``
    (meta device), each with the leading ``stack`` dims."""
    module.block = nn.Module()
    for name, shape, dtype in _block_shapes(cfg):
        setattr(module.block, name, meta_param(*stack, *shape, dtype=dtype))
    module.ln = meta_param(*stack, cfg.d_model, dtype=torch.float32)


class Mamba2LM(nn.Module):
    """Names, shapes and dtypes of the mamba2 decoder's weights."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        dense.meta_embed(self, cfg)
        self.layers = nn.Module()
        meta_layer(self.layers, cfg, cfg.num_layers)
        self.final_norm = meta_param(cfg.d_model, dtype=torch.float32)


def init_block(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """One block as the reference initialises it (shapes, dtypes and
    distributions, from torch's stream): truncated-normal fan-in projections
    and conv kernels, zero conv biases, A_log 0 (A = −1), D 1, dt_bias −2
    (softplus ≈ 0.127), norm 1."""
    dev = generator.device
    const = {"conv_x_b": 0.0, "conv_bc_b": 0.0, "A_log": 0.0, "D": 1.0,
             "dt_bias": -2.0, "norm": 1.0}
    return {name: (torch.full(shape, const[name], dtype=dtype, device=dev) if name in const
                   else dense_init(generator, shape, dtype=dtype))
            for name, shape, dtype in _block_shapes(cfg)}


def init_layer(generator: torch.Generator, cfg: ModelConfig) -> Params:
    return {"block": init_block(generator, cfg),
            "ln": torch.ones((cfg.d_model,), dtype=torch.float32, device=generator.device)}


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Params:
    return init_lm_params(cfg, generator, init_layer)


def _silu(x: torch.Tensor) -> torch.Tensor:
    """x·sigmoid(x), as ``jax.nn.silu`` (bf16 rounds after each op as there)."""
    return x * torch.sigmoid(x)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv as CONV_K shifted f32 adds plus the bias, in the
    reference's order. x: (B,S,C) (bf16 projection); w: (K,C) f32. The
    padded input is cast to f32 once, so the backward keeps one f32 copy of
    it rather than one per shift (the same values as the reference's cast of
    each shifted slice)."""
    s = x.shape[1]
    xp = F.pad(x, (0, 0, CONV_K - 1, 0)).to(torch.float32)
    out = xp[:, 0:s] * w[0]
    for k in range(1, CONV_K):
        out = out + xp[:, k:k + s] * w[k]
    return out + b


def _ssd_chunked(x, dt, a_neg, b_in, c_in, chunk: int, h0=None):
    """Chunked SSD scan through K7. Returns (y (B,S,nh,hp), final_state)."""
    return ops.ssd_forward(x, dt, a_neg, b_in, c_in, chunk=chunk, h0=h0)


def block_forward(cfg: ModelConfig, lp: Params, x: torch.Tensor, *, h0=None,
                  return_state: bool = False):
    """Full Mamba2 block: projections → conv → SSD → gated norm → out_proj.
    ``h0`` (B, nh, hp, N) is the SSM state entering the block (zeros when
    None); ``return_state`` also returns the state leaving it."""
    di, n, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    z = einsum("bsd,de->bse", x, lp["in_z"])
    xs = einsum("bsd,de->bse", x, lp["in_x"])
    bc = torch.cat([einsum("bsd,dn->bsn", x, lp["in_b"]),
                    einsum("bsd,dn->bsn", x, lp["in_c"])], dim=-1)
    dt = einsum("bsd,dh->bsh", x, lp["in_dt"])
    xs = _silu(_causal_conv(xs, lp["conv_x_w"], lp["conv_x_b"]))
    bc = _silu(_causal_conv(bc, lp["conv_bc_w"], lp["conv_bc_b"]))
    b_in, c_in = torch.split(bc, n, dim=-1)
    # F.softplus returns x itself above its threshold 20, where the
    # reference's max(x, 0) + log1p(exp(−|x|)) rounds to x in f32 too.
    dt = F.softplus(dt.to(torch.float32) + lp["dt_bias"])
    a_neg = -_exp(lp["A_log"])
    xh = xs.reshape(*xs.shape[:2], nh, hp)
    y, h_final = _ssd_chunked(xh, dt, a_neg, b_in, c_in, cfg.ssm_chunk, h0=h0)
    y = y + lp["D"][:, None] * xh  # skip
    y = y.reshape(*y.shape[:2], di)
    y = rms_norm(y.to(DEFAULT_DTYPE) * _silu(z), lp["norm"], cfg.norm_eps)
    out = einsum("bse,ed->bsd", y, lp["out_proj"])
    return (out, h_final) if return_state else out


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Token ids (B,S) → logits (B,S,V_padded)."""
    x = embed_tokens({"tok_embed": params["embed.tok_embed"]}, tokens).to(DEFAULT_DTYPE)
    for lp in split_layers(params, cfg.num_layers):
        h = rms_norm(x, lp["ln"], cfg.norm_eps)
        x = x + block_forward(cfg, lp["block"], h)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    embed = {k[len("embed."):]: v for k, v in params.items() if k.startswith("embed.")}
    return unembed(embed, x, cfg.vocab_size)


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    logits = forward(cfg, params, batch["tokens"])
    return cross_entropy(logits[:, :-1], batch["labels"][:, 1:])


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _conv_step(state: torch.Tensor, cur: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the depthwise causal conv: state (B, K−1, C) of the last
    inputs, cur (B, C). Returns (silu(conv) in f32, the new state)."""
    dt = torch.promote_types(state.dtype, cur.dtype)
    window = torch.cat([state.to(dt), cur[:, None, :].to(dt)], dim=1)   # (B,K,C)
    out = torch.sum(window.to(torch.float32) * w, dim=1) + b
    return _silu(out), window[:, 1:]


def block_decode(cfg: ModelConfig, lp: Params, x: torch.Tensor, conv_x_state: torch.Tensor,
                 conv_bc_state: torch.Tensor, ssm_state: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token recurrence. x: (B,1,d).

    States: conv_x (B,K−1,di), conv_bc (B,K−1,2n), ssm (B,nh,hp,N).
    Returns (out (B,1,d), conv_x, conv_bc, ssm)."""
    di, n, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    z = linear(x, lp["in_z"])
    xs = linear(x, lp["in_x"])[:, 0]
    bc = torch.cat([linear(x, lp["in_b"]), linear(x, lp["in_c"])], dim=-1)[:, 0]
    dt = linear(x, lp["in_dt"])[:, 0]
    xs_f, new_conv_x = _conv_step(conv_x_state, xs, lp["conv_x_w"], lp["conv_x_b"])
    bc_f, new_conv_bc = _conv_step(conv_bc_state, bc, lp["conv_bc_w"], lp["conv_bc_b"])
    b_in, c_in = torch.split(bc_f, n, dim=-1)
    dt1 = F.softplus(dt.to(torch.float32) + lp["dt_bias"])            # (B,nh)
    a_neg = -_exp(lp["A_log"])
    dec = _exp(dt1 * a_neg)                                             # (B,nh)
    xh = xs_f.reshape(-1, nh, hp)
    h_new = dec[:, :, None, None] * ssm_state \
        + (dt1[:, :, None] * xh)[..., None] * b_in[:, None, None, :]
    y = (h_new @ c_in[:, None, :, None])[..., 0] + lp["D"][:, None] * xh
    y = y.reshape(-1, 1, di)
    y = rms_norm(y.to(DEFAULT_DTYPE) * _silu(z), lp["norm"], cfg.norm_eps)
    return linear(y, lp["out_proj"]), new_conv_x, new_conv_bc, h_new


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> Params:
    """The SSM cache is O(1) in context length (``max_len`` unused, by design)."""
    del max_len
    di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    layers = cfg.num_layers
    return {
        "conv_x": torch.zeros((layers, batch, CONV_K - 1, di), dtype=DEFAULT_DTYPE,
                              device=device),
        "conv_bc": torch.zeros((layers, batch, CONV_K - 1, 2 * n), dtype=DEFAULT_DTYPE,
                               device=device),
        "ssm": torch.zeros((layers, batch, nh, cfg.ssm_headdim, n), dtype=torch.float32,
                           device=device),
    }


def decode_layer(cfg: ModelConfig, lp: Dict[str, Params], x: torch.Tensor, cx, cbc, ss):
    """One pre-norm Mamba2 layer at decode: (x, conv_x, conv_bc, ssm)."""
    h = rms_norm(x, lp["ln"], cfg.norm_eps)
    y, cx, cbc, ss = block_decode(cfg, lp["block"], h, cx, cbc, ss)
    return x + y, cx, cbc, ss


def decode_step(cfg: ModelConfig, params: Params, cache: Params, tokens: torch.Tensor,
                pos) -> Tuple[torch.Tensor, Params]:
    """One decode step: tokens (B,1) → (logits, cache'). The recurrent state
    carries the position, so ``pos`` is unused."""
    del pos
    x = dense.embed_one(params, tokens, DEFAULT_DTYPE)
    out = {name: [] for name in ("conv_x", "conv_bc", "ssm")}
    for lp, *state in zip(split_layers(params, cfg.num_layers), cache["conv_x"].unbind(0),
                          cache["conv_bc"].unbind(0), cache["ssm"].unbind(0)):
        x, *state = decode_layer(cfg, lp, x, *state)
        for name, leaf in zip(out, state):
            out[name].append(leaf)
    return dense.logits_out(cfg, params, x), {k: torch.stack(v) for k, v in out.items()}
