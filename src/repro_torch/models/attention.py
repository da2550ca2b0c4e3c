"""Attention: GQA with optional QKV bias, sliding window and cross-attention
(prefill/train).

Counterpart of ``repro.models.attention`` for the training and eval
forwards. ``blockwise_attention`` is the reference's online-softmax
attention with f32 state; here it is the flash-attention kernel K5
(``kernels.flash_attention``): a CUDA tensor launches the sm_90a kernel, a
CPU tensor takes its plain version, and nothing on the card takes the plain
version. Cross-attention (``kv_x``: the vlm's vision tokens) runs through
the same kernel, non-causal over T ≠ S keys; KV heads are never repeated
(the kernel reads KV head h // G through its strides), so the reference's
``_expand_kv`` has no counterpart. Decode attention and the KV cache wait
for the serving slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ops import flash_mha
from repro_torch.models.layers import (DEFAULT_DTYPE, Params, apply_rope,
                                       dense_init, einsum)


def init_attention(generator: torch.Generator, d_model: int, num_heads: int,
                   num_kv_heads: int, head_dim: int, *, qkv_bias: bool = False,
                   dtype=DEFAULT_DTYPE) -> Params:
    dev = generator.device
    p = {
        "wq": dense_init(generator, (d_model, num_heads, head_dim), dtype=dtype),
        "wk": dense_init(generator, (d_model, num_kv_heads, head_dim), dtype=dtype),
        "wv": dense_init(generator, (d_model, num_kv_heads, head_dim), dtype=dtype),
        "wo": dense_init(generator, (num_heads, head_dim, d_model), dtype=dtype),
    }
    if qkv_bias:
        p["bq"] = torch.zeros((num_heads, head_dim), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((num_kv_heads, head_dim), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((num_kv_heads, head_dim), dtype=dtype, device=dev)
    return p


def qkv_project(params: Params, x: torch.Tensor, positions: torch.Tensor,
                rope_theta: float, kv_x: Optional[torch.Tensor] = None,
                kv_positions: Optional[torch.Tensor] = None, use_rope: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project to q (B,S,H,D) from ``x`` and k/v (B,T,KVH,D) from ``kv_x``
    (``x`` when None); with ``use_rope``, RoPE on q at ``positions`` and on
    k at ``kv_positions`` (``positions`` when None)."""
    src = x if kv_x is None else kv_x
    q = einsum("bsd,dhk->bshk", x, params["wq"])
    k = einsum("btd,dhk->bthk", src, params["wk"])
    v = einsum("btd,dhk->bthk", src, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions if kv_positions is None else kv_positions, rope_theta)
    return q, k, v


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, window: int = 0) -> torch.Tensor:
    """Online-softmax attention with f32 state, through K5.

    q: (B,S,H,D); k,v: (B,T,KVH,D). Returns (B,S,H,D) in q.dtype.
    ``window > 0`` restricts to a causal sliding window. Queries start at
    position 0 (training and prefill): the reference's ``q_offset`` serves
    decode, which is not ported.
    """
    return flash_mha(q, k, v, causal=causal, window=window)


def attention_block(params: Params, x: torch.Tensor, positions: torch.Tensor, *,
                    rope_theta: float, causal: bool = True, window: int = 0,
                    kv_x: Optional[torch.Tensor] = None,
                    kv_positions: Optional[torch.Tensor] = None,
                    use_rope: bool = True) -> torch.Tensor:
    """Attention sub-layer: projections, blockwise attention, out proj. With
    ``kv_x`` it is cross-attention over ``kv_x``'s tokens, never causal."""
    q, k, v = qkv_project(params, x, positions, rope_theta, kv_x=kv_x,
                          kv_positions=kv_positions, use_rope=use_rope)
    o = blockwise_attention(q, k, v, causal=causal and kv_x is None, window=window)
    return einsum("bshk,hkd->bsd", o, params["wo"])
