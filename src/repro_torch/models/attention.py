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
``_expand_kv`` has no counterpart.

Decode (one token against a KV cache: ``decode_attention``,
``init_kv_cache``, ``cache_write``, ``decode_attention_block``) is plain
torch, as the reference's is plain jnp: the f32 products over (B, KVH, G,
1, T) without expanding the KV heads, ``NEG_INF`` on positions ≥
``cur_len``, and a softmax; projections are single matmuls (``linear``). Every decode function is pure (a cache passed in is never
written): the serving tier vmaps them over its slots. ``pos`` and
``cur_len`` may be Python ints or 0-d integer tensors (one per slot under
``torch.func.vmap``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ops import flash_mha
from repro_torch.models.layers import (DEFAULT_DTYPE, Params, apply_rope,
                                       dense_init, einsum, linear, rope_tables, rotate)

NEG_INF = -1e30


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
    position 0 (training and prefill); the reference's ``q_offset`` is
    called by no model.
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


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def as_index(i, device) -> torch.Tensor:
    """``i`` (a Python int or an integer tensor) as an int64 tensor."""
    if isinstance(i, torch.Tensor):
        return i.to(torch.int64)
    return torch.tensor(i, dtype=torch.int64, device=device)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cur_len, *, ring: bool = False) -> torch.Tensor:
    """Single-token attention against a KV cache.

    q: (B,1,H,D); caches: (B,T,KVH,D). ``cur_len`` = number of valid
    positions. With ``ring=True`` the cache is a ring buffer (sliding
    window) and every slot < min(cur_len, T) is valid. Query head h reads
    KV head h // G (G = H / KVH) without the KV heads being repeated: the
    reference's f32 einsums over (B, KVH, G, 1, T), as two batched matmuls.
    """
    b, _, h, d = q.shape
    t, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    kf = k_cache.to(torch.float32).permute(0, 2, 3, 1)              # (B,KVH,D,T)
    vf = v_cache.to(torch.float32).permute(0, 2, 1, 3)              # (B,KVH,T,D)
    qf = (q.to(torch.float32) * (1.0 / d ** 0.5)).reshape(b, kvh, g, d)
    s = qf @ kf                                                     # (B,KVH,G,T)
    limit = as_index(cur_len, q.device)
    if ring:
        limit = torch.clamp(limit, max=t)
    valid = torch.arange(t, device=q.device) < limit
    p = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    return (p @ vf).reshape(b, 1, h, d).to(q.dtype)


def init_kv_cache(num_layers: int, batch: int, max_len: int, num_kv_heads: int,
                  head_dim: int, dtype=DEFAULT_DTYPE, device=None) -> Params:
    """Zero K and V caches, each (L, B, max_len, KVH, D)."""
    shape = (num_layers, batch, max_len, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_write(cache_k: torch.Tensor, cache_v: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, pos, *, ring: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """New caches with one token's k/v (B,1,KVH,D) at ``pos`` (ring ⇒ pos %
    T). The caches passed in are not written.

    As the reference's ``lax.dynamic_update_slice``, without the ring a
    negative ``pos`` counts from the end (pos + T) and a start index outside
    the cache is then clamped into it: ``pos`` ≥ T writes the last position
    T − 1. The serving tier refuses requests longer than its caches, so it
    never writes there.
    """
    t = cache_k.shape[1]
    slot = as_index(pos, cache_k.device)
    slot = slot % t if ring else torch.clamp(torch.where(slot < 0, slot + t, slot), 0, t - 1)
    hit = (torch.arange(t, device=cache_k.device) == slot)[:, None, None]
    ck = torch.where(hit, k.to(cache_k.dtype), cache_k)
    cv = torch.where(hit, v.to(cache_v.dtype), cache_v)
    return ck, cv


def decode_attention_block(params: Params, x: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, pos, *, rope_theta: float,
                           ring: bool = False, use_rope: bool = True, rope=None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token attention sub-layer: x (B,1,d) at position ``pos``; returns
    (y (B,1,d), new k cache, new v cache). ``rope`` takes the position's
    ``rope_tables`` made once per step (made here when None)."""
    pos = as_index(pos, x.device)
    if use_rope and rope is None:
        rope = rope_tables(pos.reshape(1), cache_k.shape[-1], rope_theta)
    q, k, v = (linear(x, params[w]) for w in ("wq", "wk", "wv"))
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if use_rope:
        q, k = rotate(q, *rope), rotate(k, *rope)
    ck, cv = cache_write(cache_k, cache_v, k, v, pos, ring=ring)
    o = decode_attention(q, ck, cv, pos + 1, ring=ring)
    return linear(o, params["wo"], 2), ck, cv
