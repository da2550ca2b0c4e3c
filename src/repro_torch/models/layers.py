"""Shared building blocks: norms, RoPE, embeddings, gated MLP, initializers.

Counterpart of ``repro.models.layers``: plain functions over dicts of
tensors, with the reference's parameter layout. Where the reference mixes
dtypes in one ``jnp.einsum`` (bf16 activations against f32 weights), JAX
promotes both operands; ``torch.einsum`` refuses mixed operands, so
``einsum`` here promotes them first, the same way.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels._math import logsumexp

Params = Dict[str, torch.Tensor]

DEFAULT_DTYPE = torch.bfloat16


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of two operands promoted to a common dtype, as
    ``jnp.einsum`` promotes them (bf16 × f32 → f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


# ---------------------------------------------------------------------------
# Parameter trees of the LM families (dense, ssm)
# ---------------------------------------------------------------------------


def meta_param(*shape, dtype=DEFAULT_DTYPE) -> nn.Parameter:
    """A weight's name, shape and dtype, with no storage (meta device)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device="meta"))


def flatten(tree: dict, prefix: str = "") -> Params:
    """Nested dict → flat dict keyed by dotted paths."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def nest(params: Params, prefix: str) -> dict:
    """The leaves named ``prefix`` + path, nested by path (``shared_attn.``'s
    ``attn.wq`` → ``out["attn"]["wq"]``)."""
    out: dict = {}
    for name, p in params.items():
        if name.startswith(prefix):
            *group, leaf = name[len(prefix):].split(".")
            node = out
            for g in group:
                node = node.setdefault(g, {})
            node[leaf] = p
    return out


def split_layers(params: Params, num_layers: int, prefix: str = "layers.",
                 per: int = 0) -> list:
    """Each layer's params, nested as the reference's scan body sees them
    (``layers.attn.wq`` of layer i → ``lps[i]["attn"]["wq"]``), for the
    leaves named ``prefix`` + path, stacked on a leading (num_layers, …)
    axis. With ``per`` > 0 the leaves are a two-level stack (num_layers,
    per, …), as a scan over super-blocks of ``per`` layers holds them, and
    ``lps[i][j]`` is layer j of super-block i.

    Each stacked leaf is split with ``torch.unbind`` (once per level), whose
    backward is one ``stack`` into the leaf's gradient. Indexing the leaf per
    layer instead would make each layer's backward zero-fill and add a
    gradient the size of the whole stack (L² bytes per step, as the
    reference's ``lax.scan`` does not).
    """
    lps: list = [[{} for _ in range(per)] if per else {} for _ in range(num_layers)]
    for name, p in params.items():
        if name.startswith(prefix):
            *group, leaf = name[len(prefix):].split(".")
            for lp, p_i in zip(lps, torch.unbind(p, 0)):
                for lq, p_ij in (zip(lp, torch.unbind(p_i, 0)) if per else [(lp, p_i)]):
                    for g in group:
                        lq = lq.setdefault(g, {})
                    lq[leaf] = p_ij
    return lps


def init_lm_params(cfg, generator: torch.Generator, init_layer) -> Params:
    """Fresh LM weights on the generator's device, drawn as the reference
    draws them (shapes, dtypes, distributions) from torch's stream: the
    embeddings, ``init_layer(generator, cfg)`` once per layer stacked on a
    leading (L, …) axis, and the final norm."""
    embed = init_embeddings(generator, cfg.padded_vocab, cfg.d_model, cfg.tie_embeddings)
    layers = [flatten(init_layer(generator, cfg)) for _ in range(cfg.num_layers)]
    params = flatten({"embed": embed})
    params.update({f"layers.{k}": torch.stack([lp[k] for lp in layers])
                   for k in layers[0]})
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=torch.float32,
                                      device=generator.device)
    return params


# ---------------------------------------------------------------------------
# Group norm (resnet)
# ---------------------------------------------------------------------------


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the channel axis of an NCHW tensor.

    As ``repro.models.layers.group_norm`` (which takes NHWC): ``groups``
    contiguous channel groups, statistics in f32 over (H, W, C/G), the
    population variance (``correction=0``), output in the input dtype.
    Written out with reshapes so it runs under ``torch.func.vmap``.
    """
    dt = x.dtype
    b, c, h, w = x.shape
    xf = x.to(torch.float32).reshape(b, groups, c // groups, h, w)
    var, mu = torch.var_mean(xf, dim=(2, 3, 4), correction=0, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(b, c, h, w)
    scale = weight.to(torch.float32).reshape(1, c, 1, 1)
    shift = bias.to(torch.float32).reshape(1, c, 1, 1)
    return (y * scale + shift).to(dt)


# ---------------------------------------------------------------------------
# Initializers (from torch's stream: the reference's shapes, dtypes and
# distributions, not its values)
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init, std 1/√fan_in, drawn in f32."""
    fan_in = shape[in_axis]
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * (1.0 / math.sqrt(max(fan_in, 1)))).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32) -> torch.Tensor:
    """N(0, 1) drawn in f32, cast, then scaled by 0.02 in ``dtype``."""
    w = torch.randn((vocab, dim), generator=generator, device=generator.device)
    return w.to(dtype) * 0.02


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with f32 statistics, output in the input dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim/2,), f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate q/k. x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., :, None].to(torch.float32) * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                     # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_gated_mlp(generator: torch.Generator, d_model: int, d_ff: int,
                   dtype=DEFAULT_DTYPE) -> Params:
    return {
        "w_gate": dense_init(generator, (d_model, d_ff), dtype=dtype),
        "w_up": dense_init(generator, (d_model, d_ff), dtype=dtype),
        "w_down": dense_init(generator, (d_ff, d_model), dtype=dtype),
    }


def gated_mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: down( silu(gate(x)) * up(x) ), silu written as the reference's
    x·sigmoid(x) so bf16 rounds after each op as there."""
    g = einsum("...d,df->...f", x, params["w_gate"])
    u = einsum("...d,df->...f", x, params["w_up"])
    return einsum("...f,fd->...d", g * torch.sigmoid(g) * u, params["w_down"])


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def init_embeddings(generator: torch.Generator, padded_vocab: int, d_model: int,
                    tie: bool, dtype=DEFAULT_DTYPE) -> Params:
    p = {"tok_embed": embed_init(generator, padded_vocab, d_model, dtype=dtype)}
    if not tie:
        p["unembed"] = dense_init(generator, (d_model, padded_vocab), dtype=dtype)
    return p


def embed_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.to(torch.int64), params["tok_embed"])


def unembed(params: Params, x: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Logits over the *padded* vocab; padding columns hold the dtype's min."""
    if "unembed" in params:
        logits = einsum("...d,dv->...v", x, params["unembed"])
    else:
        logits = einsum("...d,vd->...v", x, params["tok_embed"])
    padded = logits.shape[-1]
    if padded > vocab_size:
        mask = torch.arange(padded, device=logits.device) < vocab_size
        logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE in f32. labels: int ids; mask optional weights."""
    logits = logits.to(torch.float32)
    logz = logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
