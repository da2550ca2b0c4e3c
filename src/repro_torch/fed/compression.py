"""Update compression, counterpart of ``repro.fed.compression`` — the
paper's declared future work (Sec II-B): "Integrating update compression
with intelligent selection could further improve efficiency".

The two families the paper cites, composed with HeteRo-Select:

  * top-k sparsification with error feedback (the client keeps the
    residual and adds it to its next update — Stich et al.'s memory trick,
    without which sparse FL diverges),
  * int8 per-tensor quantization (FedPAQ-style [Reisizadeh et al. 20]).

Compression operates on the client *delta* Δ = w_k − w_global (never on
raw weights), which is what crosses the network in a deployment.
``CompressionStats`` reports the bytes on the wire.

Params are flat ``{name: tensor}`` dicts. The codes equal the reference's
bitwise on the same deltas: int8 takes ``round(x / scale)`` (half to even,
as ``jnp.round``) with ``scale = max(max|x|, 1e-12) / 127`` in f32; top-k
ranks ``|x|`` as ``lax.top_k`` does (``core.selection._topk_first``: IEEE
total order and a stable sort, ties to the smaller index, where
``torch.topk`` leaves them unordered), which decides the residual where
magnitudes tie (zero deltas are common). ``CompressedExecutor``, the
executor that applies a codec to a cohort, lives in ``fed.engine`` as in
the reference and is re-exported here.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.selection import _topk_first

Params = Dict[str, torch.Tensor]


class CompressedDelta(NamedTuple):
    payload: Any          # {name: compressed leaf}
    meta: Any             # {name: per-leaf metadata (scales / shapes)}
    kind: str


class CompressionStats(NamedTuple):
    raw_bytes: int
    wire_bytes: int

    @property
    def ratio(self) -> float:
        return self.raw_bytes / max(self.wire_bytes, 1)


def _leaf_bytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def tree_delta(new_params: Params, anchor: Params) -> Params:
    """f32 ``new − anchor`` per leaf (a stacked ``new`` broadcasts)."""
    return {k: new_params[k].to(torch.float32) - anchor[k].to(torch.float32)
            for k in new_params}


def tree_apply_delta(anchor: Params, delta: Params) -> Params:
    """``anchor + delta`` in f32, cast back to each anchor leaf's dtype."""
    return {k: (anchor[k].to(torch.float32) + delta[k]).to(anchor[k].dtype)
            for k in delta}


# ---------------------------------------------------------------------------
# int8 quantization
# ---------------------------------------------------------------------------


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-12) / 127`` as a true f32 division. The divisor is a
    tensor on ``amax``'s device: CUDA divides by a Python scalar as a
    multiplication by its reciprocal, one ulp off the reference's quotient
    for some values, which moves codes at .5 boundaries."""
    return torch.clamp_min(amax, 1e-12) / torch.full((), 127.0, device=amax.device)


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_int8(delta: Params) -> Tuple[CompressedDelta, CompressionStats]:
    """Per-tensor int8: one f32 scale per leaf."""
    payload, meta = {}, {}
    for k, x in delta.items():
        scale = _scale(torch.max(torch.abs(x)))
        payload[k], meta[k] = _quantize(x, scale), scale
    raw = sum(_leaf_bytes(x) for x in delta.values())
    wire = sum(x.numel() + 4 for x in delta.values())  # int8 + f32 scale
    return CompressedDelta(payload, meta, "int8"), CompressionStats(raw, wire)


def dequantize_int8(c: CompressedDelta) -> Params:
    return {k: q.to(torch.float32) * c.meta[k] for k, q in c.payload.items()}


def quantize_int8_stacked(stacked_delta: Params) -> Tuple[CompressedDelta, CompressionStats]:
    """Per-client per-tensor int8 over a leading (M,) client axis.

    Each client's scale is the max-abs over its own slice, so client m's
    codes equal ``quantize_int8(delta_m)``'s exactly: int8 has no host-side
    state, which is what lets it compose with the batched schedule.
    """
    payload, meta = {}, {}
    for k, x in stacked_delta.items():
        axes = tuple(range(1, x.ndim))
        amax = torch.amax(torch.abs(x), dim=axes, keepdim=True) if axes else torch.abs(x)
        scale = _scale(amax)
        payload[k], meta[k] = _quantize(x, scale), scale
    raw = sum(x.numel() * 4 for x in stacked_delta.values())               # f32 deltas
    wire = sum(x.numel() + 4 * x.shape[0] for x in stacked_delta.values())  # + scales
    return CompressedDelta(payload, meta, "int8_stacked"), CompressionStats(raw, wire)


# The per-client scales keep broadcastable (M, 1, ...) shapes in ``meta``, so
# decoding is the per-client codec's.
dequantize_int8_stacked = dequantize_int8


# ---------------------------------------------------------------------------
# top-k sparsification with error feedback
# ---------------------------------------------------------------------------


def topk_sparsify(delta: Params, frac: float, residual: Optional[Params] = None
                  ) -> Tuple[CompressedDelta, Params, CompressionStats]:
    """Keep the top-``frac`` fraction of entries per leaf (by magnitude).

    Returns (compressed, new_residual, stats). ``residual`` (error feedback)
    is added to the delta before selection, and the unsent remainder
    becomes the next residual.
    """
    if residual is not None:
        delta = {k: d + residual[k] for k, d in delta.items()}
    payload, resid, shapes = {}, {}, {}
    for name, x in delta.items():
        flat = x.reshape(-1)
        k = max(int(flat.numel() * frac), 1)
        idx = _topk_first(torch.abs(flat), k)  # lax.top_k(|flat|, k)'s indices
        kept = flat[idx]
        sent = torch.zeros_like(flat)
        sent[idx] = kept
        payload[name] = (kept, idx.to(torch.int32))
        resid[name] = (flat - sent).reshape(x.shape)
        shapes[name] = tuple(x.shape)
    raw = sum(_leaf_bytes(x) for x in delta.values())
    wire = sum(v.numel() * 4 + i.numel() * 4 for v, i in payload.values())
    return CompressedDelta(payload, shapes, "topk"), resid, CompressionStats(raw, wire)


def desparsify(c: CompressedDelta) -> Params:
    out = {}
    for name, (vals, idx) in c.payload.items():
        shape = c.meta[name]
        size = 1
        for s in shape:
            size *= s
        flat = torch.zeros(size, dtype=torch.float32, device=vals.device)
        flat[idx.to(torch.int64)] = vals
        out[name] = flat.reshape(shape)
    return out


# ---------------------------------------------------------------------------
# Server-side aggregation of compressed deltas
# ---------------------------------------------------------------------------


def aggregate_compressed(anchor: Params, compressed: list) -> Params:
    """FedAvg over decompressed deltas: w ← w_g + mean_k(decode(Δ_k)),
    the decoded deltas summed in list order as the reference's ``sum``."""
    deltas = []
    for c in compressed:
        if c.kind == "int8":
            deltas.append(dequantize_int8(c))
        elif c.kind == "topk":
            deltas.append(desparsify(c))
        else:
            raise ValueError(c.kind)
    mean_delta = {}
    for k in deltas[0]:
        total = 0
        for d in deltas:
            total = total + d[k]
        # a tensor divisor: a true division on the card too (see _scale)
        mean_delta[k] = total / torch.full((), float(len(deltas)), device=total.device)
    return tree_apply_delta(anchor, mean_delta)


def __getattr__(name):  # PEP 562: fed.engine imports this module
    if name == "CompressedExecutor":
        from repro_torch.fed.engine import CompressedExecutor

        return CompressedExecutor
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
