"""HuBERT-style encoder-only audio transformer [arXiv:2106.07447]: training
and eval forward.

Counterpart of ``repro.models.encoder``. The conv/mel frontend is a stub, as
there: the data gives precomputed frame embeddings (B, S, d_model). The
objective is masked prediction over ``vocab_size`` (= 504) cluster targets:
masked frames are replaced by a learned mask embedding and the CE is taken
on the masked positions only. Attention is bidirectional: K5 non-causal
(``attention.attention_block(..., causal=False)``). Params are a flat dict
keyed by the reference pytree's dotted paths (``mask_embed``,
``layers.attn.wq``, …, ``final_norm``, ``head``), per-layer leaves stacked
on a leading (L, …) axis. There is no decode step; the reference's
``jax.checkpoint`` (remat) is not ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import dense
from repro_torch.models.layers import (DEFAULT_DTYPE, Params, cross_entropy,
                                       dense_init, einsum, flatten, gated_mlp,
                                       meta_param, rms_norm, split_layers)


class EncoderLM(nn.Module):
    """Names, shapes and dtypes of the encoder's weights."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.mask_embed = meta_param(cfg.d_model, dtype=torch.float32)
        self.layers = nn.Module()
        dense.meta_block(self.layers, cfg, cfg.num_layers)
        self.final_norm = meta_param(cfg.d_model, dtype=torch.float32)
        self.head = meta_param(cfg.d_model, cfg.padded_vocab)


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Fresh weights on the generator's device, drawn as the reference draws
    them (shapes, dtypes, distributions) from torch's stream."""
    dev = generator.device
    params = {"mask_embed": torch.randn((cfg.d_model,), generator=generator, device=dev)
              * 0.02}
    layers = [flatten(dense.init_block(generator, cfg)) for _ in range(cfg.num_layers)]
    params.update({f"layers.{k}": torch.stack([lp[k] for lp in layers]) for k in layers[0]})
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=torch.float32, device=dev)
    params["head"] = dense_init(generator, (cfg.d_model, cfg.padded_vocab),
                                dtype=DEFAULT_DTYPE)
    return params


def forward(cfg: ModelConfig, params: Params, frames: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """frames (B,S,d) stub embeddings; mask (B,S) bool, the masked positions
    → logits (B,S,V_padded), the padding columns at the dtype's min."""
    b, s, _ = frames.shape
    x = frames.to(DEFAULT_DTYPE)
    if mask is not None:
        x = torch.where(mask[..., None], params["mask_embed"].to(DEFAULT_DTYPE), x)
    positions = torch.arange(s, device=frames.device).expand(b, s)
    for lp in split_layers(params, cfg.num_layers):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + attn.attention_block(lp["attn"], h, positions, rope_theta=cfg.rope_theta,
                                     causal=False)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + gated_mlp(lp["mlp"], h)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = einsum("bsd,dv->bsv", x, params["head"])
    pad = logits.shape[-1]
    if pad > cfg.vocab_size:
        vmask = torch.arange(pad, device=logits.device) < cfg.vocab_size
        logits = torch.where(vmask, logits, torch.finfo(logits.dtype).min)
    return logits


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Masked-prediction CE on the masked positions only."""
    logits = forward(cfg, params, batch["frames"], batch["mask"])
    return cross_entropy(logits, batch["labels"], mask=batch["mask"])
