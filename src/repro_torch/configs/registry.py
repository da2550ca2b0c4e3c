"""Architecture registry. The resnet, dense and ssm families are ported."""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import mamba2_370m, qwen2_0_5b, resnet18_cifar10
from repro_torch.configs.base import ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (mamba2_370m, qwen2_0_5b, resnet18_cifar10)
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown or not yet ported arch '{arch}'; "
                       f"available: {sorted(ARCHS)}")
    return ARCHS[arch]


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests, as the reference's:
    resnet at width 16; dense and ssm at 2 layers, d_model ≤ 256, vocab ≤
    512. Dense: 4 heads (KV heads 4 if the model is MHA, else 2), d_ff ≤
    512, head_dim d_model // 4, sliding window ≤ 64. Ssm: no attention
    fields, state ≤ 16, head dim 32, chunk 32."""
    if cfg.family == "resnet":
        return dataclasses.replace(cfg, name=cfg.name + "-smoke", d_model=16,
                                   num_layers=8)
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"family '{cfg.family}' is not ported; only 'resnet', 'dense' and "
            "'ssm' are")
    d_model = min(cfg.d_model, 256)
    common = dict(name=cfg.name + "-smoke", num_layers=2, d_model=d_model,
                  vocab_size=min(cfg.vocab_size, 512))
    if cfg.family == "ssm":
        return dataclasses.replace(
            cfg, **common, num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0,
            ssm_state=min(cfg.ssm_state, 16), ssm_headdim=32, ssm_chunk=32)
    heads = 4
    return dataclasses.replace(
        cfg,
        **common,
        num_heads=heads,
        num_kv_heads=heads if cfg.num_kv_heads == cfg.num_heads else 2,
        d_ff=min(cfg.d_ff, 512),
        head_dim=d_model // heads,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
    )
