"""Architecture registry. The resnet, dense, ssm and moe families are ported."""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import (grok_1_314b, kimi_k2_1t_a32b, mamba2_370m, qwen2_0_5b,
                                 resnet18_cifar10)
from repro_torch.configs.base import ExpertShareConfig, ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (grok_1_314b, kimi_k2_1t_a32b, mamba2_370m, qwen2_0_5b, resnet18_cifar10)
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown or not yet ported arch '{arch}'; "
                       f"available: {sorted(ARCHS)}")
    return ARCHS[arch]


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests, as the reference's:
    resnet at width 16; dense, moe and ssm at 2 layers, d_model ≤ 256, vocab
    ≤ 512. Dense and moe: 4 heads (KV heads 4 if the model is MHA, else 2),
    d_ff ≤ 512, head_dim d_model // 4, sliding window ≤ 64; moe also ≤ 4
    experts and top-k ≤ 2. Ssm: no attention fields, state ≤ 16, head dim
    32, chunk 32."""
    if cfg.family == "resnet":
        return dataclasses.replace(cfg, name=cfg.name + "-smoke", d_model=16,
                                   num_layers=8)
    if cfg.family not in ("dense", "moe", "ssm"):
        raise NotImplementedError(
            f"family '{cfg.family}' is not ported; only 'resnet', 'dense', 'moe' "
            "and 'ssm' are")
    d_model = min(cfg.d_model, 256)
    common = dict(name=cfg.name + "-smoke", num_layers=2, d_model=d_model,
                  vocab_size=min(cfg.vocab_size, 512))
    if cfg.family == "ssm":
        return dataclasses.replace(
            cfg, **common, num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0,
            ssm_state=min(cfg.ssm_state, 16), ssm_headdim=32, ssm_chunk=32)
    if cfg.family == "moe":
        common.update(num_experts=min(cfg.num_experts, 4),
                      num_experts_per_tok=min(cfg.num_experts_per_tok, 2))
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


def expert_share(cfg: ModelConfig, *, experts_here: int, first_expert: int = 0,
                 vocab_size: int = 0, num_layers: int = 0) -> ExpertShareConfig:
    """One device's share of an MoE config: experts [first_expert,
    first_expert + experts_here) of ``num_experts``, every width as
    published (the router keeps all its outputs and top-k routes over all
    experts). ``vocab_size`` > 0 keeps that many vocabulary rows (a slice
    of the embedding and unembedding) and ``num_layers`` > 0 cuts depth."""
    if cfg.family != "moe":
        raise ValueError(f"an expert share needs an moe config, not '{cfg.family}'")
    if not (experts_here > 0 and 0 <= first_expert
            and first_expert + experts_here <= cfg.num_experts):
        raise ValueError(f"experts [{first_expert}, {first_expert + experts_here}) "
                         f"are not a share of {cfg.num_experts}")
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(ModelConfig)}
    fields.update(name=f"{cfg.name}-share{experts_here}of{cfg.num_experts}",
                  vocab_size=vocab_size or cfg.vocab_size,
                  num_layers=num_layers or cfg.num_layers)
    return ExpertShareConfig(**fields, experts_here=experts_here, first_expert=first_expert)
