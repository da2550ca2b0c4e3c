"""Architecture registry: ``--arch <id>`` resolution, the input shapes and
reduced smoke variants, as ``repro.configs.registry``; and the port's own
``expert_share`` of an MoE config."""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs import (grok_1_314b, hubert_xlarge, kimi_k2_1t_a32b,
                                 llama3_405b, llama_3_2_vision_90b, mamba2_370m,
                                 minicpm_2b, qwen2_0_5b, resnet18_cifar10, yi_9b,
                                 zamba2_7b)
from repro_torch.configs.base import ExpertShareConfig, ModelConfig, ShapeConfig
from repro_torch.configs.shapes import SHAPES

_MODULES = (
    qwen2_0_5b,
    minicpm_2b,
    llama_3_2_vision_90b,
    kimi_k2_1t_a32b,
    mamba2_370m,
    hubert_xlarge,
    llama3_405b,
    yi_9b,
    zamba2_7b,
    grok_1_314b,
    resnet18_cifar10,
)

ARCHS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
# The ten architectures of the reference's registry besides the paper's own
# resnet18.
ASSIGNED: List[str] = [m.CONFIG.name for m in _MODULES[:-1]]


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch '{arch}'; available: {sorted(ARCHS)}")
    return ARCHS[arch]


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def list_archs() -> List[str]:
    return sorted(ARCHS)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests, field for field the
    reference's: resnet at width 16 and 8 layers; every other family at 2
    layers, d_model ≤ 256, vocab ≤ 512, d_ff ≤ 512; 4 heads where the model
    has attention (KV heads 4 if it is MHA, else 2), head_dim d_model // 4,
    sliding window ≤ 64; ≤ 4 experts, top-k ≤ 2; SSM state ≤ 16, head dim
    32, chunk 32; a shared attention block (hybrid) or a cross-attention
    layer (vlm) every 2nd layer, 16 vision tokens."""
    if cfg.family == "resnet":
        return dataclasses.replace(cfg, name=cfg.name + "-smoke", d_model=16, num_layers=8)
    d_model = min(cfg.d_model, 256)
    heads = 4 if cfg.num_heads else 0
    kv = 0
    if cfg.num_kv_heads:
        # keep the GQA/MHA character: kv == heads stays MHA, else GQA 2.
        kv = heads if cfg.num_kv_heads == cfg.num_heads else 2
    return dataclasses.replace(
        cfg,
        num_layers=2,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512) if cfg.vocab_size else 0,
        head_dim=(d_model // heads) if heads else 0,
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        num_experts_per_tok=min(cfg.num_experts_per_tok, 2) if cfg.num_experts_per_tok else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_headdim=32 if cfg.ssm_state else 64,
        ssm_chunk=32 if cfg.ssm_state else 256,
        shared_attn_every=2 if cfg.shared_attn_every else 0,
        cross_attn_every=2 if cfg.cross_attn_every else 0,
        vision_tokens=16 if cfg.cross_attn_every else cfg.vision_tokens,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        name=cfg.name + "-smoke",
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
