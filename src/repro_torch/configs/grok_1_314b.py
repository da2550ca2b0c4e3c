"""Grok-1 (314B) — MoE, 8 experts top-2 [hf:xai-org/grok-1].

Registered for its config only: one expert layer (4.83 B parameters) does
not fit one card for federated training at any depth.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe", num_layers=64, d_model=6144,
    num_heads=48, num_kv_heads=8, d_ff=32768, vocab_size=131072,
    num_experts=8, num_experts_per_tok=2,
    citation="hf:xai-org/grok-1",
)
