"""Kimi K2 — trillion-parameter MoE, 384 experts top-8 [arXiv:2501.kimi2].

Per-assignment table: 61L, d_model 7168, 64H (GQA kv=8), per-expert d_ff 2048.
The reference's layout is expert-parallel (``moe_impl="a2a"``): each data
shard holds its own experts; ``registry.expert_share`` cuts the config to
one such shard.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe", num_layers=61, d_model=7168,
    num_heads=64, num_kv_heads=8, d_ff=2048, vocab_size=163840,
    num_experts=384, num_experts_per_tok=8, rope_theta=5e4,
    citation="arXiv:2501.kimi2 (Kimi K2, paper-table)",
)
