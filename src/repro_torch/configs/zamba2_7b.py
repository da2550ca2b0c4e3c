"""Zamba2-7B — Mamba2 backbone + shared attention block [arXiv:2411.15242].

81 layers; every 6th layer applies the single *shared* attention block
(weights reused across applications), remaining layers are Mamba2 blocks.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid", num_layers=81, d_model=3584,
    num_heads=32, num_kv_heads=32, d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_chunk=256,
    shared_attn_every=6,
    citation="arXiv:2411.15242 (Zamba2)",
)
