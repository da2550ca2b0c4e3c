"""Llama-3.2-Vision-90B — decoder with cross-attn image layers every 5th
layer [hf:meta-llama/Llama-3.2-11B-Vision, scaled to the 90B variant].

The vision tower is a stub, as in the reference: ``input_specs`` gives
projected patch embeddings (batch, vision_tokens, d_model).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm", num_layers=100, d_model=8192,
    num_heads=64, num_kv_heads=8, d_ff=28672, vocab_size=128256,
    rope_theta=5e5, cross_attn_every=5, vision_tokens=1601,
    citation="hf:meta-llama/Llama-3.2-11B-Vision (90B variant)",
)
