"""MiniCPM-2B — llama-like dense, trained with WSD schedule [arXiv:2404.06395].

vocab 122753 is padded to 122880 (logits masked). The paper's
Warmup-Stable-Decay schedule is the reference's ``optim/schedules.py``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense", num_layers=40, d_model=2304,
    num_heads=36, num_kv_heads=36, d_ff=5760, vocab_size=122753,
    tie_embeddings=True,
    citation="arXiv:2404.06395 (MiniCPM: WSD schedule)",
)
