"""HuBERT-XLarge — encoder-only audio transformer [arXiv:2106.07447].

The conv/mel frontend is a stub, as in the reference: ``input_specs``
gives precomputed frame embeddings. Training objective: masked prediction
over vocab=504 cluster targets. Encoder-only: no decode step.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="encoder", num_layers=48, d_model=1280,
    num_heads=16, num_kv_heads=16, d_ff=5120, vocab_size=504,
    is_encoder=True,
    citation="arXiv:2106.07447 (HuBERT)",
)
