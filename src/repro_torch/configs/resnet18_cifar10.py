"""ResNet-18 on CIFAR-10 — the paper's own experimental setup (Sec IV).

GroupNorm replaces BatchNorm (rationale in models/resnet.py).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="resnet18-cifar10", family="resnet", num_layers=18, d_model=64,
    image_size=32, num_classes=10,
    citation="HeteRo-Select paper Sec IV (CIFAR-10, ResNet-18)",
)
