"""Device resolution shared by the port's entry points.

A ``"cuda"`` request on a machine without a card raises instead of
continuing on the CPU. On the card, TF32 is switched off for matmuls and
cuDNN convolutions: the JAX reference computes both in full float32, and
TF32 keeps only about three decimal digits.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but torch sees no CUDA device; "
                "pass device='cpu' to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device, so a host clock read after it covers its work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
