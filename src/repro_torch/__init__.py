"""PyTorch/CUDA port of the HeteRo-Select federation (``repro`` on JAX/TPU).

The module layout mirrors ``repro``: each module here is the counterpart of
the module of the same path there. The port imports ``torch`` and numpy,
never ``jax`` and nothing of ``repro``. Public entry points run on
``device="cuda"`` unless the caller passes ``device="cpu"``; a CUDA run on
a machine without a card raises (``repro_torch.device.resolve_device``).
"""
