"""Models: the uniform facade (``build_model``) over the ported families."""

from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
