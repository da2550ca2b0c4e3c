"""Data: synthetic federated datasets."""

from repro_torch.data.synthetic import VisionFedData, make_vision_data

__all__ = ["VisionFedData", "make_vision_data"]
