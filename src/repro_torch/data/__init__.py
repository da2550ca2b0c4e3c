"""Data: synthetic federated datasets (vision and language modelling)."""

from repro_torch.data.synthetic import (LMFedData, VisionFedData, make_lm_data,
                                        make_vision_data, synthetic_client_state)

__all__ = ["LMFedData", "VisionFedData", "make_lm_data", "make_vision_data",
           "synthetic_client_state"]
