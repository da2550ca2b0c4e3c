"""Data: synthetic federated datasets (vision, lazy and drifting vision at
cross-device scale, language modelling) and the model inputs of each input
shape."""

from repro_torch.data.synthetic import (DriftingVisionFedData, LazyVisionFedData,
                                        LMFedData, VisionFedData, input_specs,
                                        make_drifting_vision_data,
                                        make_lazy_vision_data, make_lm_data,
                                        make_vision_data, synthetic_client_state)

__all__ = ["DriftingVisionFedData", "LazyVisionFedData", "LMFedData", "VisionFedData",
           "input_specs", "make_drifting_vision_data", "make_lazy_vision_data",
           "make_lm_data", "make_vision_data", "synthetic_client_state"]
