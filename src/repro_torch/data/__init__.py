"""Data: synthetic federated datasets (vision and language modelling) and
the model inputs of each input shape."""

from repro_torch.data.synthetic import (LMFedData, VisionFedData, input_specs,
                                        make_lm_data, make_vision_data,
                                        synthetic_client_state)

__all__ = ["LMFedData", "VisionFedData", "input_specs", "make_lm_data",
           "make_vision_data", "synthetic_client_state"]
