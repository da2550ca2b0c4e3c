"""repro_torch.serve — the train-and-serve tier.

Counterpart of ``repro.serve``. Serve the federated global model under
live, virtually-clocked inference traffic *while rounds run*: an immutable
versioned params registry with atomic hot-swap, a fixed-width
continuous-microbatching decode server, a deterministic Poisson traffic
simulator on the federation's event queue, and a ``RoundHook`` that
publishes each round's aggregation — all without perturbing training
numerics (bitwise, tested).
"""

from repro_torch.serve.metrics import RequestRecord, ServingMetrics
from repro_torch.serve.publish import PublishHook
from repro_torch.serve.server import (ModelServer, PublishedVersion, VersionRegistry,
                                      generate)
from repro_torch.serve.traffic import Request, TrafficConfig, TrafficSimulator

__all__ = [
    "RequestRecord", "ServingMetrics", "PublishHook", "ModelServer",
    "PublishedVersion", "VersionRegistry", "generate", "Request",
    "TrafficConfig", "TrafficSimulator",
]
