"""repro_torch.obs — the telemetry plane (tracing, metrics, stability
reports), counterpart of ``repro.obs``.

  * ``obs.trace`` — dual-timeline Chrome trace-event recording (stdlib
    only, so the host-side ``fed.clock`` can import it);
  * ``obs.metrics`` — the per-round ``MetricsRegistry`` (numpy);
  * ``obs.stability`` — the Table-1 ``StabilityReport`` (numpy only);
  * ``obs.matrix`` — the selector × regime × scenario ``MatrixReport``
    aggregator over many stability reports (numpy only).

``TelemetryHook`` (``obs.hook``) wires them into an engine; it is exposed
lazily here because ``obs.hook`` imports ``repro_torch.fed.engine``, which
itself imports the layers above.
"""

from repro_torch.obs.matrix import (
    MATRIX_SCENARIOS,
    REGIMES,
    MatrixCell,
    MatrixReport,
    cell_support,
)
from repro_torch.obs.metrics import MetricsRegistry, gini, selection_entropy
from repro_torch.obs.stability import StabilityReport
from repro_torch.obs.trace import (
    NULL_TRACER,
    NullRecorder,
    TraceRecorder,
    load_jsonl,
    validate_trace_events,
)

__all__ = [
    "MATRIX_SCENARIOS",
    "MatrixCell",
    "MatrixReport",
    "MetricsRegistry",
    "NULL_TRACER",
    "NullRecorder",
    "REGIMES",
    "StabilityReport",
    "TelemetryHook",
    "TraceRecorder",
    "cell_support",
    "gini",
    "load_jsonl",
    "selection_entropy",
    "validate_trace_events",
]


def __getattr__(name):  # PEP 562: defer the fed-importing layer
    if name == "TelemetryHook":
        from repro_torch.obs.hook import TelemetryHook

        return TelemetryHook
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
