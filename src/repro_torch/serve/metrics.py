"""Serving telemetry: per-request records and run-level aggregation.

Counterpart of ``repro.serve.metrics``, unchanged (it holds no array).

One ``RequestRecord`` per completed inference request, carrying the three
latency spans the serving literature reports (queue / prefill / decode, all
host-measured milliseconds), the tokens it produced, and — the federated
twist — *which published version served it* and how far that version
trailed the training frontier. ``ServingMetrics`` accumulates records plus
publish (hot-swap) costs and reduces them to the summary dict exported into
``FLResult.serving``.

Two clocks appear here, deliberately:

  * virtual time (``arrival_time``, ``arrival_round``) — where the request
    sits on the federation's event axis (``fed.clock.VirtualClock``);
  * host time (the ``*_ms`` spans, throughput) — what serving it actually
    cost; a decode tick ends when its sampled tokens reach the host, which
    waits for the device, so on a card the spans cover the device work.

Training numerics never flow through this module; it is read-only
observation of the serving tier.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class RequestRecord:
    """One completed inference request, as served."""

    rid: int                 # request id (traffic-simulator assigned)
    arrival_time: float      # virtual time the request arrived
    arrival_round: int       # training round it arrived during (-1 offline)
    prompt_len: int
    output_len: int
    tokens: Tuple[int, ...]  # the generated token ids
    version: int             # PublishedVersion.version that served it
    version_round: int       # training round that version was published at
    lag_rounds: int          # arrival_round - version_round (staleness)
    queue_ms: float          # submit → slot admission (host)
    prefill_ms: float        # admission → last prompt token fed (host)
    decode_ms: float         # first sample → completion (host)

    @property
    def total_ms(self) -> float:
        return self.queue_ms + self.prefill_ms + self.decode_ms


def _percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile without numpy (tiny n, exactness over speed)."""
    if not values:
        return 0.0
    xs = sorted(values)
    idx = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
    return float(xs[idx])


def _mean(values: Sequence[float]) -> float:
    return float(sum(values) / len(values)) if values else 0.0


class ServingMetrics:
    """Accumulates request records + publish costs; reduces to a summary."""

    def __init__(self) -> None:
        self.records: List[RequestRecord] = []
        self.publish_ms: List[float] = []   # per-publish hot-swap cost
        self.publishes_skipped = 0          # metric-gated publishes withheld
        self.decode_step_ms = 0.0           # host time inside decode ticks
        self.decode_tokens = 0              # tokens produced by those ticks

    def extend(self, records: Sequence[RequestRecord]) -> None:
        self.records.extend(records)

    def record_publish(self, ms: float) -> None:
        self.publish_ms.append(float(ms))

    def record_decode(self, ms: float, tokens: int) -> None:
        self.decode_step_ms += float(ms)
        self.decode_tokens += int(tokens)

    def summary(self) -> Dict[str, Any]:
        """The serving headline block (``FLResult.serving``).

        ``decode_tok_per_s`` is aggregate decode throughput: tokens emitted
        per second of host time spent inside decode ticks — the continuous-
        batching win shows up here because concurrent slots share ticks.
        ``time_to_serve_v1_ms`` is the hot-swap cost: host ms from a round's
        aggregated params to the new version being routable (registry
        append — the atomicity design makes this O(1), which is the point).
        """
        recs = self.records
        tok_s = (self.decode_tokens / (self.decode_step_ms / 1e3)
                 if self.decode_step_ms > 0 else 0.0)
        return {
            "requests": len(recs),
            "total_tokens": int(sum(r.output_len for r in recs)),
            "decode_tok_per_s": float(tok_s),
            "queue_ms_mean": _mean([r.queue_ms for r in recs]),
            "prefill_ms_mean": _mean([r.prefill_ms for r in recs]),
            "decode_ms_mean": _mean([r.decode_ms for r in recs]),
            "total_ms_mean": _mean([r.total_ms for r in recs]),
            "total_ms_p95": _percentile([r.total_ms for r in recs], 95.0),
            "mean_lag_rounds": _mean([float(r.lag_rounds) for r in recs]),
            "max_lag_rounds": int(max((r.lag_rounds for r in recs),
                                      default=0)),
            "versions_published": len(self.publish_ms),
            "publishes_skipped": self.publishes_skipped,
            "time_to_serve_v1_ms": _mean(self.publish_ms),
            "time_to_serve_v1_ms_max": float(max(self.publish_ms,
                                                 default=0.0)),
        }
