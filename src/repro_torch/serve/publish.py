"""PublishHook: the bridge from federated training to the serving tier.

Counterpart of ``repro.serve.publish``. A ``RoundHook`` that, at every
round close, (1) serves the inference traffic that arrived during the round
against the *previously* published version, (2) evaluates the
currently-served version (accuracy-under-traffic), and (3) publishes the
round's freshly aggregated params into the ``VersionRegistry`` — in that
order, so round t's traffic always runs on the round t-1 publish: serve v
while v+1 aggregates.

Clock sharing: under the async round policy the hook schedules arrivals on
the engine's own ``VirtualClock`` via a named channel sub-queue
(``fed.clock.ChannelQueue``), so training completions and inference
requests interleave on one event queue; under the sync policy it keeps a
private clock and uses the uniform ``ctx.sim_time`` (= t+1) round closes.
Either way the training engine's observables are untouched.

Bitwise non-interference is a hard contract: the hook never touches the
engine's generators (``engine.generators``, the init and noise draws),
torch's global generator, the engine's numpy ``rng``, client state or the
training event heap; traffic draws from its own numpy stream and each
request's sampling from its own source; eval of served params is
deterministic; and publishing keeps a reference to the round's params, which
nothing writes afterwards (no copy). ``tests/test_torch_serving.py`` proves
training metrics, selection history, wall clock and final params bitwise
identical with and without this hook, for {sync, async} × {flat,
hierarchical}.

With a ``TelemetryHook`` attached each round records a ``serve_wave``
span (round, requests) and a ``publish`` span (round) on the "serve" track.

Attach it like any hook::

    hook = PublishHook(traffic=TrafficConfig(rate=4.0), batch_width=4)
    res = FederatedSpec(model, fed, data, hooks=[hook]).build().run()
    res.serving            # latency / throughput / lag summary
    res.served_metric      # (n, 3) rows: round, version, served metric
"""

from __future__ import annotations

import time
from typing import Any, List, Optional, Tuple

import numpy as np

from repro_torch.fed.clock import VirtualClock
from repro_torch.fed.engine import RoundContext, RoundHook
from repro_torch.serve.metrics import ServingMetrics
from repro_torch.serve.server import ModelServer, VersionRegistry
from repro_torch.serve.traffic import TrafficConfig, TrafficSimulator


class PublishHook(RoundHook):
    """Per-round publish + serve + accuracy-under-traffic.

    Parameters
    ----------
    registry: reuse an external ``VersionRegistry`` (e.g. shared with a
        long-lived server); a fresh one is created by default.
    traffic: a ``TrafficConfig`` to simulate live requests each round; None
        publishes versions without serving anything.
    batch_width / max_len: the internal ``ModelServer`` geometry (only used
        when ``traffic`` is given; it serves on the engine's device).
        ``max_len`` must cover the traffic's worst-case prompt+output
        length — the server checks, loudly.
    min_metric: metric gate — rounds whose eval metric falls below it do
        NOT publish (the serve tier keeps the last good version and
        ``lag_rounds`` grows). None publishes every round.
    eval_every: evaluate the currently-served version every N rounds into
        ``FLResult.served_metric`` (0 disables).
    publish_init: publish the pre-training init params as version 0 at run
        start, so round-0 traffic has something to be served by.
    """

    def __init__(self, *, registry: Optional[VersionRegistry] = None,
                 traffic: Optional[TrafficConfig] = None, batch_width: int = 4,
                 max_len: int = 64, min_metric: Optional[float] = None,
                 eval_every: int = 1, publish_init: bool = True, channel: str = "serve"):
        self.registry = registry
        self.traffic = traffic
        self.batch_width = int(batch_width)
        self.max_len = int(max_len)
        self.min_metric = min_metric
        self.eval_every = int(eval_every)
        self.publish_init = bool(publish_init)
        self.channel = channel
        self.metrics = ServingMetrics()
        self.server: Optional[ModelServer] = None
        self.sim: Optional[TrafficSimulator] = None
        self._own_clock: Optional[VirtualClock] = None
        self._eval_batch: Any = None
        self._served: List[Tuple[float, float, float]] = []

    # -- lifecycle ---------------------------------------------------------

    def on_run_start(self, ctx: RoundContext) -> None:
        engine = ctx.engine
        if self.registry is None:
            self.registry = VersionRegistry()
        if self.traffic is not None:
            model = engine.spec.model
            if not model.has_decode:
                raise ValueError(
                    f"PublishHook(traffic=...) needs a decoding model family "
                    f"to serve; {model.cfg.name} ({model.cfg.family}) has no "
                    "decode path")
            self.sim = TrafficSimulator(self.traffic, vocab=model.cfg.vocab_size)
            self.server = ModelServer(model, self.registry, batch_width=self.batch_width,
                                      max_len=self.max_len, metrics=self.metrics,
                                      device=engine.device)
        # Fallback time source for sync engines (which have no clock of
        # their own); async engines share theirs via ctx.engine.clock.
        self._own_clock = VirtualClock()
        if self.publish_init:
            t0 = time.perf_counter()
            self.registry.publish(engine.params, round_idx=-1, step=0)
            self.metrics.record_publish((time.perf_counter() - t0) * 1e3)

    def on_round_end(self, ctx: RoundContext) -> None:
        engine = ctx.engine
        close = ctx.sim_time if ctx.sim_time > 0 else float(ctx.round_idx + 1)

        # 1) Serve the traffic that arrived during this round — against the
        #    registry as published through round t-1 (the new params are not
        #    in the registry yet: serve v while v+1 aggregates).
        tracer = engine.tracer
        if self.server is not None:
            tw0 = time.perf_counter() if tracer.enabled else 0.0
            clock = getattr(engine, "clock", None) or self._own_clock
            queue = clock.channel(self.channel)
            self.sim.schedule_until(queue, close)
            n_requests = 0
            for ev in queue.pop_due(close):
                self.server.submit(ev.payload, arrival_round=ctx.round_idx, now=ev.time)
                n_requests += 1
            self.server.pump()
            if tracer.enabled:
                tracer.wall_span("serve_wave", tw0, time.perf_counter(), track="serve",
                                 cat="serve", args={"round": ctx.round_idx,
                                                    "requests": n_requests})

        # 2) Accuracy-under-traffic: evaluate the version traffic is being
        #    served by (NOT the just-aggregated params).
        if self.eval_every and ctx.round_idx % self.eval_every == 0:
            served = self.registry.latest()
            if served is not None:
                if self._eval_batch is None:
                    self._eval_batch = {k: v.to(engine.device)
                                        for k, v in engine.spec.data.eval_batch().items()}
                val = engine.eval_fn(engine.spec.model, served.params, self._eval_batch)
                self._served.append((float(ctx.round_idx), float(served.version),
                                     float(val)))

        # 3) Publish this round's aggregated params (optionally gated).
        if self.min_metric is not None and ctx.metric < self.min_metric:
            self.metrics.publishes_skipped += 1
            return
        t0 = time.perf_counter()
        self.registry.publish(engine.params, round_idx=ctx.round_idx,
                              step=engine.spec.resolved_steps * (ctx.round_idx + 1),
                              metric=ctx.metric)
        t1 = time.perf_counter()
        self.metrics.record_publish((t1 - t0) * 1e3)
        if tracer.enabled:
            tracer.wall_span("publish", t0, t1, track="serve", cat="serve",
                             args={"round": ctx.round_idx})

    def contribute(self, extras: dict) -> None:
        summary = self.metrics.summary()
        latest = self.registry.latest() if self.registry is not None else None
        if latest is not None:
            summary["latest_version"] = latest.version
            summary["latest_version_round"] = latest.round
        extras["serving"] = summary
        if self._served:
            extras["served_metric"] = np.asarray(self._served, np.float64)
