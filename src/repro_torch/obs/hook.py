"""TelemetryHook: attaches the whole telemetry plane to one federated run.

Counterpart of ``repro.obs.hook``. One hook wires the ``repro_torch.obs``
pieces into any engine:

  * swaps a live ``TraceRecorder`` into ``engine.tracer`` (and the virtual
    clock's ``tracer``, re-attached every round because checkpoint restore
    replaces the clock object), so every phase span, completion event,
    checkpoint save and serve/publish wave lands on the dual timeline;
  * captures one ``MetricsRegistry`` row per round, with the HeteRo score
    decomposition computed from the *pre-selection* client state (the flat
    async engine contributes its clock-measured staleness override; the
    other engines use the round counter, as the reference's hook does) and
    the serving lag of any sibling ``PublishHook``;
  * writes the ``StabilityReport`` artifacts (``report.md`` +
    ``report.json``) and the Perfetto-loadable ``trace.json`` under
    ``trace_dir`` at run end, and surfaces a JSON-able summary as
    ``FLResult.telemetry``.

Attaching the hook leaves training bitwise unchanged: it only reads ctx and
engine fields and evaluates ``compute_score_components``, which draws
nothing; the noise generators, ``engine.rng``, the client state and the
clock's event heap are never touched.

Checkpoint/resume: ``state_dict``/``load_state_dict`` round-trip the
registry and the sim-timeline cursor through ``CheckpointHook``, and the
JSONL stream opens in append mode, so a resumed run emits a seamless trace
and seamless per-round series.

``priority = 10`` puts this hook right after the engine's ``MetricsHook``
(pinned to slot 0), so its registry row exists before consumers such as
``VerboseHook`` (priority 0) render from it.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.scoring import HeteRoScoreConfig, compute_score_components
from repro_torch.fed.engine import RoundContext, RoundHook
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.stability import StabilityReport
from repro_torch.obs.trace import PID_WALL, TraceRecorder, load_jsonl


class TelemetryHook(RoundHook):
    """Record traces + per-round telemetry + the stability report.

    Parameters
    ----------
    trace_dir: directory for the run artifacts (``trace.jsonl`` stream,
        ``trace.json`` Chrome export, ``report.md``/``report.json``).
        None records in memory only (``recorder.events`` / the registry).
    recorder / registry: inject existing instances (tests, shared
        registries); fresh ones are built by default.
    stream_jsonl: also append every event to ``trace_dir/trace.jsonl``.
    report: write the ``StabilityReport`` artifacts at run end.
    score_components: compute the per-round HeteRo score decomposition
        (one extra scoring pass per round; disable for minimal overhead).
    """

    priority = 10

    def __init__(self, trace_dir: Optional[str] = None, *,
                 recorder: Optional[TraceRecorder] = None,
                 registry: Optional[MetricsRegistry] = None,
                 stream_jsonl: bool = True, report: bool = True,
                 score_components: bool = True):
        self.trace_dir = trace_dir
        self.recorder = recorder
        self.registry = registry if registry is not None else MetricsRegistry()
        self.stream_jsonl = stream_jsonl
        self.report = report
        self.score_components = score_components
        self.report_paths: Optional[Tuple[str, str]] = None
        self._score_cfg: Optional[HeteRoScoreConfig] = None
        self._metric_name = "accuracy"
        self._components: Optional[Dict[str, float]] = None
        self._prev_close = 0.0
        self._served_seen = 0

    # -- lifecycle ---------------------------------------------------------

    def on_run_start(self, ctx: RoundContext) -> None:
        eng = ctx.engine
        if self.recorder is None:
            jsonl = None
            if self.trace_dir:
                os.makedirs(self.trace_dir, exist_ok=True)
                if self.stream_jsonl:
                    jsonl = os.path.join(self.trace_dir, "trace.jsonl")
            self.recorder = TraceRecorder(jsonl)
        eng.tracer = self.recorder
        self._score_cfg = eng.spec.score_cfg or HeteRoScoreConfig()
        self._metric_name = eng.metric_name

    def on_round_start(self, ctx: RoundContext) -> None:
        eng = ctx.engine
        if eng.tracer is not self.recorder:
            eng.tracer = self.recorder
        clock = getattr(eng, "clock", None)
        if clock is not None and clock.tracer is not self.recorder:
            # Checkpoint restore rebuilds the clock object; re-attach.
            clock.tracer = self.recorder
        if self.score_components:
            # Pre-selection decomposition: the component values the selector
            # is about to score this round's cohort with. Draws nothing.
            over_fn = getattr(eng, "staleness_override", None)
            over = over_fn() if callable(over_fn) else None
            comp = compute_score_components(eng.state, ctx.round_idx, self._score_cfg,
                                            staleness_override=over)
            self._components = {
                k: float(v.detach().cpu().numpy().astype(np.float64).mean())
                for k, v in comp.items()}

    def on_round_end(self, ctx: RoundContext) -> None:
        eng = ctx.engine
        extra = self._serve_extra(eng)
        self.registry.capture_round(ctx, components=self._components, extra=extra)
        close = float(ctx.sim_time) if ctx.sim_time else float(ctx.round_idx + 1)
        self.recorder.sim_span(
            "round", self._prev_close, close, track="rounds",
            args={"round": int(ctx.round_idx),
                  "arrivals": int(ctx.num_arrivals),
                  "stragglers": int(ctx.num_stragglers)})
        self._prev_close = close
        self.recorder.flush()

    def on_run_end(self, ctx: RoundContext) -> None:
        rec = self.recorder
        if self.trace_dir:
            events = None
            if rec.jsonl_path and os.path.exists(rec.jsonl_path):
                # Export from the stream, so a resumed run's trace.json holds
                # the prefix from before the preemption too.
                rec.flush()
                events = load_jsonl(rec.jsonl_path)
            rec.export_chrome(os.path.join(self.trace_dir, "trace.json"), events=events)
            if self.report:
                rep = StabilityReport.from_registry(self.registry, self._metric_name)
                self.report_paths = rep.write(self.trace_dir)
        rec.close()

    def contribute(self, extras: Dict[str, Any]) -> None:
        tel: Dict[str, Any] = {
            "registry": self.registry.snapshot(),
            "stability": StabilityReport.from_registry(
                self.registry, self._metric_name).summary(),
        }
        if self.report_paths is not None:
            tel["report_md"], tel["report_json"] = self.report_paths
        if self.recorder is not None and self.trace_dir:
            tel["trace_json"] = os.path.join(self.trace_dir, "trace.json")
        extras["telemetry"] = tel

    # -- resume safety -----------------------------------------------------

    def state_dict(self) -> Optional[Dict[str, Any]]:
        return {"registry": self.registry.state_dict(),
                "prev_close": self._prev_close,
                "wall_cursor": (float(self.recorder.wall_cursor)
                                if self.recorder is not None else 0.0)}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.registry.load_state_dict(state["registry"])
        self._prev_close = float(state.get("prev_close", 0.0))
        # Splice the wall timeline: resume recording right after the killed
        # process's last event. The JSONL stream is authoritative when
        # present: it also holds events emitted after this state was
        # snapshotted (the checkpoint_save span itself).
        cursor = float(state.get("wall_cursor", 0.0))
        rec = self.recorder
        if rec is not None and rec.jsonl_path and os.path.exists(rec.jsonl_path):
            for ev in load_jsonl(rec.jsonl_path):
                if ev.get("ph") != "M" and ev.get("pid") == PID_WALL:
                    cursor = max(cursor, float(ev["ts"]) + float(ev.get("dur", 0.0)))
        if cursor > 0.0 and rec is not None:
            rec.rebase_wall(cursor)

    # -- serving-lag bridge -------------------------------------------------

    def _serve_extra(self, eng) -> Optional[Dict[str, float]]:
        """Mean served-version lag of the requests new since last round,
        from a sibling ``PublishHook`` (any hook whose ``metrics.records`` is
        a request list)."""
        for h in eng.hooks:
            if h is self:
                continue
            recs = getattr(getattr(h, "metrics", None), "records", None)
            if recs is None:
                continue
            new = recs[self._served_seen:]
            self._served_seen = len(recs)
            if not new:
                return {"serve_requests": 0.0, "serve_lag": 0.0}
            return {"serve_requests": float(len(new)),
                    "serve_lag": float(np.mean([r.lag_rounds for r in new]))}
        return None
