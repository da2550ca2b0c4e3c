"""Per-round selection/fairness/communication telemetry.

Counterpart of ``repro.obs.metrics``: numpy on the host, the parameter
bytes read from the engine's torch tensors.

``MetricsRegistry`` is the single source of truth for per-round numbers:
counters (arrivals, stragglers, bytes per tier), gauges, histogram-style
observation streams, and — the core artifact — one structured row per
round capturing the paper-aligned selection telemetry the engines used to
drop: the HeteRo score decomposition (value / diversity / momentum /
fairness / staleness / norm means from ``core/scoring``), cumulative
participation counts reduced to a Gini coefficient and a normalized
selection entropy, staleness, straggler carry-forwards, bytes up/down
split by tier (WAN vs edge), and serving lag when a serve tier is
attached.

``capture_round`` is **idempotent per round**: the first caller builds the
row, later callers get it back. That is what lets ``VerboseHook`` render
its progress line from the registry (single source of truth) whether or
not a ``TelemetryHook`` already captured the round.

Everything here is *read-only observation* of the engine — it never
touches the engine's noise generators, ``engine.rng`` or client state, which is the
bitwise-non-perturbation contract the telemetry golden matrix pins.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np


def gini(counts) -> float:
    """Gini coefficient of a participation-count vector (0 = perfectly even).

    Uses the sorted-index identity G = (2·Σᵢ i·xᵢ)/(n·Σx) − (n+1)/n with
    1-based ranks over ascending counts. Returns 0.0 for empty or all-zero
    input (no participation yet ⇒ no measurable inequality).
    """
    x = np.asarray(counts, dtype=np.float64).ravel()
    n = x.size
    total = float(x.sum())
    if n == 0 or total <= 0.0:
        return 0.0
    xs = np.sort(x)
    ranks = np.arange(1, n + 1, dtype=np.float64)
    return float((2.0 * (ranks * xs).sum()) / (n * total) - (n + 1) / n)


def selection_entropy(counts) -> float:
    """Normalized Shannon entropy of the participation distribution.

    1.0 = perfectly uniform participation, 0.0 = one client takes every
    slot. Returns 0.0 for empty/all-zero input and 1.0 for a single client
    (a one-point distribution is trivially uniform).
    """
    x = np.asarray(counts, dtype=np.float64).ravel()
    n = x.size
    total = float(x.sum())
    if n == 0 or total <= 0.0:
        return 0.0
    if n == 1:
        return 1.0
    p = x[x > 0] / total
    h = float(-(p * np.log(p)).sum())
    return h / math.log(n)


class MetricsRegistry:
    """Counters / gauges / histograms plus one structured row per round."""

    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, List[float]] = {}
        self.rounds: List[Dict[str, Any]] = []
        self._sel_counts: Optional[np.ndarray] = None
        self._param_bytes: Optional[int] = None
        self._prev_wire: float = 0.0

    # -- primitive instruments ---------------------------------------------

    def count(self, name: str, delta: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + float(delta)

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        self.hists.setdefault(name, []).append(float(value))

    def hist_summary(self, name: str) -> Dict[str, float]:
        vals = np.asarray(self.hists.get(name, ()), dtype=np.float64)
        if vals.size == 0:
            return {"count": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0,
                    "max": 0.0}
        return {"count": int(vals.size), "mean": float(vals.mean()),
                "p50": float(np.percentile(vals, 50)),
                "p95": float(np.percentile(vals, 95)),
                "max": float(vals.max())}

    def series(self, key: str) -> List[float]:
        """The per-round trajectory of one row field (missing → 0.0)."""
        return [float(r.get(key, 0.0)) for r in self.rounds]

    @property
    def selection_counts(self) -> np.ndarray:
        if self._sel_counts is None:
            return np.zeros(0, dtype=np.int64)
        return self._sel_counts.copy()

    # -- the per-round capture ---------------------------------------------

    def capture_round(self, ctx, components: Optional[Dict[str, float]] = None,
                      extra: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
        """Build (or return) the telemetry row for ``ctx.round_idx``.

        Idempotent: if this round was already captured the existing row is
        returned untouched, so multiple hooks can share one registry.
        Reads only host-side ctx/engine fields — never consumes RNG.
        """
        t = int(ctx.round_idx)
        if self.rounds and self.rounds[-1].get("round") == t:
            return self.rounds[-1]
        eng = ctx.engine

        mask = np.asarray(ctx.mask) if ctx.mask is not None else None
        n_dispatched = int(mask.sum()) if mask is not None else 0
        if self._sel_counts is None and mask is not None:
            self._sel_counts = np.zeros(mask.shape[0], dtype=np.int64)
        if mask is not None:
            self._sel_counts += mask.astype(np.int64)

        if self._param_bytes is None:
            self._param_bytes = int(sum(
                int(x.element_size()) * int(x.numel())
                for x in eng.params.values()))
        pb = self._param_bytes

        # Communication, split by tier. Downlink: every dispatched client
        # receives the global params. Uplink: flat-sync clients upload to
        # the cloud (WAN); flat-async only the arrivals do; hierarchical
        # clients upload to their edge and only edge aggregates cross the
        # WAN (cloud_uploads is the per-round count of those).
        n_arrivals = int(ctx.num_arrivals) if ctx.num_arrivals else 0
        cu = getattr(eng, "cloud_uploads", None)
        bytes_down = float(n_dispatched * pb)
        if cu:
            bytes_up_edge = float((n_arrivals or n_dispatched) * pb)
            bytes_up_wan = float(int(cu[-1]) * pb)
        else:
            bytes_up_edge = 0.0
            bytes_up_wan = float((n_arrivals or n_dispatched) * pb)
        wire_delta = float(eng.wire_total) - self._prev_wire
        self._prev_wire = float(eng.wire_total)

        rs = getattr(eng, "round_staleness", None)
        staleness_mean = float(rs[-1]) if rs else 0.0
        n_stragglers = int(ctx.num_stragglers) if ctx.num_stragglers else 0

        sc = self._sel_counts if self._sel_counts is not None else ()
        row: Dict[str, Any] = {
            "round": t,
            "sim_time": float(ctx.sim_time) if ctx.sim_time else float(t + 1),
            "metric": float(ctx.metric),
            "train_loss": float(ctx.train_loss),
            "n_selected": n_dispatched,
            "n_arrivals": n_arrivals,
            "n_stragglers": n_stragglers,
            "select_ms": float(ctx.select_ms),
            "execute_ms": float(ctx.execute_ms),
            "aggregate_ms": float(ctx.aggregate_ms),
            "part_gini": gini(sc),
            "sel_entropy": selection_entropy(sc),
            "staleness_mean": staleness_mean,
            "bytes_down": bytes_down,
            "bytes_up_edge": bytes_up_edge,
            "bytes_up_wan": bytes_up_wan,
            "wire_bytes": wire_delta,
        }
        if components:
            for k, v in components.items():
                row[f"score_{k}"] = float(v)
        if extra:
            for k, v in extra.items():
                row[k] = float(v)
        self.rounds.append(row)

        self.count("rounds")
        self.count("arrivals", n_arrivals or n_dispatched)
        self.count("stragglers", n_stragglers)
        self.count("bytes_down", bytes_down)
        self.count("bytes_up_edge", bytes_up_edge)
        self.count("bytes_up_wan", bytes_up_wan)
        self.count("wire_bytes", wire_delta)
        self.gauge("updates_dropped", float(getattr(eng, "updates_dropped", 0)))
        self.gauge("stragglers_carried",
                   float(getattr(eng, "stragglers_carried", 0)))
        if rs:
            self.observe("staleness", staleness_mean)
        if extra and "serve_lag" in extra and extra.get("serve_requests", 0):
            self.observe("serve_lag", float(extra["serve_lag"]))
        return row

    def format_round(self, row: Dict[str, Any], *, selector: str,
                     metric_name: str) -> str:
        """The per-round progress line ``VerboseHook`` prints."""
        return (f"[{selector}] round {int(row['round']):3d}  "
                f"{metric_name}={row['metric']:.4f}  "
                f"loss={row['train_loss']:.4f}")

    # -- snapshot / restore (checkpoint-resume-safe telemetry) -------------

    def snapshot(self) -> Dict[str, Any]:
        """A JSON-able summary of everything the registry holds."""
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {k: self.hist_summary(k) for k in self.hists},
            "rounds": [dict(r) for r in self.rounds],
            "selection_counts": [int(c) for c in np.asarray(
                self._sel_counts if self._sel_counts is not None else [])],
        }

    def state_dict(self) -> Dict[str, Any]:
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "hists": {k: list(v) for k, v in self.hists.items()},
            "rounds": [dict(r) for r in self.rounds],
            "sel_counts": (None if self._sel_counts is None
                           else self._sel_counts.tolist()),
            "prev_wire": self._prev_wire,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """In-place restore, so hooks sharing this registry keep their ref."""
        self.counters = dict(state["counters"])
        self.gauges = dict(state["gauges"])
        self.hists = {k: list(v) for k, v in state["hists"].items()}
        self.rounds = [dict(r) for r in state["rounds"]]
        sc = state.get("sel_counts")
        self._sel_counts = (None if sc is None
                            else np.asarray(sc, dtype=np.int64))
        self._prev_wire = float(state.get("prev_wire", 0.0))
