"""Dual-timeline trace recording: virtual sim-time + host wall-time spans.

Counterpart of ``repro.obs.trace``, the same module (stdlib only, so the
host-side ``fed.clock`` can import it). ``TraceRecorder`` is the flight
recorder behind the telemetry plane (``repro_torch.obs``): every engine
phase (select / execute / aggregate / eval, the hierarchical outer/inner
selection split and per-edge executor calls), every virtual-clock event
(client completions, serve-channel arrivals), checkpoint saves and
publish/serve waves record onto one of two timelines:

  * **pid 1 — host wall-time**: ``B``/``E`` span pairs timed with
    ``time.perf_counter`` relative to the recorder's epoch. On a card each
    engine phase ends in a device synchronize, so its span covers the
    device work; the span is cut from the same clock readings as the
    ``FLResult.*_ms`` it mirrors.
  * **pid 2 — virtual sim-time**: ``X`` complete events and ``i`` instant
    events whose timestamps are the federation's virtual clock (one sim
    unit renders as one second), deterministic for a fixed seed.

Events are Chrome trace-event dicts from the moment they are recorded, so
the in-memory list, the append-only JSONL stream (one event per line, the
substrate for seamless resumed traces) and the exported ``trace.json``
(loadable in Perfetto / ``chrome://tracing``) are the same objects.
``validate_trace_events`` is the schema check: balanced ``B``/``E`` pairs
per track, monotone per-track timestamps, well-formed ``X``/``i`` events.

``NULL_TRACER`` is the disabled path: engines hold it by default and guard
every instrumentation site with ``if self.tracer.enabled:``, one attribute
read per site, so telemetry costs nothing until a ``TelemetryHook`` swaps
in a real recorder.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

# Chrome trace-event process ids for the two timelines.
PID_WALL = 1
PID_SIM = 2

_PROCESS_NAMES = {PID_WALL: "host wall-time", PID_SIM: "virtual sim-time"}


class NullRecorder:
    """The no-op recorder engines hold by default.

    ``enabled`` is the one attribute hot paths read (``if
    self.tracer.enabled:``); every method returns immediately so even an
    unguarded call is near-free. ``TraceRecorder`` subclasses this, which
    is what lets engine code treat the two uniformly.
    """

    enabled = False

    def wall_span(self, name: str, t0: float, t1: float, *,
                  track: str = "round", cat: str = "phase",
                  args: Optional[Dict[str, Any]] = None) -> None:
        pass

    def sim_span(self, name: str, t0: float, t1: float, *,
                 track: str = "rounds", cat: str = "sim",
                 args: Optional[Dict[str, Any]] = None) -> None:
        pass

    def instant(self, name: str, t_sim: float, *, track: str = "events",
                cat: str = "sim",
                args: Optional[Dict[str, Any]] = None) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


#: Module-level singleton: the engines' default ``tracer``. Never mutated.
NULL_TRACER = NullRecorder()


class TraceRecorder(NullRecorder):
    """Records dual-timeline spans as Chrome trace-event dicts.

    Parameters
    ----------
    jsonl_path: when given, every event is also appended to this file as
        one JSON line the moment it is recorded (``flush()`` makes the
        stream crash-durable at round granularity). Opened in append mode:
        a resumed run pointed at the same path continues the stream
        seamlessly instead of starting a zeroed trace.
    epoch: the ``time.perf_counter`` origin for wall timestamps; defaults
        to construction time so wall spans start near 0 µs.
    """

    enabled = True

    def __init__(self, jsonl_path: Optional[str] = None, *,
                 epoch: Optional[float] = None):
        self.events: List[Dict[str, Any]] = []
        self.jsonl_path = jsonl_path
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None
        self._epoch = time.perf_counter() if epoch is None else float(epoch)
        self._tids: Dict[Tuple[int, str], int] = {}
        self._pids_seen: set = set()
        self.wall_cursor = 0.0  # µs: max wall ts emitted (splice point)

    # -- track / emission plumbing ----------------------------------------

    def _tid(self, pid: int, track: str) -> int:
        """Stable per-(timeline, track) thread id, allocated on first use.

        Allocation emits the Chrome ``M`` metadata events (process/thread
        names) inline, so the JSONL stream is self-describing.
        """
        key = (pid, track)
        tid = self._tids.get(key)
        if tid is not None:
            return tid
        if pid not in self._pids_seen:
            self._pids_seen.add(pid)
            self._emit({"name": "process_name", "ph": "M", "ts": 0.0,
                        "pid": pid, "tid": 0,
                        "args": {"name": _PROCESS_NAMES.get(pid, str(pid))}})
        tid = len(self._tids) + 1
        self._tids[key] = tid
        self._emit({"name": "thread_name", "ph": "M", "ts": 0.0,
                    "pid": pid, "tid": tid, "args": {"name": track}})
        return tid

    def _emit(self, ev: Dict[str, Any]) -> None:
        self.events.append(ev)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(ev, separators=(",", ":")) + "\n")

    # -- recording API -----------------------------------------------------

    def wall_span(self, name, t0, t1, *, track="round", cat="phase",
                  args=None) -> None:
        """A host wall-time span: ``t0``/``t1`` are ``perf_counter`` reads."""
        tid = self._tid(PID_WALL, track)
        b = {"name": name, "ph": "B", "ts": (t0 - self._epoch) * 1e6,
             "pid": PID_WALL, "tid": tid, "cat": cat}
        if args:
            b["args"] = dict(args)
        self._emit(b)
        e_ts = (max(t1, t0) - self._epoch) * 1e6
        self._emit({"name": name, "ph": "E", "ts": e_ts,
                    "pid": PID_WALL, "tid": tid, "cat": cat})
        if e_ts > self.wall_cursor:
            self.wall_cursor = e_ts

    def sim_span(self, name, t0, t1, *, track="rounds", cat="sim",
                 args=None) -> None:
        """A virtual-time span (one sim unit renders as one second)."""
        tid = self._tid(PID_SIM, track)
        ev = {"name": name, "ph": "X", "ts": t0 * 1e6,
              "dur": max(t1 - t0, 0.0) * 1e6,
              "pid": PID_SIM, "tid": tid, "cat": cat}
        if args:
            ev["args"] = dict(args)
        self._emit(ev)

    def instant(self, name, t_sim, *, track="events", cat="sim",
                args=None) -> None:
        """An instant on the sim timeline (clock events: completions etc.)."""
        tid = self._tid(PID_SIM, track)
        ev = {"name": name, "ph": "i", "ts": t_sim * 1e6, "pid": PID_SIM,
              "tid": tid, "cat": cat, "s": "t"}
        if args:
            ev["args"] = dict(args)
        self._emit(ev)

    def rebase_wall(self, cursor_us: float) -> None:
        """Continue the wall timeline at ``cursor_us`` microseconds.

        Called on checkpoint resume (``TelemetryHook.load_state_dict``):
        shifts the epoch so the resumed process's first span lands right
        after the killed process's last recorded event, keeping every
        (pid, tid) track monotone across the splice point.
        """
        self._epoch = time.perf_counter() - cursor_us / 1e6
        if cursor_us > self.wall_cursor:
            self.wall_cursor = float(cursor_us)

    # -- lifecycle / export ------------------------------------------------

    def flush(self) -> None:
        if self._jsonl is not None:
            self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.flush()
            self._jsonl.close()
            self._jsonl = None

    def export_chrome(self, path: str,
                      events: Optional[Sequence[Dict[str, Any]]] = None) -> str:
        """Write a Perfetto-loadable Chrome trace JSON; returns ``path``.

        ``events`` overrides the in-memory list — pass the reloaded JSONL
        stream to export a seamless trace that spans checkpoint resumes.
        """
        evs = list(self.events if events is None else events)
        with open(path, "w") as f:
            json.dump({"traceEvents": evs, "displayTimeUnit": "ms"}, f)
        return path


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    """Replay a JSONL event stream back into the in-memory representation."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def validate_trace_events(events: Sequence[Dict[str, Any]]) -> None:
    """Chrome trace-event schema check; raises ``ValueError`` on violation.

    Enforces, per (pid, tid) track: balanced and properly nested ``B``/``E``
    pairs, non-decreasing timestamps, non-negative ``X`` durations, and a
    known phase type for every event. ``M`` metadata events are exempt from
    the monotonicity check (they carry no timeline position).
    """
    if not events:
        raise ValueError("empty trace: no events recorded")
    stacks: Dict[Tuple[int, int], List[str]] = {}
    last_ts: Dict[Tuple[int, int], float] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object: {ev!r}")
        for k in ("name", "ph", "pid", "tid", "ts"):
            if k not in ev:
                raise ValueError(f"event {i} lacks required key {k!r}: {ev}")
        ph = ev["ph"]
        if ph == "M":
            continue
        key = (ev["pid"], ev["tid"])
        ts = float(ev["ts"])
        if ts < last_ts.get(key, float("-inf")):
            raise ValueError(
                f"event {i}: non-monotone ts {ts} on track {key} "
                f"(previous {last_ts[key]})")
        last_ts[key] = ts
        if ph == "B":
            stacks.setdefault(key, []).append(ev["name"])
        elif ph == "E":
            stack = stacks.get(key)
            if not stack:
                raise ValueError(
                    f"event {i}: 'E' for {ev['name']!r} on track {key} "
                    "without a matching 'B'")
            top = stack.pop()
            if top != ev["name"]:
                raise ValueError(
                    f"event {i}: mis-nested span on track {key}: "
                    f"'E' {ev['name']!r} closes 'B' {top!r}")
        elif ph == "X":
            if float(ev.get("dur", -1.0)) < 0:
                raise ValueError(
                    f"event {i}: 'X' event needs dur ≥ 0: {ev}")
        elif ph != "i":
            raise ValueError(f"event {i}: unknown phase type {ph!r}")
    unbalanced = {k: v for k, v in stacks.items() if v}
    if unbalanced:
        raise ValueError(f"unbalanced B/E pairs at end of trace: {unbalanced}")
