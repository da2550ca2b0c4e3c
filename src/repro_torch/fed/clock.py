"""Event-driven virtual wall clock for asynchronous federation.

The synchronous engine's notion of time is the round counter: every round
costs "1" regardless of who was selected, so system heterogeneity
(stragglers, slow networks) is invisible. This module supplies the missing
time axis for ``fed.async_engine``:

  * ``VirtualClock``  — a min-heap of future client completions plus the
    current virtual time. Events pop in ``(time, seq)`` order, where ``seq``
    is insertion order, so two completions at the same instant resolve
    deterministically — a fixed seed yields an identical event sequence.
  * ``Completion``    — one client's local-training completion: when it
    lands, who it came from, which dispatch round it belongs to, and an
    opaque payload (the async engine stores the pending update there).
  * ``LatencyModel``  — per-client completion latencies: a base round
    duration scaled by per-client time multipliers (``SystemProfile.speeds``
    from ``fed.availability`` — log-normal, larger = slower) and optional
    log-normal per-dispatch jitter. With ``jitter=0`` no RNG is consumed,
    which is what makes the equal-latency async run replay the synchronous
    selection stream exactly (``tests/test_torch_async.py``).

The clock is host-side control plane, like the sequential parts of
Algorithm 1: device work stays fused in the batched executor, and the clock
only decides *when* each already-computed update reaches the server.
Counterpart of ``repro.fed.clock`` without its telemetry instants (the
port has no tracer yet).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Dict, List, Optional

import numpy as np


@dataclasses.dataclass(order=True)
class Completion:
    """One scheduled client completion in virtual time.

    Ordering is ``(time, seq)`` — payload and identity fields are excluded
    from comparison so the heap never compares pytrees.
    """

    time: float
    seq: int
    client: int = dataclasses.field(compare=False)
    dispatch_round: int = dataclasses.field(compare=False)
    payload: Any = dataclasses.field(compare=False, default=None)


class VirtualClock:
    """Simulated wall clock + pending-completion event queue.

    The async engine schedules one ``Completion`` per dispatched client and
    pops everything due by the round's closing time. ``now`` only moves
    forward (``advance_to`` is monotone), so round close times are a
    non-decreasing series — the ``FLResult.wall_clock`` axis.

    Besides the default (training) queue, ``channel(name)`` hands out named
    sub-queues that share this clock's time axis but keep their own heap and
    seq counter. That is how the reference's serving tier (``repro.serve``)
    interleaves inference-request arrivals with training completions on one clock
    without perturbing anything the training engines observe: the training
    heap order, its seq numbering, and ``state_dict`` are all computed from
    the default queue only, so a run with a busy serve channel checkpoints
    and replays bitwise identical to one without it.
    """

    def __init__(self, start: float = 0.0):
        self.now = float(start)
        self._heap: List[Completion] = []
        self._next_seq = 0  # plain int (not itertools.count): checkpointable
        self._channels: Dict[str, "ChannelQueue"] = {}

    def channel(self, name: str) -> "ChannelQueue":
        """Named side event queue sharing this clock's ``now``.

        Channels are ephemeral simulation streams (not part of
        ``state_dict``): the serving tier drains its channel within each
        round, and resumed runs rebuild traffic deterministically from the
        traffic seed rather than from the snapshot.
        """
        if name not in self._channels:
            self._channels[name] = ChannelQueue(self, name)
        return self._channels[name]

    def __len__(self) -> int:
        return len(self._heap)

    def schedule(self, delay: float, client: int, dispatch_round: int,
                 payload: Any = None) -> Completion:
        """Enqueue a completion ``delay`` time units from now (delay ≥ 0)."""
        if delay < 0:
            raise ValueError(f"completion delay must be ≥ 0, got {delay}")
        ev = Completion(time=self.now + float(delay), seq=self._next_seq,
                        client=int(client), dispatch_round=int(dispatch_round),
                        payload=payload)
        self._next_seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    def peek_time(self) -> Optional[float]:
        """Arrival time of the earliest pending completion, or None."""
        return self._heap[0].time if self._heap else None

    def latest_time(self) -> Optional[float]:
        """Arrival time of the latest pending completion, or None.

        The deadline-free (∞) round close: wait for everything in flight.
        """
        return max(ev.time for ev in self._heap) if self._heap else None

    def advance_to(self, t: float) -> float:
        """Move ``now`` forward to ``t`` (never backward); returns ``now``."""
        self.now = max(self.now, float(t))
        return self.now

    def pop_due(self, until: float) -> List[Completion]:
        """Advance to ``until`` and return every completion with time ≤ it.

        Events come back in ``(time, seq)`` order. The clock lands on
        ``until`` even when fewer (or zero) events were due — that is the
        deadline semantics: the round costs its full duration regardless of
        how many clients made it.
        """
        self.advance_to(until)
        due: List[Completion] = []
        while self._heap and self._heap[0].time <= self.now:
            due.append(heapq.heappop(self._heap))
        return due

    def drain(self) -> List[Completion]:
        """Pop everything still pending (end-of-run accounting)."""
        out = []
        while self._heap:
            out.append(heapq.heappop(self._heap))
        if out:
            self.advance_to(out[-1].time)
        return out

    def pending(self) -> List[Completion]:
        """The pending events in ``(time, seq)`` order, without popping."""
        return sorted(self._heap)

    def state_dict(self) -> Dict[str, Any]:
        """JSON-serializable clock state, **excluding payloads**.

        Payloads are pytrees (pending client/edge deltas) that belong in the
        checkpoint's array shards, not its JSON meta — the engine persists
        them separately keyed by each event's ``seq``, which is unique for
        the lifetime of the clock and therefore a stable join key across the
        save/restore boundary (``load_state_dict``).
        """
        return {
            "now": self.now,
            "next_seq": self._next_seq,
            "events": [{"time": ev.time, "seq": ev.seq, "client": ev.client,
                        "dispatch_round": ev.dispatch_round}
                       for ev in sorted(self._heap)],
        }

    def load_state_dict(self, state: Dict[str, Any],
                        payloads: Dict[int, Any]) -> None:
        """Rebuild the clock from ``state_dict`` + per-seq payloads.

        ``payloads`` maps event ``seq`` → the payload the engine persisted
        for that event; every pending event must have one (missing payloads
        mean a partial snapshot — refuse loudly rather than resume with a
        silently dropped in-flight update).
        """
        missing = [e["seq"] for e in state["events"]
                   if e["seq"] not in payloads]
        if missing:
            raise ValueError(
                f"clock restore: no payload for pending events {missing}")
        self.now = float(state["now"])
        self._next_seq = int(state["next_seq"])
        self._heap = [Completion(time=float(e["time"]), seq=int(e["seq"]),
                                 client=int(e["client"]),
                                 dispatch_round=int(e["dispatch_round"]),
                                 payload=payloads[e["seq"]])
                      for e in state["events"]]
        heapq.heapify(self._heap)


class ChannelQueue:
    """A named event sub-queue on a shared ``VirtualClock``.

    Same ``(time, seq)`` deterministic pop order as the clock's default
    queue, but with its *own* heap and seq counter — scheduling events here
    never changes what the training engines pop, in what order, or what
    they checkpoint. Unlike ``VirtualClock.schedule`` (which is
    delay-relative, matching dispatch semantics), events are scheduled at
    absolute times: arrival processes are generated ahead of the clock and
    drained in windows (``pop_due`` per round close).
    """

    def __init__(self, clock: VirtualClock, name: str):
        self.clock = clock
        self.name = name
        self._heap: List[Completion] = []
        self._next_seq = 0

    def __len__(self) -> int:
        return len(self._heap)

    def schedule_at(self, time: float, tag: int = 0, round_idx: int = -1,
                    payload: Any = None) -> Completion:
        """Enqueue an event at absolute virtual time ``time`` (may be in the
        past — it then pops with the next ``pop_due`` window)."""
        ev = Completion(time=float(time), seq=self._next_seq, client=int(tag),
                        dispatch_round=int(round_idx), payload=payload)
        self._next_seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    def peek_time(self) -> Optional[float]:
        return self._heap[0].time if self._heap else None

    def pop_due(self, until: float) -> List[Completion]:
        """Advance the *shared* clock to ``until`` and pop every event with
        time ≤ it, in ``(time, seq)`` order."""
        self.clock.advance_to(until)
        due: List[Completion] = []
        while self._heap and self._heap[0].time <= self.clock.now:
            due.append(heapq.heappop(self._heap))
        return due

    def pending(self) -> List[Completion]:
        return sorted(self._heap)


@dataclasses.dataclass
class LatencyModel:
    """Per-client completion latency: ``base × multiplier_k × jitter``.

    ``multipliers`` is a (K,) array of per-client round-time multipliers —
    ``SystemProfile.speeds()`` in ``fed.availability`` draws them log-normal
    (compute × network), larger = slower. ``jitter > 0`` adds per-dispatch
    log-normal noise of that sigma; it draws from the generator the engine
    passes in, so keep it 0 when bit-replaying the synchronous RNG stream.
    """

    multipliers: np.ndarray
    base: float = 1.0
    jitter: float = 0.0

    def __post_init__(self):
        self.multipliers = np.asarray(self.multipliers, np.float64)
        if self.multipliers.ndim != 1:
            raise ValueError("latency multipliers must be a (K,) vector")
        if np.any(self.multipliers <= 0) or self.base <= 0:
            raise ValueError("latencies must be strictly positive")

    @property
    def num_clients(self) -> int:
        return self.multipliers.shape[0]

    def sample(self, clients: np.ndarray,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Latencies for one dispatch cohort, in virtual-time units."""
        lat = self.base * self.multipliers[np.asarray(clients, np.int64)]
        if self.jitter > 0.0:
            if rng is None:
                raise ValueError("jitter > 0 requires an RNG")
            lat = lat * np.exp(rng.normal(0.0, self.jitter, size=lat.shape))
        return lat

    def reference_time(self) -> float:
        """Median cohort latency — the deadline/staleness unit of account."""
        return float(self.base * np.median(self.multipliers))
