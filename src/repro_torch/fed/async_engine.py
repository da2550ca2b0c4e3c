"""Event-driven asynchronous federation: deadlines, buffers, staleness.

Counterpart of ``repro.fed.async_engine``. The synchronous engine blocks
every round on the slowest selected client, so system heterogeneity never
costs wall-clock time and the staleness term has nothing real to measure.
``AsyncFederatedEngine`` re-times the round loop on a virtual wall clock
(``fed.clock``). Each round t:

  1. **Dispatch** — select ⌈m·(1+ε)⌉ clients (Oort-style over-selection)
     with a score whose freshness term (Eq 7) reads the clock-measured
     staleness (``core.selection.make_async_selector``); under
     ``heterosel_pallas`` that row feeds K1 + K2's staleness override.
     Clients still in flight from earlier rounds are skipped.
  2. **Train** — the dispatch cohort trains in one executor call; each
     client's update is held back and scheduled on the clock at
     ``now + latency_k`` (multipliers × base × log-normal jitter, which
     draws from the host stream ``np.random.default_rng(fed.seed)``).
  3. **Close** — the round closes at ``now + deadline``; updates due by
     then, stragglers of earlier rounds included, aggregate now, later ones
     carry forward. With nothing arrived the close extends to the next
     completion.
  4. **Aggregate** — ``BufferedAggregator`` (FedBuff) applies the arrivals
     as f32 deltas against the global version each client trained on,
     weighted w_i ∝ (1+τ_i)^(−a).

Equivalence contract: with equal latencies, ``deadline=inf`` and ε = 0 the
async engine replays the synchronous run — the same draws (the clock
staleness equals the round counter), the same executor calls, and FedAvg
up to float reassociation.

References: FedBuff (Nguyen et al., AISTATS 2022) and Oort (Lai et al.,
OSDI 2021).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.core.scoring import HeteRoScoreConfig
from repro_torch.core.selection import SelectorConfig, make_async_selector
from repro_torch.core.state import update_client_state
from repro_torch.device import synchronize
from repro_torch.fed import availability as fed_avail
from repro_torch.fed import server as fed_server
from repro_torch.fed.clock import Completion, LatencyModel, VirtualClock
from repro_torch.fed.engine import (Aggregator, BatchedExecutor, CohortUpdates,
                                    ExecutorCompatError, FedAvg, FederatedEngine,
                                    FederatedSpec, FLResult, RoundContext,
                                    register_aggregator)

# Staleness reported for never-aggregated clients (clipped by Eq 7's T_max).
NEVER_STALE = 1.0e6


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Knobs of the asynchronous round manager.

    deadline:          virtual-time budget per round; arrivals after
                       ``dispatch + deadline`` carry forward as stale
                       updates. ``inf`` waits for the whole dispatch cohort.
    over_select_frac:  ε — dispatch ⌈m·(1+ε)⌉ clients.
    staleness_power:   a in the FedBuff discount w(τ) = (1+τ)^(−a).
    server_lr:         η_s scaling the aggregated delta step.
    min_updates:       extend past the deadline until at least this many
                       updates arrived.
    max_staleness:     drop updates staler than this many model versions
                       (None keeps everything).
    base_latency:      virtual-time cost of one unit-speed client round.
    jitter:            per-dispatch log-normal latency noise (sigma); > 0
                       consumes the engine's host RNG stream.
    """

    deadline: float = math.inf
    over_select_frac: float = 0.0
    staleness_power: float = 0.5
    server_lr: float = 1.0
    min_updates: int = 1
    max_staleness: Optional[int] = None
    base_latency: float = 1.0
    jitter: float = 0.0

    def __post_init__(self):
        if self.deadline <= 0:
            raise ValueError("deadline must be > 0 (use math.inf for no deadline)")
        if self.over_select_frac < 0:
            raise ValueError("over_select_frac must be ≥ 0")
        if self.base_latency <= 0:
            raise ValueError("base_latency must be > 0")


def staleness_weights(staleness: np.ndarray, power: float) -> np.ndarray:
    """FedBuff's polynomial discount w_i = (1+τ_i)^(−power), unnormalized."""
    tau = np.maximum(np.asarray(staleness, np.float64), 0.0)
    return (1.0 + tau) ** (-float(power))


def drain_due_arrivals(clock: VirtualClock, acfg: AsyncConfig, t: int,
                       dispatch_time: float, in_flight: np.ndarray) -> tuple:
    """Close one round on the clock and collect its aggregatable arrivals.

    Shared by the flat engine (arrivals are client updates) and the
    hierarchical one (edge aggregates; ``in_flight`` is indexed by whatever
    ``Completion.client`` holds). The round closes at ``dispatch_time +
    deadline`` (with an infinite deadline, when everything in flight has
    landed); every popped arrival frees its in-flight slot; arrivals older
    than ``max_staleness`` versions are dropped and counted; the close
    extends completion by completion until ``min_updates`` aggregatable
    arrivals landed or nothing is pending.

    Returns ``(kept, dropped)``: the arrivals to aggregate in (time, seq)
    order, and how many the staleness filter discarded.
    """
    if math.isinf(acfg.deadline):
        close = clock.latest_time()
        close = dispatch_time if close is None else close
    else:
        close = dispatch_time + acfg.deadline
    kept: List[Completion] = []
    dropped = 0

    def ingest(events: List[Completion]) -> None:
        nonlocal dropped
        for ev in events:
            in_flight[ev.client] = False
            if (acfg.max_staleness is not None
                    and t - ev.dispatch_round > acfg.max_staleness):
                dropped += 1
            else:
                kept.append(ev)

    ingest(clock.pop_due(close))
    while len(kept) < acfg.min_updates and len(clock):
        ingest(clock.pop_due(clock.peek_time()))
    return kept, dropped


def upgrade_async_aggregator(agg: Aggregator, acfg: AsyncConfig) -> Aggregator:
    """The async-mode aggregator contract, shared with ``fed.hierarchy``:
    the default ``FedAvg`` becomes a ``BufferedAggregator``; anything else
    must declare ``supports_deltas``, because async arrivals are deltas
    against different global versions."""
    if type(agg) is FedAvg:
        return BufferedAggregator(staleness_power=acfg.staleness_power,
                                  server_lr=acfg.server_lr)
    if not getattr(agg, "supports_deltas", False):
        raise ValueError(
            f"aggregator {getattr(agg, 'name', agg)!r} cannot aggregate "
            "async delta cohorts (updates arrive as deltas against "
            "different global versions); use 'fedbuff' or an Aggregator "
            "with supports_deltas=True")
    return agg


@dataclasses.dataclass
class PendingUpdate:
    """What a completion event carries back to the server."""

    delta: Any          # f32 params dict: w_client − w_global(dispatch round)
    loss: float
    sqnorm: float
    weight: float = 1.0  # data-size weight captured at dispatch


class BufferedAggregator(Aggregator):
    """FedBuff-style buffered aggregation with polynomial staleness discount.

    Delta-form cohorts (``delta_list`` + ``staleness``) apply as one step,
    each arrival weighted (1+τ_i)^(−a), times its data-size weight when the
    cohort carries one (``fed.server.apply_weighted_deltas``). Under the
    sync engine every update has τ = 0, so this is FedAvg scaled by
    ``server_lr``: ``aggregator="fedbuff"`` works in either mode.
    """

    name = "fedbuff"
    supports_deltas = True

    def __init__(self, staleness_power: float = 0.5, server_lr: float = 1.0):
        self.staleness_power = float(staleness_power)
        self.server_lr = float(server_lr)

    def reduce(self, global_params, cohort: CohortUpdates):
        if cohort.delta_list is not None:
            n = len(cohort.delta_list)
            tau = (np.zeros(n) if cohort.staleness is None
                   else np.asarray(cohort.staleness, np.float64))
            w = staleness_weights(tau, self.staleness_power)
            if cohort.weights is not None:
                w = w * np.asarray(cohort.weights, np.float64)
            return fed_server.apply_weighted_deltas(
                global_params, cohort.delta_list,
                torch.from_numpy(w.astype(np.float32)), server_lr=self.server_lr)
        # A sync-engine cohort: same-anchor params, one zero-staleness delta.
        delta = fed_server.params_delta_f32(self._mean(cohort), global_params)
        return fed_server.apply_weighted_deltas(
            global_params, [delta], torch.ones(1, dtype=torch.float32),
            server_lr=self.server_lr)


@register_aggregator("fedbuff")
def _make_fedbuff(spec: FederatedSpec) -> BufferedAggregator:
    acfg = spec.async_cfg or AsyncConfig()
    return BufferedAggregator(staleness_power=acfg.staleness_power,
                              server_lr=acfg.server_lr)


def resolve_multipliers(system: Any, num_clients: int) -> np.ndarray:
    """(K,) per-client round-time multipliers from whatever the spec gave:
    None (all 1), a ``SystemProfile`` (its ``speeds()``) or a (K,) array."""
    if system is None:
        return np.ones(num_clients)
    speeds = getattr(system, "speeds", None)
    mult = np.asarray(speeds() if callable(speeds) else system, np.float64)
    if mult.shape != (num_clients,):
        raise ValueError(
            f"system profile must yield ({num_clients},) multipliers, "
            f"got shape {mult.shape}")
    return mult


class AsyncFederatedEngine(FederatedEngine):
    """Deadline-managed asynchronous rounds over the plugin surface.

    Built by ``FederatedSpec.build()`` for ``round_policy='async'`` on the
    flat topology. Only *when* updates reach the server differs from the
    sync engine; scoring, executors, hooks and metrics are shared, and
    ``CheckpointHook`` carries the clock, the in-flight updates and the
    staleness bookkeeping through ``extra_state``, so a killed async run
    resumes bitwise.
    """

    def __init__(self, spec: FederatedSpec):
        super().__init__(spec)
        fed = spec.fed
        self.acfg: AsyncConfig = spec.async_cfg or AsyncConfig()
        k = spec.data.num_clients
        self.latency = LatencyModel(resolve_multipliers(spec.system, k),
                                    base=self.acfg.base_latency, jitter=self.acfg.jitter)
        self.m_over = min(
            k, int(math.ceil(fed.num_selected * (1.0 + self.acfg.over_select_frac))))

        score_cfg = spec.score_cfg or HeteRoScoreConfig()
        sel_cfg = spec.sel_cfg or SelectorConfig(num_selected=fed.num_selected)
        sel_cfg = dataclasses.replace(sel_cfg, num_selected=self.m_over)
        # Oort's system-utility term: preferred / actual round duration.
        speeds = torch.from_numpy((self.latency.reference_time()
                                   / (self.latency.base * self.latency.multipliers)
                                   ).astype(np.float32))
        select = make_async_selector(self.selector_name, sel_cfg, score_cfg, speeds=speeds)
        if spec.availability is not None:
            select = fed_avail.mask_async_selector(select, spec.availability,
                                                   num_selected=self.m_over)
        self._select_async = select
        self._require_per_client_updates()
        self.aggregator = upgrade_async_aggregator(self.aggregator, self.acfg)

    def _require_per_client_updates(self) -> None:
        """Async needs each client's update separately (deltas, held back)."""
        inner = getattr(self.executor, "inner", self.executor)  # CompressedExecutor
        if getattr(inner, "kind", None) == "batched":
            if self.spec.fed.client_chunk:
                raise ExecutorCompatError(
                    "async rounds need every client's update separately, but "
                    "chunked batched execution (FedConfig.client_chunk > 0) "
                    "never materializes the (M, ...) client stack; set "
                    "client_chunk=0 or use the sequential executor")
            if isinstance(inner, BatchedExecutor):
                inner.keep_client_params = True

    # -- lifecycle ---------------------------------------------------------

    def _start(self) -> None:
        super()._start()
        k = self.spec.data.num_clients
        self.clock = VirtualClock()
        self._in_flight = np.zeros(k, bool)
        # Virtual dispatch time of the round in which each client's update
        # was last aggregated: staleness = (now − this) / reference round.
        self._last_contact = np.full(k, -np.inf)
        self._dur_sum = 0.0
        self._dur_n = 0
        self.wall_clock: List[float] = []
        self.round_staleness: List[float] = []
        self.stragglers_carried = 0
        self.updates_dropped = 0

    def _ref_time(self) -> float:
        """Reference round duration: the realized mean, else the latency median."""
        if self._dur_n:
            return self._dur_sum / self._dur_n
        return self.latency.reference_time()

    def staleness_override(self) -> torch.Tensor:
        """The (K,) f32 clock-measured staleness the round's selector reads."""
        gap = self.clock.now - self._last_contact
        out = np.where(np.isfinite(gap), gap / self._ref_time(), NEVER_STALE)
        return torch.from_numpy(out.astype(np.float32)).to(self.device)

    # -- the async round ---------------------------------------------------

    def _run_round(self, ctx: RoundContext, t: int, eval_batch: Any) -> None:
        spec, acfg, dev = self.spec, self.acfg, self.device
        k = spec.data.num_clients
        dispatch_time = self.clock.now

        # 1. Dispatch: over-select on clock-measured staleness, skip busy.
        t0 = time.perf_counter()
        mask, _ = self._select_async(self.round_noise(t), self.state, t,
                                     self.staleness_override())
        mask_np = mask.cpu().numpy() & ~self._in_flight
        selected = np.flatnonzero(mask_np)
        t1 = time.perf_counter()

        # 2. Train the dispatch cohort in one executor call; hold the
        #    updates back and schedule their completions on the clock.
        if len(selected):
            weights = self.aggregator.cohort_weights(selected, spec.data)
            w_np = (np.ones(len(selected)) if weights is None
                    else np.asarray(torch.as_tensor(weights).cpu(), np.float64))
            cohort = self.executor.run_round(self.params, selected, self.rng,
                                             weights=None)
            self.wire_total += cohort.wire_bytes
            self.raw_total += cohort.raw_bytes
            lat = self.latency.sample(selected, self.rng)
            losses = np.asarray(torch.as_tensor(cohort.mean_loss).cpu(), np.float32)
            sqnorms = np.asarray(torch.as_tensor(cohort.update_sqnorm).cpu(), np.float32)
            for i, c in enumerate(selected):
                payload = PendingUpdate(
                    delta=self._client_delta(cohort, i), loss=float(losses[i]),
                    sqnorm=float(sqnorms[i]), weight=float(w_np[i]))
                self.clock.schedule(lat[i], c, t, payload)
            self._in_flight[selected] = True
        synchronize(dev)
        t2 = time.perf_counter()

        # 3. Close the round at the deadline; carry late updates forward.
        kept, dropped = drain_due_arrivals(self.clock, acfg, t, dispatch_time,
                                           self._in_flight)
        self.updates_dropped += dropped

        # 4. Buffered aggregation and the metadata fold for the arrivals.
        stale = np.asarray([t - ev.dispatch_round for ev in kept], np.float32)
        obs_loss = np.zeros(k, np.float32)
        obs_sqnorm = np.zeros(k, np.float32)
        if kept:
            agg_cohort = CohortUpdates(
                mean_loss=np.asarray([ev.payload.loss for ev in kept], np.float32),
                update_sqnorm=np.asarray([ev.payload.sqnorm for ev in kept], np.float32),
                delta_list=[ev.payload.delta for ev in kept],
                staleness=stale,
                weights=np.asarray([ev.payload.weight for ev in kept], np.float32),
            )
            self.params = self.aggregator.reduce(self.params, agg_cohort)
            arr_ids = np.asarray([ev.client for ev in kept], np.int64)
            arr_mask = np.zeros(k, bool)
            arr_mask[arr_ids] = True
            obs_loss[arr_ids] = agg_cohort.mean_loss
            obs_sqnorm[arr_ids] = agg_cohort.update_sqnorm
            self.state = update_client_state(
                self.state, round_idx=t,
                selected_mask=torch.from_numpy(arr_mask).to(dev),
                observed_loss=torch.from_numpy(obs_loss).to(dev),
                observed_sqnorm=torch.from_numpy(obs_sqnorm).to(dev))
            self._last_contact[arr_ids] = dispatch_time
        synchronize(dev)
        t3 = time.perf_counter()
        ctx.select_ms = (t1 - t0) * 1e3
        ctx.execute_ms = (t2 - t1) * 1e3
        ctx.aggregate_ms = (t3 - t2) * 1e3

        # 5. Clock bookkeeping and the usual round tail.
        self._dur_sum += self.clock.now - dispatch_time
        self._dur_n += 1
        n_stragglers = sum(1 for ev in kept if ev.dispatch_round < t)
        self.stragglers_carried += n_stragglers
        self.wall_clock.append(self.clock.now)
        self.round_staleness.append(float(stale.mean()) if len(stale) else 0.0)

        ctx.mask = mask_np
        ctx.selected = selected
        ctx.obs_loss = obs_loss
        ctx.obs_sqnorm = obs_sqnorm
        ctx.sim_time = self.clock.now
        ctx.num_arrivals = len(kept)
        ctx.num_stragglers = n_stragglers
        self._eval(ctx, eval_batch)
        self._trace_round(t, ("select", t0, t1, {}),
                          ("execute", t1, t2, {"dispatched": int(len(selected))}),
                          ("aggregate", t2, t3, {"arrivals": int(len(kept)),
                                                 "stragglers": n_stragglers}))
        ctx.train_loss = (float(np.mean([ev.payload.loss for ev in kept]))
                          if kept else 0.0)
        self._rounds_done = t + 1

    def _client_delta(self, cohort: CohortUpdates, i: int) -> Any:
        """f32 delta of cohort member i against the current global anchor."""
        if cohort.param_list is not None:
            w_i = cohort.param_list[i]
        elif cohort.stacked_params is not None:
            w_i = {n: x[i] for n, x in cohort.stacked_params.items()}
        else:
            raise ExecutorCompatError(
                "async rounds need per-client updates, but the executor "
                "returned only the fused cohort mean")
        return fed_server.params_delta_f32(w_i, self.params)

    def _result(self, extras) -> FLResult:
        extras.setdefault("wall_clock", np.asarray(self.wall_clock))
        extras.setdefault("round_staleness", np.asarray(self.round_staleness))
        return super()._result(extras)

    # -- checkpoint / resume ----------------------------------------------
    #
    # The async regime adds its time axis through extra_state: the clock with
    # every pending completion (each PendingUpdate's delta as its own
    # schema-checked tree keyed by the event's seq), the in-flight and
    # last-contact vectors the staleness override reads, the realized
    # duration stats behind _ref_time, and the wall_clock / round_staleness
    # series.

    @property
    def snapshot_kind(self) -> str:
        return "async/flat"

    def extra_state(self):
        trees = {}
        pending_meta = {}
        for ev in self.clock.pending():
            trees[f"pending/{ev.seq}"] = ev.payload.delta
            pending_meta[str(ev.seq)] = {"loss": ev.payload.loss,
                                         "sqnorm": ev.payload.sqnorm,
                                         "weight": ev.payload.weight}
        arrays = {
            "in_flight": self._in_flight,
            # Holds -inf for never-aggregated clients: an array, not JSON.
            "last_contact": np.asarray(self._last_contact, np.float64),
            "wall_clock": np.asarray(self.wall_clock, np.float64),
            "round_staleness": np.asarray(self.round_staleness, np.float64),
        }
        meta = {
            "clock": self.clock.state_dict(),
            "pending": pending_meta,
            "dur_sum": self._dur_sum,
            "dur_n": self._dur_n,
            "stragglers_carried": self.stragglers_carried,
            "updates_dropped": self.updates_dropped,
        }
        return trees, arrays, meta

    def extra_likes(self, meta):
        # Pending deltas share the params structure but are always f32.
        delta_like = {n: torch.zeros(x.shape, dtype=torch.float32, device=x.device)
                      for n, x in self.params.items()}
        return {f"pending/{ev['seq']}": delta_like for ev in meta["extra"]["clock"]["events"]}

    def load_extra_state(self, trees, arrays, meta):
        extra = meta["extra"]
        payloads = {
            int(seq): PendingUpdate(delta=trees[f"pending/{seq}"], loss=info["loss"],
                                    sqnorm=info["sqnorm"], weight=info["weight"])
            for seq, info in extra["pending"].items()
        }
        self.clock = VirtualClock()
        self.clock.load_state_dict(extra["clock"], payloads)
        self._in_flight = np.asarray(arrays["in_flight"], bool).copy()
        self._last_contact = np.asarray(arrays["last_contact"], np.float64).copy()
        self._dur_sum = float(extra["dur_sum"])
        self._dur_n = int(extra["dur_n"])
        self.stragglers_carried = int(extra["stragglers_carried"])
        self.updates_dropped = int(extra["updates_dropped"])
        self.wall_clock = [float(x) for x in arrays["wall_clock"]]
        self.round_staleness = [float(x) for x in arrays["round_staleness"]]
