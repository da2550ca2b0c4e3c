"""Hierarchical two-tier federation: client → edge → cloud.

Counterpart of ``repro.fed.hierarchy``.
Clients hang off edge aggregators and only edge aggregates cross the WAN:

  1. **Partition** — the K clients split into E edges once per run
     (``fed.partition.partition_edges``, 'similarity' or 'random').
  2. **Outer selection** — when ``HierarchyConfig.edges_per_round`` asks for
     fewer edges than are idle, the cloud scores each edge's pooled
     pseudo-client state (``core.state.pool_client_state`` →
     ``core.selection.edge_selection_probs``) and takes a Gumbel-top-E_sel
     on the host in float64; ``selector='random'`` samples edges uniformly.
  3. **Inner selection** — each active edge runs the selector over its own
     members' rows, with budget m_e (``edge_budgets``). Under
     ``heterosel_pallas`` every edge is scored in one launch of K4
     (``kernels.score_select.segmented_score_probs``) over an edge-major
     ``(E·seg,)`` relayout of the state, ``seg`` being the largest edge
     rounded up to a warp; each edge then samples its cohort from its slice.
  4. **Two-stage aggregation** — each edge cohort trains in one executor
     call and reduces to the edge aggregate; with one cohort that aggregate
     is the new global model bitwise, otherwise the cloud combines f32
     deltas weighted by cohort size (``fed.server.apply_weighted_deltas``).
     ``FLResult.cloud_uploads`` counts the aggregates per round.

Randomness comes from outside, as in the flat engine. Each round draws
through ``FederatedSpec.edge_noise(round_idx, stream, n)``: stream e in
[0, E) is edge e's (|edge e|,) draws (the Gumbel row, or named rows as the
flat engine's ``noise`` gives them), and stream E the (E,) outer Gumbel
draw, asked for only when the outer stage samples. The default draws from a
``torch.Generator`` seeded from ``fed.seed``; with E = 1 it hands out
``noise(t, K)``, so an E = 1 run (full budget, one edge) equals the flat
run bitwise. Host data flows from the one ``np.random.default_rng(seed)``
stream, edges in ascending id order and each cohort in ascending member
order, as in the reference.

Both round policies compose (``FedConfig.round_policy``):

  * **sync** — edge rounds are barriers: every active edge's aggregate
    reaches the cloud in its dispatch round.
  * **async** — each edge is one event on the ``fed.clock.VirtualClock``:
    it completes at the max of its cohort's latencies, the cloud closes the
    round at ``AsyncConfig.deadline``, and straggler edges carry forward as
    stale arrivals discounted by the FedBuff weight (``BufferedAggregator``).
    In-flight edges are not re-dispatched, and ``over_select_frac``
    over-selects at the edge tier.

``availability`` masks thread through the inner stage: each edge's
selector is wrapped with ``fed.availability.mask_selector`` over the
edge's mask columns (the segmented path applies the same ``remask`` to
K4's probabilities), so offline members are never selected; edges stay
schedulable. With ``selector='adaptive'`` the per-edge budgets are retuned
online by ``core.adaptive.AdaptiveBudgets`` from each round's mean
edge-cohort loss. ``CheckpointHook`` composes with both policies: the
upload series, the budget controller and, under 'async', the clock with its
in-flight edge cohorts travel through ``extra_state``.

Tracer spans are not ported (``obs/`` is not).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import ckpt as torch_ckpt
from repro_torch.core.adaptive import AdaptiveBudgets
from repro_torch.core.scoring import HeteRoScoreConfig
from repro_torch.core.selection import (SelectorConfig, draw, dynamic_temperature,
                                        edge_selection_probs, gumbel_noise,
                                        make_selector, sample_clients)
from repro_torch.core.state import (pool_client_state, score_inputs,
                                    update_client_state)
from repro_torch.device import synchronize
from repro_torch.fed import availability as fed_avail
from repro_torch.fed import server as fed_server
from repro_torch.fed.async_engine import (AsyncConfig, drain_due_arrivals,
                                          resolve_multipliers, upgrade_async_aggregator)
from repro_torch.fed.clock import LatencyModel, VirtualClock
from repro_torch.fed.engine import (CohortUpdates, FedAvg, FederatedEngine,
                                    FederatedSpec, FLResult, RoundContext,
                                    WeightedFedAvg)
from repro_torch.fed.partition import EdgePartition, partition_edges

WARP = 32  # the segmented layout's slice width is a whole number of warps


@dataclasses.dataclass(frozen=True)
class HierarchyConfig:
    """Knobs of the hierarchical round manager (spec field ``hier_cfg``).

    partition_mode:   'similarity' (sorted by label-skew JS divergence,
                      contiguous blocks) or 'random' (seeded permutation).
    edges_per_round:  outer cross-edge budget E_sel; 0 ⇒ every edge.

    The 'random' partition is seeded from ``fed.seed``.
    """

    partition_mode: str = "similarity"
    edges_per_round: int = 0

    def __post_init__(self):
        if self.edges_per_round < 0:
            raise ValueError("edges_per_round must be ≥ 0 (0 = all edges)")


def edge_budgets(num_selected: int, sizes: np.ndarray,
                 edge_budget: int = 0) -> np.ndarray:
    """(E,) inner selection budgets m_e.

    With an explicit ``edge_budget`` every edge gets ``min(edge_budget,
    |edge|)``. Otherwise ``num_selected`` is spread over the edges in
    proportion to their sizes by largest remainder, capped at each edge's
    size, so Σ m_e = min(m, K) and E = 1 gets exactly m.
    """
    sizes = np.asarray(sizes, np.int64)
    if edge_budget > 0:
        return np.minimum(edge_budget, sizes)
    total = int(min(num_selected, sizes.sum()))
    quota = total * sizes / max(int(sizes.sum()), 1)
    base = np.minimum(np.floor(quota).astype(np.int64), sizes)
    frac = quota - np.floor(quota)
    order = np.argsort(-frac, kind="stable")
    rem = total - int(base.sum())
    while rem > 0:
        progressed = False
        for e in order:
            if rem == 0:
                break
            if base[e] < sizes[e]:
                base[e] += 1
                rem -= 1
                progressed = True
        if not progressed:  # every edge at capacity (total == K)
            break
    return base


@dataclasses.dataclass
class EdgeCohort:
    """One edge's inner-round outcome on its way to the cloud."""

    edge: int
    selected: np.ndarray       # global client ids of the edge cohort
    losses: np.ndarray         # (m_e,) per-client mean local loss
    sqnorms: np.ndarray        # (m_e,) per-client ||Δw||²
    weight: float              # cloud combine weight (cohort size or Σ weights)
    avg_params: Any = None     # the edge aggregate (sync)
    delta: Any = None          # f32 edge aggregate − dispatch anchor (async)


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float32)
    return np.asarray(x, np.float32)


class HierarchicalEngine(FederatedEngine):
    """Two-tier rounds under either round policy; built by
    ``FederatedSpec.build()`` for ``topology='hierarchical'``. The flat
    ``AsyncFederatedEngine`` is not stacked underneath: here the unit of
    cloud arrival is an edge aggregate, not a client update."""

    def __init__(self, spec: FederatedSpec):
        fed = spec.fed
        self.hcfg: HierarchyConfig = spec.hier_cfg or HierarchyConfig()
        self.policy = spec.resolved_round_policy
        selector = spec.resolved_selector
        if fed.edge_count < 1:
            raise ValueError(
                "topology='hierarchical' requires FedConfig.edge_count ≥ 1 "
                f"(got {fed.edge_count}); set edge_count=E or topology='flat'")
        outer_active = 0 < self.hcfg.edges_per_round < fed.edge_count
        if outer_active and selector in ("oort", "power_of_choice"):
            raise ValueError(
                f"selector={spec.resolved_selector!r} has no edge-level analogue "
                "for the outer cross-edge stage; with edges_per_round < "
                "edge_count use a 'heterosel*' selector or 'random' (or set "
                "edges_per_round=0 to dispatch every edge)")
        super().__init__(spec)  # resolves the selector, executor, aggregator
        self._avail = (None if spec.availability is None
                       else np.asarray(spec.availability, bool))

        self.partition: EdgePartition = partition_edges(
            np.asarray(spec.data.label_js), fed.edge_count,
            mode=self.hcfg.partition_mode, seed=fed.seed)
        self.edge_count = self.partition.edge_count
        self._members = self.partition.member_lists()
        self.budgets = edge_budgets(fed.num_selected, self.partition.sizes,
                                    fed.edge_budget)

        self._score_cfg = spec.score_cfg or HeteRoScoreConfig()
        self._base_sel = spec.sel_cfg or SelectorConfig(num_selected=fed.num_selected)
        # Outer-stage semantics follow the selector family: HeteRo variants
        # (and 'adaptive', on its HeteRo base scoring) score pooled edges,
        # multiplicative for heterosel_mult; 'random' samples edges uniformly.
        self._outer_uniform = selector == "random"
        self._outer_sel_cfg = (dataclasses.replace(self._base_sel, additive=False)
                               if selector == "heterosel_mult" else self._base_sel)
        # 'adaptive' retunes the edge budgets online from the mean
        # edge-cohort losses (AdaptiveBudgets) instead of the static split.
        self._budget_ctl: Optional[AdaptiveBudgets] = None
        if selector == "adaptive":
            if fed.edge_budget > 0:
                raise ValueError(
                    "selector='adaptive' retunes per-edge budgets online "
                    "from the global num_selected; an explicit "
                    "FedConfig.edge_budget conflicts with that — unset it "
                    "or use a non-adaptive selector")
            self._budget_ctl = AdaptiveBudgets(fed.num_selected, self.partition.sizes)

        # Inner stage: heterosel_pallas scores every edge in one K4 launch
        # over an edge-major relayout (edge e owns slots [e·seg, e·seg + n_e),
        # padding slots gather client 0 and are masked in the kernel); the
        # other selectors run once per edge on the edge's rows.
        self._segmented = self.selector_name == "heterosel_pallas"
        self._seg = -(-max(int(self.partition.sizes.max()), 1) // WARP) * WARP
        self._edge_select: Dict[int, Any] = {}
        if not self._segmented:
            self._build_edge_selectors()

        if self.policy == "async":
            self.acfg: AsyncConfig = spec.async_cfg or AsyncConfig()
            self.latency = LatencyModel(
                resolve_multipliers(spec.system, spec.data.num_clients),
                base=self.acfg.base_latency, jitter=self.acfg.jitter)
            self.aggregator = upgrade_async_aggregator(self.aggregator, self.acfg)
        else:
            if spec.async_cfg is not None or spec.system is not None:
                raise ValueError(
                    "async_cfg/system are only consumed by round_policy='async'; "
                    "the sync engine has no wall clock to apply them to")
            if not isinstance(self.aggregator, (FedAvg, WeightedFedAvg)):
                raise ValueError(
                    f"aggregator {getattr(self.aggregator, 'name', self.aggregator)!r} "
                    "does not compose with the hierarchical cloud stage "
                    "(edge aggregates combine as weighted deltas, not a "
                    "cohort reduce); use 'fedavg' or 'fedavg_weighted'")

    def _build_edge_selectors(self) -> None:
        """Bind a selector to each edge with a non-zero budget, masked to the
        edge's availability columns when the run has a trace. Called at
        construction, after every budget move and on restore."""
        self._edge_select = {}
        for e in range(self.edge_count):
            b = int(self.budgets[e])
            if b == 0:
                continue
            select = make_selector(self.selector_name,
                                   dataclasses.replace(self._base_sel, num_selected=b),
                                   self._score_cfg)
            if self._avail is not None:
                select = fed_avail.mask_selector(
                    select, self._avail[:, self._members[e]], num_selected=b)
            self._edge_select[e] = select

    # -- lifecycle ---------------------------------------------------------

    def _start(self) -> None:
        super()._start()
        spec, dev = self.spec, self.device
        self.cloud_uploads: List[int] = []
        self.segment_out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._assignment = torch.from_numpy(
            self.partition.assignment.astype(np.int64)).to(dev)
        self._member_idx = [torch.from_numpy(m).to(dev) for m in self._members]
        perm = np.zeros(self.edge_count * self._seg, np.int64)
        for e, members in enumerate(self._members):
            perm[e * self._seg:e * self._seg + len(members)] = members
        self._seg_perm = torch.from_numpy(perm).to(dev)
        self._seg_sizes = torch.from_numpy(
            self.partition.sizes.astype(np.int32)).to(dev)
        if spec.edge_noise is not None:
            self.edge_noise = spec.edge_noise
        elif self.edge_count == 1:
            self.edge_noise = lambda t, stream, n: self.noise(t, n)
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(spec.fed.seed)
            self.generators["edge_noise"] = gen
            names = self.draw_names()
            self.edge_noise = lambda t, stream, n: (
                gumbel_noise(gen, n) if stream == self.edge_count else draw(gen, names, n))
        if self.policy == "async":
            self.clock = VirtualClock()
            self._edge_in_flight = np.zeros(self.edge_count, bool)
            self.wall_clock: List[float] = []
            self.round_staleness: List[float] = []
            self.stragglers_carried = 0
            self.updates_dropped = 0

    def edge_draw(self, t: int, stream: int, n: int):
        """Round t's (n,) f32 draws of ``stream`` on the run's device: the
        Gumbel row, or the named rows of a selector that takes more."""
        g = self._on_device(self.edge_noise(t, stream, n))
        for row in (g.values() if isinstance(g, dict) else (g,)):
            if tuple(row.shape) != (n,):
                raise ValueError(f"edge_noise(round {t}, stream {stream}) gave shape "
                                 f"{tuple(row.shape)}, want ({n},)")
        return g

    # -- the two selection stages ------------------------------------------

    def _idle_edges(self) -> List[int]:
        busy = (self._edge_in_flight if self.policy == "async"
                else np.zeros(self.edge_count, bool))
        return [e for e in range(self.edge_count)
                if self.budgets[e] > 0 and not busy[e]]

    def _choose_edges(self, t: int, idle: List[int]) -> List[int]:
        """Outer cross-edge selection over the idle edges.

        No draw is taken when the outer budget covers every idle edge (which
        keeps E = 1 on the flat run's stream). Otherwise the Gumbel-top-E_sel
        runs in float64 on the host, as the reference's does, so a near-tie
        picks the same edge. Under 'async' ⌈E_sel·(1+ε)⌉ edges dispatch, the
        edge-tier mirror of flat async's client over-selection.
        """
        e_sel = self.hcfg.edges_per_round or self.edge_count
        if self.policy == "async":
            e_sel = int(math.ceil(e_sel * (1.0 + self.acfg.over_select_frac)))
        if e_sel >= len(idle):
            return list(idle)
        if self._outer_uniform:
            probs = np.full(self.edge_count, 1.0 / self.edge_count)
        else:
            pooled = pool_client_state(self.state, self._assignment, self.edge_count)
            probs = edge_selection_probs(pooled, t, self._outer_sel_cfg,
                                         self._score_cfg).cpu().numpy().astype(np.float64)
        g = self.edge_draw(t, self.edge_count, self.edge_count).cpu().numpy()
        pert = np.log(probs + 1e-30) + g.astype(np.float64)
        eligible = np.zeros(self.edge_count, bool)
        eligible[idle] = True
        pert[~eligible] = -np.inf
        top = np.argsort(-pert, kind="stable")[:e_sel]
        return sorted(int(e) for e in top)

    def select_round(self, t: int, scorer: Optional[Callable] = None) -> List[tuple]:
        """Round t's two selection stages on the current state: an (edge,
        global cohort ids) pair per active edge with a non-empty cohort.

        Under ``heterosel_pallas`` the inner stage scores every edge at once
        through ``scorer``, a function of
        ``kernels.score_select.segmented_score_probs``' signature: that one
        (K4) by default, or its plain version, which gives the cohort a K4
        run is held against. Its ``(probs, scores)``, each (E·seg,) in the
        edge-major layout, stay in ``segment_out``. With an availability
        trace each edge's probabilities are masked and re-sampled
        (``fed.availability.remask``). The round's draws are taken through
        ``edge_noise`` on every call.
        """
        active = self._choose_edges(t, self._idle_edges())
        masks = []
        if self._segmented:
            from repro_torch.kernels import score_select

            sstate = self.state.map(lambda x: x[self._seg_perm])
            self.segment_out = (scorer or score_select.segmented_score_probs)(
                *score_inputs(sstate), sizes=self._seg_sizes, round_idx=t,
                tau=dynamic_temperature(t, self._base_sel), cfg=self._score_cfg,
                seg=self._seg)
            probs_all = self.segment_out[0]
            for e in active:
                members = self._members[e]
                n, budget = len(members), int(self.budgets[e])
                probs_e = probs_all[e * self._seg:e * self._seg + n]
                draws = self.edge_draw(t, e, n)
                if self._avail is not None:
                    _, g = fed_avail.split_remask(draws)
                    mask, _ = fed_avail.remask(g, probs_e, self._avail[t][members], budget)
                else:
                    mask = sample_clients(draws, probs_e, budget)
                masks.append(mask)
        else:
            for e in active:
                idx = self._member_idx[e]
                estate = self.state.map(lambda x: x[idx])
                mask, _ = self._edge_select[e](self.edge_draw(t, e, len(idx)), estate, t)
                masks.append(mask)
        picks: List[tuple] = []
        for e, mask in zip(active, masks):
            sel_local = np.flatnonzero(mask.cpu().numpy())
            if len(sel_local):
                picks.append((e, self._members[e][sel_local]))
        return picks

    def _inner_execute(self, picks: List[tuple]) -> List[EdgeCohort]:
        """One executor call per selected edge cohort, edges in ascending id
        order (the host data stream's order)."""
        out: List[EdgeCohort] = []
        for e, sel_global in picks:
            weights = self.aggregator.cohort_weights(sel_global, self.spec.data)
            cohort = self.executor.run_round(self.params, sel_global, self.rng,
                                             weights=weights)
            ew = (float(len(sel_global)) if weights is None
                  else float(np.sum(np.asarray(weights.cpu(), np.float64))))
            out.append(EdgeCohort(
                edge=e, selected=sel_global,
                losses=_host_f32(cohort.mean_loss),
                sqnorms=_host_f32(cohort.update_sqnorm),
                weight=ew, avg_params=self.aggregator._mean(cohort)))
        return out

    def _fold_observations(self, ctx: RoundContext, t: int, cohorts: List[EdgeCohort],
                           dispatched_mask: Optional[np.ndarray] = None) -> None:
        """Fold the cohorts' observations into the state (the arrivals under
        'async', where ``ctx.mask`` is the round's dispatch instead)."""
        k = self.spec.data.num_clients
        mask = np.zeros(k, bool)
        obs_loss = np.zeros(k, np.float32)
        obs_sqnorm = np.zeros(k, np.float32)
        for c in cohorts:
            mask[c.selected] = True
            obs_loss[c.selected] = c.losses
            obs_sqnorm[c.selected] = c.sqnorms
        if mask.any():
            dev = self.device
            self.state = update_client_state(
                self.state, round_idx=t,
                selected_mask=torch.from_numpy(mask).to(dev),
                observed_loss=torch.from_numpy(obs_loss).to(dev),
                observed_sqnorm=torch.from_numpy(obs_sqnorm).to(dev))
        ctx.mask = mask if dispatched_mask is None else dispatched_mask
        ctx.selected = np.flatnonzero(ctx.mask)
        ctx.obs_loss = obs_loss
        ctx.obs_sqnorm = obs_sqnorm
        ctx.train_loss = (float(np.concatenate([c.losses for c in cohorts]).mean())
                          if cohorts else 0.0)
        if self._budget_ctl is not None and cohorts:
            self._retune_budgets(cohorts)

    def _retune_budgets(self, cohorts: List[EdgeCohort]) -> None:
        """Feed one round's mean edge-cohort losses to ``AdaptiveBudgets``
        (NaN for the edges that reported nothing) and rebind the per-edge
        selectors when the apportionment moved."""
        util = np.full(self.edge_count, np.nan)
        for c in cohorts:
            util[c.edge] = float(np.asarray(c.losses, np.float64).mean())
        new_budgets = self._budget_ctl.observe_round(util)
        if not np.array_equal(new_budgets, self.budgets):
            self.budgets = new_budgets
            self._build_edge_selectors()

    # -- rounds ------------------------------------------------------------

    def _run_round(self, ctx: RoundContext, t: int, eval_batch: Any) -> None:
        if self.policy == "async":
            self._run_round_async(ctx, t, eval_batch)
        else:
            self._run_round_sync(ctx, t, eval_batch)
        self._rounds_done = t + 1

    def _run_round_sync(self, ctx: RoundContext, t: int, eval_batch: Any) -> None:
        dev = self.device
        t0 = time.perf_counter()
        picks = self.select_round(t)
        t1 = time.perf_counter()
        cohorts = self._inner_execute(picks)
        synchronize(dev)
        t2 = time.perf_counter()
        if len(cohorts) == 1:
            # The weighted mean of one edge aggregate is that aggregate,
            # taken bitwise: the E = 1 flat-equivalence contract.
            self.params = cohorts[0].avg_params
        elif cohorts:
            deltas = [fed_server.params_delta_f32(c.avg_params, self.params)
                      for c in cohorts]
            w = torch.tensor([c.weight for c in cohorts], dtype=torch.float32)
            self.params = fed_server.apply_weighted_deltas(self.params, deltas, w)
        self.cloud_uploads.append(len(cohorts))
        synchronize(dev)
        t3 = time.perf_counter()
        ctx.select_ms = (t1 - t0) * 1e3
        ctx.execute_ms = (t2 - t1) * 1e3
        ctx.aggregate_ms = (t3 - t2) * 1e3
        self._fold_observations(ctx, t, cohorts)
        self._eval(ctx, eval_batch)
        ctx.sim_time = float(t + 1)

    def _run_round_async(self, ctx: RoundContext, t: int, eval_batch: Any) -> None:
        dev, acfg = self.device, self.acfg
        dispatch_time = self.clock.now

        # 1.–2. Dispatch idle edges; each trains now, and its aggregate
        # reaches the cloud after the max of its cohort's latencies.
        t0 = time.perf_counter()
        picks = self.select_round(t)
        t1 = time.perf_counter()
        dispatched = np.zeros(self.spec.data.num_clients, bool)
        for c in self._inner_execute(picks):
            c.delta = fed_server.params_delta_f32(c.avg_params, self.params)
            c.avg_params = None  # the anchor-relative delta is what travels
            lat = float(self.latency.sample(c.selected, self.rng).max())
            self.clock.schedule(lat, c.edge, t, payload=c)
            self._edge_in_flight[c.edge] = True
            dispatched[c.selected] = True
        synchronize(dev)
        t2 = time.perf_counter()

        # 3. Close the cloud round at the deadline; straggler edges carry
        # forward as stale arrivals.
        kept, dropped = drain_due_arrivals(self.clock, acfg, t, dispatch_time,
                                           self._edge_in_flight)
        self.updates_dropped += dropped

        # 4. Buffered aggregation of the arrived edge aggregates.
        stale = np.asarray([t - ev.dispatch_round for ev in kept], np.float32)
        arrivals = [ev.payload for ev in kept]
        if kept:
            agg_cohort = CohortUpdates(
                mean_loss=np.asarray([c.losses.mean() for c in arrivals], np.float32),
                update_sqnorm=np.asarray([c.sqnorms.mean() for c in arrivals], np.float32),
                delta_list=[c.delta for c in arrivals],
                staleness=stale,
                weights=np.asarray([c.weight for c in arrivals], np.float32),
            )
            self.params = self.aggregator.reduce(self.params, agg_cohort)
        self.cloud_uploads.append(len(kept))
        synchronize(dev)
        t3 = time.perf_counter()
        ctx.select_ms = (t1 - t0) * 1e3
        ctx.execute_ms = (t2 - t1) * 1e3
        ctx.aggregate_ms = (t3 - t2) * 1e3
        self._fold_observations(ctx, t, arrivals, dispatched_mask=dispatched)

        n_stragglers = sum(1 for ev in kept if ev.dispatch_round < t)
        self.stragglers_carried += n_stragglers
        self.wall_clock.append(self.clock.now)
        self.round_staleness.append(float(stale.mean()) if len(stale) else 0.0)
        ctx.sim_time = self.clock.now
        ctx.num_arrivals = len(kept)
        ctx.num_stragglers = n_stragglers
        self._eval(ctx, eval_batch)

    def _result(self, extras: Dict[str, Any]) -> FLResult:
        extras.setdefault("cloud_uploads", np.asarray(self.cloud_uploads, np.int64))
        if self.policy == "async":
            extras.setdefault("wall_clock", np.asarray(self.wall_clock))
            extras.setdefault("round_staleness", np.asarray(self.round_staleness))
        return super()._result(extras)

    # -- checkpoint / resume ----------------------------------------------
    #
    # The partition is rebuilt from the spec, not persisted; only its edge
    # count is stamped into the snapshot as a check. Persisted through
    # extra_state: the upload series, the adaptive budgets and their
    # controller, and under 'async' the clock with each in-flight EdgeCohort
    # (its delta as a tree; ids, losses and norms as per-seq arrays), the
    # in-flight edge mask and the wall-clock series. The snapshot kind names
    # the policy, so an async snapshot never restores into a sync engine.

    @property
    def snapshot_kind(self) -> str:
        return f"{self.policy}/hierarchical"

    def extra_state(self):
        trees: Dict[str, Any] = {}
        arrays: Dict[str, np.ndarray] = {
            "cloud_uploads": np.asarray(self.cloud_uploads, np.int64),
        }
        meta: Dict[str, Any] = {"edge_count": self.edge_count}
        if self._budget_ctl is not None:
            arrays["budgets"] = np.asarray(self.budgets, np.int64)
            util = self._budget_ctl.utilities
            if util is not None:
                arrays["budget_util"] = util
        if self.policy == "async":
            pending_meta: Dict[str, Any] = {}
            for ev in self.clock.pending():
                c = ev.payload
                trees[f"pending/{ev.seq}"] = c.delta
                arrays[f"pending_sel/{ev.seq}"] = np.asarray(c.selected, np.int64)
                arrays[f"pending_loss/{ev.seq}"] = np.asarray(c.losses, np.float32)
                arrays[f"pending_sqnorm/{ev.seq}"] = np.asarray(c.sqnorms, np.float32)
                pending_meta[str(ev.seq)] = {"edge": c.edge, "weight": c.weight}
            arrays["edge_in_flight"] = self._edge_in_flight
            arrays["wall_clock"] = np.asarray(self.wall_clock, np.float64)
            arrays["round_staleness"] = np.asarray(self.round_staleness, np.float64)
            meta.update(clock=self.clock.state_dict(), pending=pending_meta,
                        stragglers_carried=self.stragglers_carried,
                        updates_dropped=self.updates_dropped)
        return trees, arrays, meta

    def extra_likes(self, meta):
        extra = meta["extra"]
        if extra.get("edge_count") != self.edge_count:
            raise torch_ckpt.CheckpointMismatchError(
                f"snapshot was written with edge_count={extra.get('edge_count')}, "
                f"this engine partitions into {self.edge_count} edges — resume "
                "with the same FedConfig.edge_count")
        if self.policy != "async":
            return {}
        # In-flight edge deltas share the params structure but are f32.
        delta_like = {n: torch.zeros(x.shape, dtype=torch.float32, device=x.device)
                      for n, x in self.params.items()}
        return {f"pending/{ev['seq']}": delta_like for ev in extra["clock"]["events"]}

    def load_extra_state(self, trees, arrays, meta):
        extra = meta["extra"]
        self.cloud_uploads = [int(x) for x in arrays["cloud_uploads"]]
        if self._budget_ctl is not None:
            util = arrays.get("budget_util")
            self._budget_ctl.load_state_dict(
                {"util": None if util is None else np.asarray(util)})
            self.budgets = np.asarray(arrays["budgets"], np.int64)
            self._build_edge_selectors()
        if self.policy != "async":
            return
        payloads = {
            int(seq): EdgeCohort(
                edge=int(info["edge"]),
                selected=np.asarray(arrays[f"pending_sel/{seq}"], np.int64),
                losses=np.asarray(arrays[f"pending_loss/{seq}"], np.float32),
                sqnorms=np.asarray(arrays[f"pending_sqnorm/{seq}"], np.float32),
                weight=float(info["weight"]), delta=trees[f"pending/{seq}"])
            for seq, info in extra["pending"].items()
        }
        self.clock = VirtualClock()
        self.clock.load_state_dict(extra["clock"], payloads)
        self._edge_in_flight = np.asarray(arrays["edge_in_flight"], bool).copy()
        self.wall_clock = [float(x) for x in arrays["wall_clock"]]
        self.round_staleness = [float(x) for x in arrays["round_staleness"]]
        self.stragglers_carried = int(extra["stragglers_carried"])
        self.updates_dropped = int(extra["updates_dropped"])
