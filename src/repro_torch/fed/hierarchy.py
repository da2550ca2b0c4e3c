"""Hierarchical two-tier federation: client → edge → cloud, sync rounds.

Counterpart of ``repro.fed.hierarchy`` under ``round_policy='sync'``.
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

Async rounds, availability masks, the ``adaptive`` budget controller,
checkpointing and tracer spans are not ported.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.scoring import HeteRoScoreConfig
from repro_torch.core.selection import (SelectorConfig, draw, dynamic_temperature,
                                        edge_selection_probs, gumbel_noise,
                                        make_selector, sample_clients,
                                        selector_draws)
from repro_torch.core.state import (pool_client_state, score_inputs,
                                    update_client_state)
from repro_torch.device import synchronize
from repro_torch.fed import server as fed_server
from repro_torch.fed.engine import (FedAvg, FederatedEngine, FederatedSpec,
                                    FLResult, RoundContext, WeightedFedAvg)
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
    avg_params: Any = None     # the edge aggregate


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float32)
    return np.asarray(x, np.float32)


class HierarchicalEngine(FederatedEngine):
    """Two-tier sync rounds; built by ``FederatedSpec.build()`` for
    ``topology='hierarchical'``."""

    def __init__(self, spec: FederatedSpec):
        fed = spec.fed
        self.hcfg: HierarchyConfig = spec.hier_cfg or HierarchyConfig()
        selector = spec.resolved_selector
        if selector == "adaptive":
            raise NotImplementedError(
                "selector='adaptive' (online edge budgets) is not ported yet")
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
        if not isinstance(self.aggregator, (FedAvg, WeightedFedAvg)):
            raise ValueError(
                f"aggregator {getattr(self.aggregator, 'name', self.aggregator)!r} "
                "does not compose with the hierarchical cloud stage "
                "(edge aggregates combine as weighted deltas, not a "
                "cohort reduce); use 'fedavg' or 'fedavg_weighted'")

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
        # score pooled edges (multiplicative for heterosel_mult), 'random'
        # samples edges uniformly.
        self._outer_uniform = selector == "random"
        self._outer_sel_cfg = (dataclasses.replace(self._base_sel, additive=False)
                               if selector == "heterosel_mult" else self._base_sel)

        # Inner stage: heterosel_pallas scores every edge in one K4 launch
        # over an edge-major relayout (edge e owns slots [e·seg, e·seg + n_e),
        # padding slots gather client 0 and are masked in the kernel); the
        # other selectors run once per edge on the edge's rows, one selector
        # per distinct budget.
        self._segmented = self.selector_name == "heterosel_pallas"
        self._seg = -(-max(int(self.partition.sizes.max()), 1) // WARP) * WARP
        self._edge_select: Dict[int, Any] = {}
        if not self._segmented:
            by_budget: Dict[int, Any] = {}
            for e in range(self.edge_count):
                b = int(self.budgets[e])
                if b > 0 and b not in by_budget:
                    by_budget[b] = make_selector(
                        self.selector_name,
                        dataclasses.replace(self._base_sel, num_selected=b),
                        self._score_cfg)
                if b > 0:
                    self._edge_select[e] = by_budget[b]

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
            names = selector_draws(self.selector_name)
            self.edge_noise = lambda t, stream, n: (
                gumbel_noise(gen, n) if stream == self.edge_count else draw(gen, names, n))

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
        return [e for e in range(self.edge_count) if self.budgets[e] > 0]

    def _choose_edges(self, t: int, idle: List[int]) -> List[int]:
        """Outer cross-edge selection over the idle edges.

        No draw is taken when the outer budget covers every idle edge (which
        keeps E = 1 on the flat run's stream). Otherwise the Gumbel-top-E_sel
        runs in float64 on the host, as the reference's does, so a near-tie
        picks the same edge.
        """
        e_sel = self.hcfg.edges_per_round or self.edge_count
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
        edge-major layout, stay in ``segment_out``. The round's draws are
        taken through ``edge_noise`` on every call.
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
                n = len(self._members[e])
                probs_e = probs_all[e * self._seg:e * self._seg + n]
                masks.append(sample_clients(self.edge_draw(t, e, n), probs_e,
                                            int(self.budgets[e])))
        else:
            for e in active:
                idx = self._member_idx[e]
                estate = self.state.map(lambda x: x[idx])
                mask, _ = self._edge_select[e](self.edge_draw(t, e, len(idx)),
                                               estate, t)
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

    def _fold_observations(self, ctx: RoundContext, t: int,
                           cohorts: List[EdgeCohort]) -> None:
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
        ctx.mask = mask
        ctx.selected = np.flatnonzero(mask)
        ctx.train_loss = (float(np.concatenate([c.losses for c in cohorts]).mean())
                          if cohorts else 0.0)

    # -- rounds ------------------------------------------------------------

    def _run_round(self, ctx: RoundContext, t: int, eval_batch: Any) -> None:
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

    def _result(self, extras: Dict[str, Any]) -> FLResult:
        extras.setdefault("cloud_uploads", np.asarray(self.cloud_uploads, np.int64))
        return super()._result(extras)
