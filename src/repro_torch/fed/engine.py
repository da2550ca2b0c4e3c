"""Composable federated round engine (paper Algorithm 1), sync rounds.

Counterpart of ``repro.fed.engine``. ``FederatedEngine`` owns the
Algorithm-1 skeleton — select → local train → aggregate → metadata update →
eval — and delegates each stage to a plugin:

  * ``ClientExecutor`` — ``BatchedExecutor`` (the cohort in one vmapped
    call, ``fed.batched``) or ``SequentialExecutor`` (one call per client).
  * ``Aggregator`` — ``FedAvg`` (Alg. 1 line 26), ``WeightedFedAvg``
    (|D_k|-weighted) or ``FedAvgM`` (server momentum); ``cohort_weights``
    runs before execution so the batched path folds the weights into its
    fused reduction.
  * ``RoundHook`` — ``MetricsHook`` (the series ``FLResult`` is built
    from), ``VerboseHook`` (one line per round).

Randomness comes from outside where the reference draws it with
``jax.random``: ``FederatedSpec.noise(round_idx, K)`` gives each round's
selection draws — the (K,) Gumbel row, or a mapping of named (K,) rows for
a selector that takes more (``core.selection.selector_draws``:
``power_of_choice`` takes ``gumbel`` and ``jitter``) — and
``FederatedSpec.init_params`` the initial weights; by default both are
drawn from ``torch.Generator``s seeded from ``fed.seed``. The host data
stream is ``np.random.default_rng(fed.seed)`` as in the reference, consumed
in ascending client-id order, so batches match the reference's bitwise.

``FederatedSpec.build`` returns this flat engine or, for
``topology='hierarchical'``, ``fed.hierarchy.HierarchicalEngine``. Only
``round_policy='sync'`` is ported; 'async' raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import (Any, Callable, Dict, List, Mapping, Optional, Protocol,
                    Sequence, Union, runtime_checkable)

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core.scoring import HeteRoScoreConfig
from repro_torch.core.selection import (Draws, SelectorConfig, draw, make_selector,
                                        selector_draws)
from repro_torch.core.state import (ClientState, init_client_state,
                                    scatter_observations, update_client_state)
from repro_torch.device import resolve_device, synchronize
from repro_torch.fed import batched as fed_batched
from repro_torch.fed import client as fed_client
from repro_torch.fed import server as fed_server
from repro_torch.kernels._math import exp as _exp

# (round_idx, K) -> (K,) Gumbel row, or {name: (K,) row} (core.selection)
NoiseFn = Callable[[int, int], Draws]
EvalFn = Callable[[Any, Any, Dict[str, torch.Tensor]], float]
# (round_idx, stream, n) -> (n,) draws; see fed.hierarchy for the streams.
EdgeNoiseFn = Callable[[int, int, int], Draws]


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FLResult:
    """Everything the paper reports for one federated run."""

    accuracy: np.ndarray          # (rounds,) per-round eval metric
    train_loss: np.ndarray        # (rounds,)
    selection_counts: np.ndarray  # (K,)
    selected_history: np.ndarray  # (rounds, K) bool
    params: Any
    metric_name: str = "accuracy"
    # Hierarchical runs: edge aggregates uploaded to the cloud per round.
    # None for flat runs, where every selected client uploads.
    cloud_uploads: Optional[np.ndarray] = None
    # Per-round host-observed phase timings (ms). On a card each phase ends
    # with a device synchronize, so they cover the device work.
    select_ms: Optional[np.ndarray] = None
    execute_ms: Optional[np.ndarray] = None
    aggregate_ms: Optional[np.ndarray] = None
    eval_ms: Optional[np.ndarray] = None

    @property
    def peak_acc(self) -> float:
        return float(self.accuracy.max())

    @property
    def final_acc(self) -> float:
        return float(self.accuracy[-1])

    @property
    def stable_acc(self) -> float:
        return float(self.accuracy[-10:].mean())

    @property
    def stability_drop(self) -> float:
        return self.peak_acc - self.final_acc

    @property
    def selection_std(self) -> float:
        return float(self.selection_counts.std())

    def summary(self) -> Dict[str, float]:
        return {
            "peak_acc": self.peak_acc,
            "final_acc": self.final_acc,
            "stable_acc": self.stable_acc,
            "stability_drop": self.stability_drop,
            "selection_std": self.selection_std,
        }

    def labeled_summary(self) -> Dict[str, float]:
        """``summary()`` with the eval metric named honestly in the keys."""
        m = self.metric_name
        return {
            f"peak_{m}": self.peak_acc,
            f"final_{m}": self.final_acc,
            f"stable_{m}": self.stable_acc,
            "stability_drop": self.stability_drop,
            "selection_std": self.selection_std,
        }


def default_eval(model: Any, params: Any, batch: Dict[str, torch.Tensor]) -> float:
    """Accuracy for classifiers; exp(-loss) (per-token) for LM families."""
    with torch.no_grad():
        if model.cfg.family == "resnet":
            logits = model.forward(params, batch)
            return float(torch.mean((torch.argmax(logits, -1) == batch["labels"]
                                     ).to(torch.float32)))
        return float(_exp(-model.loss(params, batch)))


def default_metric_name(model: Any) -> str:
    return "accuracy" if model.cfg.family == "resnet" else "exp(-loss)"


# ---------------------------------------------------------------------------
# Stage protocols + cohort container
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CohortUpdates:
    """One round's cohort outcome. ``mean_loss`` / ``update_sqnorm`` are (M,)
    in cohort order: tensors from the batched path, numpy from sequential.
    ``weights`` are the aggregator's cohort weights (None: unweighted)."""

    mean_loss: Any
    update_sqnorm: Any
    avg_params: Optional[Any] = None
    param_list: Optional[List[Any]] = None
    weights: Optional[torch.Tensor] = None


@runtime_checkable
class ClientExecutor(Protocol):
    """How the selected cohort trains for one round."""

    def run_round(self, params: Any, selected: np.ndarray,
                  rng: np.random.Generator,
                  weights: Optional[torch.Tensor] = None) -> CohortUpdates: ...


class Aggregator:
    """How cohort updates become the next global model (Alg. 1 line 26).

    ``cohort_weights`` runs before execution, so the batched path can fold
    the weights into its fused reduction; ``reduce`` turns the cohort into
    the new global params.
    """

    name = "base"

    def cohort_weights(self, selected: np.ndarray, data: Any) -> Optional[torch.Tensor]:
        return None

    def reduce(self, global_params: Any, cohort: CohortUpdates) -> Any:
        raise NotImplementedError

    def _mean(self, cohort: CohortUpdates) -> Any:
        if cohort.avg_params is not None:
            return cohort.avg_params
        if cohort.param_list is None:
            raise ValueError("cohort carries neither avg_params nor param_list")
        if cohort.weights is not None:
            return fed_server.fedavg_fused(
                fed_batched.stack_client_trees(cohort.param_list), cohort.weights)
        return fed_server.fedavg(cohort.param_list)


class RoundHook:
    """Cross-cutting round-loop callback. Subclass and override what you need."""

    def on_round_start(self, ctx: "RoundContext") -> None:
        pass

    def on_round_end(self, ctx: "RoundContext") -> None:
        pass


@dataclasses.dataclass
class RoundContext:
    """What hooks see. Mutated in place by the engine as the round advances."""

    engine: "FederatedEngine"
    round_idx: int = 0
    mask: Optional[np.ndarray] = None       # (K,) bool — this round's cohort
    selected: Optional[np.ndarray] = None   # cohort client ids
    metric: float = 0.0
    train_loss: float = 0.0
    select_ms: float = 0.0
    execute_ms: float = 0.0
    aggregate_ms: float = 0.0
    eval_ms: float = 0.0

    @property
    def fed(self) -> FedConfig:
        return self.engine.spec.fed


# ---------------------------------------------------------------------------
# Registries
# ---------------------------------------------------------------------------

EXECUTORS: Dict[str, Callable[["FederatedSpec"], ClientExecutor]] = {}
AGGREGATORS: Dict[str, Callable[["FederatedSpec"], Aggregator]] = {}


def register_executor(name: str):
    def deco(factory):
        EXECUTORS[name] = factory
        return factory
    return deco


def register_aggregator(name: str):
    def deco(factory):
        AGGREGATORS[name] = factory
        return factory
    return deco


# ---------------------------------------------------------------------------
# Executors
# ---------------------------------------------------------------------------


def _to_device(batch: Dict[str, torch.Tensor], device: torch.device):
    return {k: v.to(device) for k, v in batch.items()}


class BatchedExecutor:
    """Whole cohort in one vmapped call (``fed.batched``); honours
    ``FedConfig.client_chunk``."""

    def __init__(self, spec: "FederatedSpec"):
        self.fed = spec.fed
        self.data = spec.data
        self.steps = spec.resolved_steps
        self.device = torch.device(spec.device)
        self._train = fed_batched.make_batched_local_train(
            spec.model.loss, lr=spec.fed.lr, mu=spec.fed.mu)

    def run_round(self, params, selected, rng, weights=None) -> CohortUpdates:
        stacked = _to_device(fed_batched.gather_stacked_batches(
            self.data, selected, self.steps, self.fed.local_batch, rng), self.device)
        cohort = fed_batched.train_clients_batched(
            self._train, params, stacked, weights=weights,
            chunk=self.fed.client_chunk)
        return CohortUpdates(
            mean_loss=cohort.mean_loss,
            update_sqnorm=cohort.update_sqnorm,
            avg_params=cohort.avg_params,
            weights=weights,
        )


class SequentialExecutor:
    """One ``local_train`` call per client — the numerical reference."""

    def __init__(self, spec: "FederatedSpec"):
        self.model = spec.model
        self.fed = spec.fed
        self.data = spec.data
        self.steps = spec.resolved_steps
        self.device = torch.device(spec.device)

    def run_round(self, params, selected, rng, weights=None) -> CohortUpdates:
        m = len(selected)
        param_list: List[Any] = []
        losses = np.zeros(m, np.float32)
        sqnorms = np.zeros(m, np.float32)
        for i, k in enumerate(selected):
            batches = _to_device(self.data.client_batches(
                int(k), self.steps, self.fed.local_batch, rng), self.device)
            res = fed_client.local_train(self.model.loss, params, batches,
                                         lr=self.fed.lr, mu=self.fed.mu)
            losses[i] = float(res.mean_loss)
            sqnorms[i] = float(res.update_sqnorm)
            param_list.append(res.params)
        return CohortUpdates(mean_loss=losses, update_sqnorm=sqnorms,
                             param_list=param_list, weights=weights)


@register_executor("batched")
def _make_batched(spec: "FederatedSpec") -> BatchedExecutor:
    return BatchedExecutor(spec)


@register_executor("sequential")
def _make_sequential(spec: "FederatedSpec") -> SequentialExecutor:
    return SequentialExecutor(spec)


# ---------------------------------------------------------------------------
# Aggregators
# ---------------------------------------------------------------------------


class FedAvg(Aggregator):
    """Unweighted mean over the cohort — the paper's Algorithm 1 line 26."""

    name = "fedavg"

    def reduce(self, global_params, cohort):
        return self._mean(cohort)


class WeightedFedAvg(Aggregator):
    """|D_k|-weighted FedAvg (the original McMahan form): each client weighs
    its example count, ``len(data.client_indices[k])``."""

    name = "fedavg_weighted"

    def __init__(self):
        self._sizes: Optional[np.ndarray] = None  # per-run cache, O(K) once

    def cohort_weights(self, selected, data):
        if self._sizes is None:
            self._sizes = np.asarray([len(ix) for ix in data.client_indices],
                                     np.float32)
        return torch.from_numpy(self._sizes[selected])

    def reduce(self, global_params, cohort):
        return self._mean(cohort)


class FedAvgM(Aggregator):
    """FedAvgM: server momentum over the round means (``fed.server``)."""

    name = "fedavgm"

    def __init__(self, beta: float = 0.9):
        self.momentum = fed_server.ServerMomentum(beta=beta)

    def reduce(self, global_params, cohort):
        return self.momentum.apply(global_params, self._mean(cohort))


@register_aggregator("fedavg")
def _make_fedavg(spec: "FederatedSpec") -> FedAvg:
    return FedAvg()


@register_aggregator("fedavg_weighted")
def _make_fedavg_weighted(spec: "FederatedSpec") -> WeightedFedAvg:
    return WeightedFedAvg()


@register_aggregator("fedavgm")
def _make_fedavgm(spec: "FederatedSpec") -> FedAvgM:
    return FedAvgM()


# ---------------------------------------------------------------------------
# Hooks
# ---------------------------------------------------------------------------


class MetricsHook(RoundHook):
    """Collects the per-round series ``FLResult`` is built from. The engine
    installs one first in the hook list when the spec gives none."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.metric: List[float] = []
        self.train_loss: List[float] = []
        self.selected: List[np.ndarray] = []
        self.select_ms: List[float] = []
        self.execute_ms: List[float] = []
        self.aggregate_ms: List[float] = []
        self.eval_ms: List[float] = []

    def on_round_end(self, ctx: RoundContext) -> None:
        self.metric.append(ctx.metric)
        self.train_loss.append(ctx.train_loss)
        self.selected.append(ctx.mask)
        self.select_ms.append(ctx.select_ms)
        self.execute_ms.append(ctx.execute_ms)
        self.aggregate_ms.append(ctx.aggregate_ms)
        self.eval_ms.append(ctx.eval_ms)


class VerboseHook(RoundHook):
    """Prints one line every ``every`` rounds and after the last round."""

    every = 10

    def on_round_end(self, ctx: RoundContext) -> None:
        t = ctx.round_idx
        if t % self.every == 0 or t == ctx.fed.rounds - 1:
            eng = ctx.engine
            print(f"round {t:3d}  {eng.metric_name}={ctx.metric:.4f}  "
                  f"train_loss={ctx.train_loss:.4f}  selector={eng.selector_name}  "
                  f"cohort={ctx.selected.tolist()}  select={ctx.select_ms:.2f}ms  "
                  f"execute={ctx.execute_ms:.1f}ms  "
                  f"aggregate={ctx.aggregate_ms:.2f}ms", flush=True)


# ---------------------------------------------------------------------------
# Spec + engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FederatedSpec:
    """Declarative description of one federated run.

    ``executor`` / ``aggregator`` accept registry names or instances;
    ``executor=None`` defers to ``fed.client_execution``. ``eval_fn(model,
    params, eval_batch) -> float`` replaces ``default_eval``, and
    ``metric_name`` names what it returns ("metric" by default).
    ``noise`` and ``init_params`` supply the draws the reference takes from
    ``jax.random`` (see the module docstring); a hierarchical run takes its
    selection draws from ``edge_noise`` instead (``fed.hierarchy``), and
    ``hier_cfg`` (a ``fed.hierarchy.HierarchyConfig``) holds its partition
    and outer-budget knobs. ``device`` defaults to ``"cuda"``; on a machine
    without a card that raises at ``run()``.
    """

    model: Any
    fed: FedConfig
    data: Any
    selector: Optional[str] = None
    score_cfg: Optional[HeteRoScoreConfig] = None
    sel_cfg: Optional[SelectorConfig] = None
    steps_per_round: Optional[int] = None
    eval_fn: Optional[EvalFn] = None
    metric_name: Optional[str] = None
    executor: Union[str, ClientExecutor, None] = None
    aggregator: Union[str, Aggregator] = "fedavg"
    hooks: Sequence[RoundHook] = ()
    verbose: bool = False
    round_policy: Optional[str] = None
    topology: Optional[str] = None
    device: Union[str, torch.device] = "cuda"
    noise: Optional[NoiseFn] = None
    init_params: Optional[Dict[str, Any]] = None
    hier_cfg: Optional[Any] = None
    edge_noise: Optional[EdgeNoiseFn] = None

    @property
    def resolved_steps(self) -> int:
        return self.steps_per_round or self.fed.local_epochs

    @property
    def resolved_selector(self) -> str:
        return self.selector or self.fed.selector

    @property
    def resolved_round_policy(self) -> str:
        return self.round_policy or self.fed.round_policy

    @property
    def resolved_topology(self) -> str:
        return self.topology or self.fed.topology

    def build(self) -> "FederatedEngine":
        policy = self.resolved_round_policy
        if policy not in ("sync", "async"):
            raise ValueError(f"round_policy must be 'sync' or 'async', got {policy!r}")
        if policy != "sync":
            raise NotImplementedError(
                f"round_policy={policy!r} is not ported yet; only 'sync' is")
        topo = self.resolved_topology
        if topo == "hierarchical":
            from repro_torch.fed.hierarchy import HierarchicalEngine

            return HierarchicalEngine(self)
        if topo != "flat":
            raise ValueError(
                f"topology must be 'flat' or 'hierarchical', got {topo!r}")
        if self.hier_cfg is not None or self.edge_noise is not None:
            raise ValueError(
                "hier_cfg/edge_noise are only consumed by topology='hierarchical'; "
                "the flat engine has no edge tier to apply them to")
        if self.fed.edge_count or self.fed.edge_budget:
            # Edge sizing without topology='hierarchical' would run a flat
            # federation that looks two-tier.
            raise ValueError(
                "FedConfig.edge_count/edge_budget are only consumed by "
                "topology='hierarchical'; set FedConfig.topology (or the "
                "spec's topology field) or drop the edge fields")
        return FederatedEngine(self)


def _resolve_executor(spec: FederatedSpec) -> ClientExecutor:
    ex = spec.executor
    if ex is None or isinstance(ex, str):
        name = ex or spec.fed.client_execution
        if name not in EXECUTORS:
            raise ValueError(
                f"client_execution must be one of {sorted(EXECUTORS)}, got {name!r}")
        ex = EXECUTORS[name](spec)
    return ex


def _resolve_aggregator(spec: FederatedSpec) -> Aggregator:
    agg = spec.aggregator
    if isinstance(agg, str):
        if agg not in AGGREGATORS:
            raise ValueError(f"aggregator must be one of {sorted(AGGREGATORS)} "
                             f"(the others are not ported), got {agg!r}")
        agg = AGGREGATORS[agg](spec)
    return agg


def _resolve_hooks(spec: FederatedSpec) -> List[RoundHook]:
    hooks = list(spec.hooks)
    if spec.verbose and not any(isinstance(h, VerboseHook) for h in hooks):
        hooks.append(VerboseHook())
    # The metrics hook runs first, so every other hook sees the round's
    # series already appended.
    mh = next((h for h in hooks if isinstance(h, MetricsHook)), None)
    if mh is None:
        mh = MetricsHook()
    else:
        hooks.remove(mh)
    hooks.insert(0, mh)
    return hooks


class FederatedEngine:
    """Algorithm-1 skeleton over pluggable executor / aggregator / hooks."""

    def __init__(self, spec: FederatedSpec):
        self.spec = spec
        self.executor = _resolve_executor(spec)
        self.aggregator = _resolve_aggregator(spec)
        self.hooks = _resolve_hooks(spec)
        self.metrics = next(h for h in self.hooks if isinstance(h, MetricsHook))

        self.selector_name = spec.resolved_selector
        score_cfg = spec.score_cfg or HeteRoScoreConfig()
        sel_cfg = spec.sel_cfg or SelectorConfig(num_selected=spec.fed.num_selected)
        self._select = make_selector(self.selector_name, sel_cfg, score_cfg)
        self.eval_fn = spec.eval_fn or default_eval
        self.metric_name = spec.metric_name or (
            "metric" if spec.eval_fn is not None else default_metric_name(spec.model))

        self.device: Optional[torch.device] = None
        self.params: Any = None
        self.state: Optional[ClientState] = None
        self.noise: Optional[NoiseFn] = None
        self.rng: Optional[np.random.Generator] = None

    def run(self) -> FLResult:
        self._start()
        ctx = RoundContext(engine=self)
        eval_batch = _to_device(self.spec.data.eval_batch(), self.device)
        for t in range(self.spec.fed.rounds):
            ctx.round_idx = t
            for h in self.hooks:
                h.on_round_start(ctx)
            self._run_round(ctx, t, eval_batch)
            for h in self.hooks:
                h.on_round_end(ctx)
        return self._result({})

    def _start(self) -> None:
        """Resolve the device and draw the run's initial state."""
        spec, fed = self.spec, self.spec.fed
        dev = self.device = resolve_device(spec.device)
        if spec.init_params is not None:
            self.params = {k: torch.as_tensor(v).to(dev).clone()
                           for k, v in spec.init_params.items()}
        else:
            init_gen = torch.Generator(device=dev)
            init_gen.manual_seed(fed.seed + 1)
            self.params = spec.model.init_params(init_gen)
        if spec.noise is not None:
            self.noise = spec.noise
        else:
            noise_gen = torch.Generator(device=dev)
            noise_gen.manual_seed(fed.seed)
            names = selector_draws(self.selector_name)
            self.noise = lambda t, k: draw(noise_gen, names, k)
        self.state = init_client_state(spec.data.num_clients, spec.data.label_js,
                                       device=dev)
        self.rng = np.random.default_rng(fed.seed)
        self.metrics.reset()

    def round_noise(self, t: int) -> Draws:
        """Round t's selection draws — the (K,) Gumbel row or the named
        rows — as f32 on the run's device."""
        return self._on_device(self.noise(t, self.spec.data.num_clients))

    def _on_device(self, draws: Draws) -> Draws:
        if isinstance(draws, Mapping):
            return {n: self._on_device(v) for n, v in draws.items()}
        return torch.as_tensor(draws).to(device=self.device, dtype=torch.float32)

    def _run_round(self, ctx: RoundContext, t: int, eval_batch: Any) -> None:
        spec, dev = self.spec, self.device
        t0 = time.perf_counter()
        mask, _ = self._select(self.round_noise(t), self.state, t)
        mask_np = mask.cpu().numpy()  # device sync — the selection phase ends
        selected = np.flatnonzero(mask_np)
        t1 = time.perf_counter()

        weights = self.aggregator.cohort_weights(selected, spec.data)
        cohort = self.executor.run_round(self.params, selected, self.rng,
                                         weights=weights)
        synchronize(dev)
        t2 = time.perf_counter()
        self.params = self.aggregator.reduce(self.params, cohort)
        synchronize(dev)
        t3 = time.perf_counter()
        ctx.select_ms = (t1 - t0) * 1e3
        ctx.execute_ms = (t2 - t1) * 1e3
        ctx.aggregate_ms = (t3 - t2) * 1e3

        obs_loss, obs_sqnorm = self._dense_observations(selected, cohort)
        self.state = update_client_state(
            self.state, round_idx=t,
            selected_mask=torch.from_numpy(mask_np).to(dev),
            observed_loss=torch.from_numpy(obs_loss).to(dev),
            observed_sqnorm=torch.from_numpy(obs_sqnorm).to(dev),
        )
        ctx.mask = mask_np
        ctx.selected = selected
        self._eval(ctx, eval_batch)
        ctx.train_loss = float(np.mean(obs_loss[selected])) if len(selected) else 0.0

    def _eval(self, ctx: RoundContext, eval_batch: Any) -> None:
        """The round's eval metric and its host time (the metric's float()
        waits for the device)."""
        t0 = time.perf_counter()
        ctx.metric = self.eval_fn(self.spec.model, self.params, eval_batch)
        ctx.eval_ms = (time.perf_counter() - t0) * 1e3

    def _dense_observations(self, selected: np.ndarray, cohort: CohortUpdates):
        k = self.spec.data.num_clients
        if isinstance(cohort.mean_loss, np.ndarray):
            obs_loss = np.zeros(k, np.float32)
            obs_sqnorm = np.zeros(k, np.float32)
            obs_loss[selected] = cohort.mean_loss
            obs_sqnorm[selected] = cohort.update_sqnorm
            return obs_loss, obs_sqnorm
        loss_t, sq_t = scatter_observations(
            k, torch.from_numpy(selected), cohort.mean_loss, cohort.update_sqnorm)
        return loss_t.cpu().numpy(), sq_t.cpu().numpy()

    def _result(self, extras: Dict[str, Any]) -> FLResult:
        """The run's ``FLResult``; subclasses add their series to ``extras``
        (the hierarchical engine its ``cloud_uploads``)."""
        sel_hist = np.stack(self.metrics.selected)
        return FLResult(
            accuracy=np.array(self.metrics.metric),
            train_loss=np.array(self.metrics.train_loss),
            selection_counts=sel_hist.sum(axis=0),
            selected_history=sel_hist,
            params=self.params,
            metric_name=self.metric_name,
            cloud_uploads=extras.get("cloud_uploads"),
            select_ms=np.asarray(self.metrics.select_ms),
            execute_ms=np.asarray(self.metrics.execute_ms),
            aggregate_ms=np.asarray(self.metrics.aggregate_ms),
            eval_ms=np.asarray(self.metrics.eval_ms),
        )
