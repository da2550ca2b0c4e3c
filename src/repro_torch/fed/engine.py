"""Composable federated round engine (paper Algorithm 1 as a plugin surface).

Counterpart of ``repro.fed.engine``. ``FederatedEngine`` owns the
Algorithm-1 skeleton — select → local train → aggregate → metadata update →
eval — and delegates each stage to a plugin:

  * ``ClientExecutor`` — ``BatchedExecutor`` (the cohort in one vmapped
    call, ``fed.batched``) or ``SequentialExecutor`` (one call per client).
  * ``Aggregator`` — ``FedAvg`` (Alg. 1 line 26), ``WeightedFedAvg``
    (|D_k|-weighted), ``FedAvgM`` (server momentum) or, registered by
    ``fed.async_engine``, ``BufferedAggregator`` ("fedbuff");
    ``cohort_weights`` runs before execution so the batched path folds the
    weights into its fused reduction.
    ``CompressedExecutor`` wraps either and owns the codec state
    (``fed.compression``: int8 over the stacked cohort, or top-k with
    per-client error-feedback residuals).
  * ``RoundHook`` — ``MetricsHook`` (the series ``FLResult`` is built
    from), ``VerboseHook`` (one line per round, from the shared
    ``obs.MetricsRegistry``), ``AdaptiveMuHook`` (Lemma-A.4 μ retuning),
    ``CheckpointHook`` (mid-run checkpoint and resume,
    ``repro_torch.ckpt``), ``KillAtRound`` (a simulated preemption) and
    ``obs.TelemetryHook`` (traces, per-round telemetry, the stability
    report). Hooks may be given by their ``HOOKS`` registry names and run
    in ``priority`` order, ``MetricsHook`` first.

The engines hold a tracer (``obs.trace.NULL_TRACER`` until a
``TelemetryHook`` swaps in a recorder). Each round's ``select``,
``execute`` and ``aggregate`` spans are cut from the same clock readings as
the ``FLResult.*_ms`` they mirror, so on a card each still ends in its
device synchronize.

Randomness comes from outside where the reference draws it with
``jax.random``: ``FederatedSpec.noise(round_idx, K)`` gives each round's
selection draws — the (K,) Gumbel row, or a mapping of named (K,) rows for
a selector that takes more (``core.selection.selector_draws``:
``power_of_choice`` takes ``gumbel`` and ``jitter``; a run with an
``availability`` trace also takes ``remask``) — and
``FederatedSpec.init_params`` the initial weights; by default both are
drawn from ``torch.Generator``s seeded from ``fed.seed``. A caller's
``noise`` must be a function of ``(round_idx, K)`` alone, so that a resumed
run gets the draws the uninterrupted run got at the same rounds; the
default generator's state is checkpointed instead. The host data stream is
``np.random.default_rng(fed.seed)`` as in the reference, consumed in
ascending client-id order, so batches match the reference's bitwise.

``FederatedSpec.build`` returns this flat sync engine, the asynchronous
``fed.async_engine.AsyncFederatedEngine`` for ``round_policy='async'``, or
``fed.hierarchy.HierarchicalEngine`` for ``topology='hierarchical'`` (either
policy).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import (Any, Callable, Dict, List, Mapping, Optional, Protocol,
                    Sequence, Tuple, Union, runtime_checkable)

import numpy as np
import torch

from repro_torch import ckpt as torch_ckpt
from repro_torch.configs.base import FedConfig
from repro_torch.core.adaptive import AdaptiveMu
from repro_torch.core.scoring import HeteRoScoreConfig
from repro_torch.core.selection import (Draws, SelectorConfig, draw, make_selector,
                                        selector_draws)
from repro_torch.core.state import (ClientState, init_client_state,
                                    scatter_observations, to_bf16, update_client_state)
from repro_torch.device import resolve_device, synchronize
from repro_torch.fed import availability as fed_avail
from repro_torch.fed import batched as fed_batched
from repro_torch.fed import client as fed_client
from repro_torch.fed import compression as fed_comp
from repro_torch.fed import server as fed_server
from repro_torch.kernels._math import exp as _exp
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER

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
    wire_bytes: int = 0           # client→server traffic (compression on)
    raw_bytes: int = 0
    metric_name: str = "accuracy"
    mu_history: Optional[np.ndarray] = None  # AdaptiveMuHook's μ per round
    # Async runs (fed.async_engine): the virtual close time of each round and
    # the mean staleness of the updates aggregated in it. None for sync runs.
    wall_clock: Optional[np.ndarray] = None
    round_staleness: Optional[np.ndarray] = None
    # Hierarchical runs: edge aggregates uploaded to the cloud per round.
    # None for flat runs, where every selected client uploads.
    cloud_uploads: Optional[np.ndarray] = None
    # Per-round host-observed phase timings (ms). On a card each phase ends
    # with a device synchronize, so they cover the device work.
    select_ms: Optional[np.ndarray] = None
    execute_ms: Optional[np.ndarray] = None
    aggregate_ms: Optional[np.ndarray] = None
    eval_ms: Optional[np.ndarray] = None
    # The serving tier (serve.PublishHook): a summary dict of the request
    # telemetry (latency percentiles, decode throughput, served-version lag,
    # publish cost), and the accuracy-under-traffic series, the per-round
    # eval of the version being *served*, which trails the params being
    # aggregated. ``served_metric`` rows are (round, version, metric).
    serving: Optional[Dict[str, Any]] = None
    served_metric: Optional[np.ndarray] = None
    # The telemetry plane (obs.TelemetryHook): the JSON-able registry
    # snapshot (per-round fairness and communication rows, counters,
    # histogram summaries), the stability summary and any artifact paths.
    telemetry: Optional[Dict[str, Any]] = None

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
    ``weights`` are the aggregator's cohort weights (None: unweighted).

    The batched path ships the fused mean (``avg_params``) and, when asked,
    the (M, ...) client stack (``stacked_params``); the sequential path a
    list in cohort order. The async engine aggregates arrivals:
    ``delta_list`` holds each update's f32 delta against the global version
    its client trained on and ``staleness`` the (M,) version lag.
    ``wire_bytes`` / ``raw_bytes`` count the cohort's compressed and raw
    upload (``CompressedExecutor``; 0 without compression).
    """

    mean_loss: Any
    update_sqnorm: Any
    avg_params: Optional[Any] = None
    param_list: Optional[List[Any]] = None
    stacked_params: Optional[Any] = None
    weights: Optional[Any] = None
    wire_bytes: int = 0
    raw_bytes: int = 0
    delta_list: Optional[List[Any]] = None
    staleness: Optional[np.ndarray] = None


@runtime_checkable
class ClientExecutor(Protocol):
    """How the selected cohort trains for one round. ``kind`` names the
    schedule ('batched' | 'sequential'); ``set_mu`` rebinds the FedProx
    coefficient (``AdaptiveMuHook``)."""

    kind: str

    def run_round(self, params: Any, selected: np.ndarray,
                  rng: np.random.Generator,
                  weights: Optional[torch.Tensor] = None) -> CohortUpdates: ...

    def set_mu(self, mu: float) -> None: ...


class ExecutorCompatError(ValueError):
    """An execution schedule (or a codec on it) that cannot serve the engine
    asked for."""


class Aggregator:
    """How cohort updates become the next global model (Alg. 1 line 26).

    ``cohort_weights`` runs before execution, so the batched path can fold
    the weights into its fused reduction; ``reduce`` turns the cohort into
    the new global params. ``get_state``/``set_state`` expose server-side
    state (momentum velocity) to ``CheckpointHook``. ``supports_deltas``
    says whether ``reduce`` takes delta-form cohorts (the async engine's).
    """

    name = "base"
    supports_deltas = False

    def cohort_weights(self, selected: np.ndarray, data: Any) -> Optional[torch.Tensor]:
        return None

    def reduce(self, global_params: Any, cohort: CohortUpdates) -> Any:
        raise NotImplementedError

    def get_state(self) -> Optional[Any]:
        return None

    def set_state(self, state: Any) -> None:
        pass

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
    """Cross-cutting round-loop callback. Subclass and override what you need.

    Call order per run: ``on_run_start`` (may restore a checkpoint into the
    engine), then per round ``on_round_start`` / ``on_round_end``, then
    ``on_run_end`` and ``contribute`` (extra fields for the result).
    ``state_dict`` / ``load_state_dict`` carry a hook's resumable state
    through ``CheckpointHook``, keyed by the hook's position in the list.

    ``priority`` orders the list (higher first, a stable sort; the
    ``MetricsHook`` is pinned first whatever its priority), so producers
    such as ``TelemetryHook`` (10) precede the hooks that read their
    registry, and a resumed run rebuilds the same order.
    """

    priority = 0

    def on_run_start(self, ctx: "RoundContext") -> None:
        pass

    def on_round_start(self, ctx: "RoundContext") -> None:
        pass

    def on_round_end(self, ctx: "RoundContext") -> None:
        pass

    def on_run_end(self, ctx: "RoundContext") -> None:
        pass

    def contribute(self, extras: Dict[str, Any]) -> None:
        pass

    def state_dict(self) -> Optional[Dict[str, Any]]:
        return None

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        pass


@dataclasses.dataclass
class RoundContext:
    """What hooks see. Mutated in place by the engine as the round advances."""

    engine: "FederatedEngine"
    round_idx: int = 0
    mask: Optional[np.ndarray] = None       # (K,) bool — this round's cohort
    selected: Optional[np.ndarray] = None   # cohort client ids
    obs_loss: Optional[np.ndarray] = None   # (K,) dense observations
    obs_sqnorm: Optional[np.ndarray] = None
    metric: float = 0.0
    train_loss: float = 0.0
    # Virtual time at this round's close: the clock under 'async', t + 1 for
    # sync rounds. Arrivals and stragglers stay 0 in sync runs.
    sim_time: float = 0.0
    num_arrivals: int = 0
    num_stragglers: int = 0
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
HOOKS: Dict[str, Callable[["FederatedSpec"], RoundHook]] = {}


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


def register_hook(name: str):
    def deco(factory):
        HOOKS[name] = factory
        return factory
    return deco


# ---------------------------------------------------------------------------
# Executors
# ---------------------------------------------------------------------------


def _to_device(batch: Dict[str, torch.Tensor], device: torch.device):
    return {k: v.to(device) for k, v in batch.items()}


class BatchedExecutor:
    """Whole cohort in one vmapped call (``fed.batched``); honours
    ``FedConfig.client_chunk``. With ``keep_client_params`` set it also
    returns the (M, ...) client stack (the async engine sets it: it needs
    each client's update); chunked execution never materializes it."""

    kind = "batched"

    def __init__(self, spec: "FederatedSpec"):
        self.model = spec.model
        self.fed = spec.fed
        self.data = spec.data
        self.steps = spec.resolved_steps
        self.device = torch.device(spec.device)
        self.keep_client_params = False
        self.set_mu(spec.fed.mu)

    def set_mu(self, mu: float) -> None:
        self._train = fed_batched.make_batched_local_train(
            self.model.loss, lr=self.fed.lr, mu=mu)

    def run_round(self, params, selected, rng, weights=None) -> CohortUpdates:
        stacked = _to_device(fed_batched.gather_stacked_batches(
            self.data, selected, self.steps, self.fed.local_batch, rng), self.device)
        cohort = fed_batched.train_clients_batched(
            self._train, params, stacked, weights=weights,
            chunk=self.fed.client_chunk, keep_client_params=self.keep_client_params)
        return CohortUpdates(
            mean_loss=cohort.mean_loss,
            update_sqnorm=cohort.update_sqnorm,
            avg_params=cohort.avg_params,
            stacked_params=cohort.stacked_params,
            weights=weights,
        )


class SequentialExecutor:
    """One ``local_train`` call per client — the numerical reference."""

    kind = "sequential"

    def __init__(self, spec: "FederatedSpec"):
        self.model = spec.model
        self.fed = spec.fed
        self.data = spec.data
        self.steps = spec.resolved_steps
        self.device = torch.device(spec.device)
        self.mu = spec.fed.mu

    def set_mu(self, mu: float) -> None:
        self.mu = mu

    def run_round(self, params, selected, rng, weights=None) -> CohortUpdates:
        m = len(selected)
        param_list: List[Any] = []
        losses = np.zeros(m, np.float32)
        sqnorms = np.zeros(m, np.float32)
        for i, k in enumerate(selected):
            batches = _to_device(self.data.client_batches(
                int(k), self.steps, self.fed.local_batch, rng), self.device)
            res = fed_client.local_train(self.model.loss, params, batches,
                                         lr=self.fed.lr, mu=self.mu)
            losses[i] = float(res.mean_loss)
            sqnorms[i] = float(res.update_sqnorm)
            param_list.append(res.params)
        return CohortUpdates(mean_loss=losses, update_sqnorm=sqnorms,
                             param_list=param_list, weights=weights)


class CompressedExecutor:
    """Wire-compression decorator around either executor (paper Sec II-B).

    Compresses each client's delta Δ = w_k − w_global with the codec
    (``fed.compression``), decodes it at once (the client→server wire), and
    hands the cohort on in the standard layout, so any aggregator composes
    downstream. Owns the codec state:

      * ``'int8'`` — stateless per-tensor quantization. Over the batched
        schedule it quantizes the (M, ...) client stack in one pass
        (``quantize_int8_stacked``), which needs the stack: chunked
        execution (``client_chunk > 0``) never materializes it and raises.
      * ``'topk'`` — top-k sparsification with error feedback. The
        per-client residuals live here (``residuals``, by client id) on the
        host side, so the codec needs the sequential schedule and raises
        ``ExecutorCompatError`` otherwise.
    """

    def __init__(self, inner: ClientExecutor, codec: str, topk_frac: float = 0.1):
        if codec not in ("int8", "topk"):
            raise ValueError(f"unknown compression codec {codec!r}")
        if codec == "topk" and inner.kind != "sequential":
            raise ExecutorCompatError(
                "compression='topk' keeps per-client host-side error-feedback "
                "residuals and requires the sequential executor; got "
                f"{inner.kind!r}. Pass client_execution='sequential' (or an "
                "explicit SequentialExecutor).")
        if codec == "int8" and inner.kind == "batched":
            if inner.fed.client_chunk:
                raise ExecutorCompatError(
                    "compression='int8' over the batched executor needs the "
                    "full (M, ...) client stack, which chunked execution "
                    "(FedConfig.client_chunk > 0) never materializes; set "
                    "client_chunk=0 or use the sequential executor.")
            inner.keep_client_params = True
        self.inner = inner
        self.kind = inner.kind
        self.codec = codec
        self.topk_frac = topk_frac
        self.residuals: Dict[int, Any] = {}

    def set_mu(self, mu: float) -> None:
        self.inner.set_mu(mu)

    def run_round(self, params, selected, rng, weights=None) -> CohortUpdates:
        cohort = self.inner.run_round(params, selected, rng, weights=weights)
        if cohort.param_list is not None:
            return self._compress_list(params, selected, cohort)
        return self._compress_stacked(params, cohort)

    def _compress_list(self, anchor, selected, cohort: CohortUpdates) -> CohortUpdates:
        wire = raw = 0
        rebuilt: List[Any] = []
        for i, k in enumerate(selected):
            delta = fed_comp.tree_delta(cohort.param_list[i], anchor)
            if self.codec == "int8":
                c, stats = fed_comp.quantize_int8(delta)
                decoded = fed_comp.dequantize_int8(c)
            else:
                c, resid, stats = fed_comp.topk_sparsify(
                    delta, self.topk_frac, self.residuals.get(int(k)))
                self.residuals[int(k)] = resid
                decoded = fed_comp.desparsify(c)
            wire += stats.wire_bytes
            raw += stats.raw_bytes
            rebuilt.append(fed_comp.tree_apply_delta(anchor, decoded))
        return dataclasses.replace(cohort, param_list=rebuilt, wire_bytes=wire,
                                   raw_bytes=raw)

    def _compress_stacked(self, anchor, cohort: CohortUpdates) -> CohortUpdates:
        if cohort.stacked_params is None:
            raise ExecutorCompatError(
                "batched executor returned no client stack to compress "
                "(keep_client_params was not honoured)")
        delta = fed_comp.tree_delta(cohort.stacked_params, anchor)  # broadcasts
        c, stats = fed_comp.quantize_int8_stacked(delta)
        rebuilt = fed_comp.tree_apply_delta(anchor, fed_comp.dequantize_int8_stacked(c))
        avg = fed_server.fedavg_fused(rebuilt, cohort.weights)
        return dataclasses.replace(cohort, avg_params=avg, stacked_params=rebuilt,
                                   wire_bytes=stats.wire_bytes, raw_bytes=stats.raw_bytes)


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

    def get_state(self):
        return self.momentum.velocity

    def set_state(self, state):
        self.momentum.velocity = state


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
    """Prints progress every ``every`` rounds and after the last round.

    The numbers come from an ``obs.MetricsRegistry``, shared with a sibling
    ``TelemetryHook`` when one is attached (``capture_round`` is idempotent
    per round, so whichever hook fires first builds the row), its own
    otherwise: one source of per-round truth."""

    def __init__(self, every: int = 10, registry: Optional[MetricsRegistry] = None):
        self.every = every
        self.registry = registry

    def on_run_start(self, ctx: RoundContext) -> None:
        if self.registry is None:
            shared = next((h.registry for h in ctx.engine.hooks
                           if h is not self
                           and isinstance(getattr(h, "registry", None), MetricsRegistry)),
                          None)
            self.registry = shared or MetricsRegistry()

    def on_round_end(self, ctx: RoundContext) -> None:
        t = ctx.round_idx
        row = self.registry.capture_round(ctx)
        if t % self.every == 0 or t == ctx.fed.rounds - 1:
            eng = ctx.engine
            print(self.registry.format_round(row, selector=eng.selector_name,
                                             metric_name=eng.metric_name), flush=True)


class AdaptiveMuHook(RoundHook):
    """Drives FedProx μ online from Lemma A.4 (``core.adaptive``).

    Retunes after each round from the cohort's observed update norms and
    rebinds the executor's μ only on > 25 % relative moves: regularization
    must change slowly relative to the selection dynamics."""

    def __init__(self, ctl: Optional[AdaptiveMu] = None, retune_threshold: float = 0.25):
        self.ctl = ctl
        self.retune_threshold = retune_threshold
        self.history: List[float] = []
        self._pending_state: Optional[Dict[str, Any]] = None

    def on_run_start(self, ctx: RoundContext) -> None:
        if self.ctl is None:
            fed = ctx.fed
            self.ctl = AdaptiveMu(local_steps=ctx.engine.spec.resolved_steps,
                                  local_lr=fed.lr, mu=fed.mu)
        if self._pending_state is not None:
            self._apply_state(self._pending_state)
            self._pending_state = None

    def on_round_end(self, ctx: RoundContext) -> None:
        new_mu = self.ctl.observe_round(
            ctx.obs_sqnorm[ctx.selected], ctx.fed.rounds - ctx.round_idx)
        self.history.append(new_mu)
        mu_now = ctx.engine.mu
        if abs(new_mu - mu_now) / max(mu_now, 1e-9) > self.retune_threshold:
            ctx.engine.set_mu(new_mu)

    def contribute(self, extras: Dict[str, Any]) -> None:
        if self.history:
            extras["mu_history"] = np.array(self.history)

    def state_dict(self) -> Optional[Dict[str, Any]]:
        out: Dict[str, Any] = {"history": [float(x) for x in self.history]}
        if self.ctl is not None:
            out.update(mu=self.ctl.mu, g_sq=self.ctl._g_sq,
                       b_sq=self.ctl._b_sq, dist_sq=self.ctl._dist_sq)
        return out

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if self.ctl is None:
            self._pending_state = state  # applied once on_run_start builds ctl
        else:
            self._apply_state(state)

    def _apply_state(self, state: Dict[str, Any]) -> None:
        self.history = list(state.get("history", []))
        if "mu" in state:
            self.ctl.mu = state["mu"]
            self.ctl._g_sq = state["g_sq"]
            self.ctl._b_sq = state["b_sq"]
            self.ctl._dist_sq = state["dist_sq"]


class CheckpointHook(RoundHook):
    """Mid-run checkpoint and resume for federated runs (``repro_torch.ckpt``).

    Every ``every`` rounds (and after the last) the engine's ``save`` writes
    the full resumable state: global params, ``ClientState`` (f32 or the
    bf16 ``compact_state`` layout, bitwise, with the int32 ``NEVER``
    sentinel), the default noise generators' states, the host numpy RNG
    state, aggregator state, the other hooks' ``state_dict``, the metric
    series, and whatever the engine declares through its ``extra_state``
    protocol (the async clock with its in-flight updates, the hierarchical
    upload series, edge cohorts and budget controller). A run killed at
    round t and resumed reproduces the uninterrupted run bitwise.

    ``resume=True`` restores the newest readable snapshot at run start: a
    corrupt latest (a truncated write at the preemption) is skipped with a
    warning for the next older one, but a schema or engine mismatch
    (``CheckpointMismatchError``) always re-raises. ``keep_last=N`` prunes
    all but the newest N snapshots after each save. The resumed spec must
    rebuild the same hook list (hook state is keyed by list position), with
    this hook before any ``KillAtRound`` so the save lands ahead of the kill.
    """

    def __init__(self, path: str, every: int = 1, resume: bool = True,
                 keep_last: Optional[int] = None):
        if keep_last is not None and keep_last < 1:
            raise ValueError(f"keep_last must be ≥ 1, got {keep_last}")
        self.path = path
        self.every = max(every, 1)
        self.resume = resume
        self.keep_last = keep_last

    def on_run_start(self, ctx: RoundContext) -> None:
        if not self.resume:
            return
        rounds = torch_ckpt.list_federated_rounds(self.path)
        if not rounds:
            return
        errors = []
        for r in reversed(rounds):
            try:
                ctx.engine.restore(self.path, round_idx=r)
                if errors:
                    warnings.warn(
                        f"CheckpointHook: resumed from round {r} after skipping "
                        f"unreadable snapshot(s): {errors}", RuntimeWarning, stacklevel=2)
                return
            except torch_ckpt.CheckpointMismatchError:
                # A wrong engine, version or schema is a misconfigured
                # resume, not disk corruption: never fall back past it.
                raise
            except Exception as e:  # truncated npz / unparseable json
                errors.append(f"round {r}: {type(e).__name__}: {e}")
        raise RuntimeError(
            f"CheckpointHook: no readable snapshot under {self.path!r} "
            f"out of {len(rounds)} candidate(s): {errors}")

    def on_round_end(self, ctx: RoundContext) -> None:
        t = ctx.round_idx
        if (t + 1) % self.every == 0 or t == ctx.fed.rounds - 1:
            tracer = ctx.engine.tracer
            tc0 = time.perf_counter() if tracer.enabled else 0.0
            ctx.engine.save(self.path)
            if self.keep_last is not None:
                torch_ckpt.prune_federated_rounds(self.path, self.keep_last)
            if tracer.enabled:
                tracer.wall_span("checkpoint_save", tc0, time.perf_counter(),
                                 track="checkpoint", cat="ckpt", args={"round": t})
                # The stream is durable through this save: a preemption right
                # after it must not cut the trace mid-track.
                tracer.flush()


class SimulatedPreemption(RuntimeError):
    """Raised by ``KillAtRound`` to simulate a mid-run kill."""


class KillAtRound(RoundHook):
    """Crash injection: die after round ``t`` like a preempted worker.

    ``phase="round_end"`` (default) raises from ``on_round_end`` of round
    ``t``: list it after ``CheckpointHook`` so the round-``t`` snapshot lands
    first. ``phase="round_start"`` raises at the start of round ``t + 1``
    instead, after the round-``t`` snapshot but once the next round's hooks
    have begun firing."""

    PHASES = ("round_end", "round_start")

    def __init__(self, t: int, phase: str = "round_end"):
        if phase not in self.PHASES:
            raise ValueError(f"phase must be one of {self.PHASES}, got {phase!r}")
        self.t = int(t)
        self.phase = phase

    def _die(self, where: str) -> None:
        raise SimulatedPreemption(
            f"simulated preemption at {where} (KillAtRound(t={self.t}, "
            f"phase={self.phase!r}))")

    def on_round_start(self, ctx: RoundContext) -> None:
        if self.phase == "round_start" and ctx.round_idx == self.t + 1:
            self._die(f"start of round {ctx.round_idx}")

    def on_round_end(self, ctx: RoundContext) -> None:
        if self.phase == "round_end" and ctx.round_idx == self.t:
            self._die(f"end of round {ctx.round_idx}")


@register_hook("metrics")
def _make_metrics(spec: "FederatedSpec") -> MetricsHook:
    return MetricsHook()


@register_hook("verbose")
def _make_verbose(spec: "FederatedSpec") -> VerboseHook:
    return VerboseHook()


@register_hook("adaptive_mu")
def _make_adaptive_mu(spec: "FederatedSpec") -> AdaptiveMuHook:
    return AdaptiveMuHook()


@register_hook("telemetry")
def _make_telemetry(spec: "FederatedSpec") -> RoundHook:
    # Deferred: repro_torch.obs.hook imports this module.
    from repro_torch.obs.hook import TelemetryHook

    return TelemetryHook()


# ---------------------------------------------------------------------------
# Spec + engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FederatedSpec:
    """Declarative description of one federated run.

    ``executor`` / ``aggregator`` / ``hooks`` accept registry names
    (``EXECUTORS`` / ``AGGREGATORS`` / ``HOOKS``) or instances;
    ``executor=None`` defers to ``fed.client_execution``. ``eval_fn(model,
    params, eval_batch) -> float`` replaces ``default_eval``, and
    ``metric_name`` names what it returns ("metric" by default).
    ``noise`` and ``init_params`` supply the draws the reference takes from
    ``jax.random`` (see the module docstring); a hierarchical run takes its
    selection draws from ``edge_noise`` instead (``fed.hierarchy``), and
    ``hier_cfg`` (a ``fed.hierarchy.HierarchyConfig``) holds its partition
    and outer-budget knobs. ``availability`` is a (rounds, K) bool trace of
    the clients online each round (``fed.availability``). ``round_policy``
    ('sync' | 'async', None defers to ``fed.round_policy``) with
    ``async_cfg`` (a ``fed.async_engine.AsyncConfig``) and ``system`` (a
    ``fed.availability.SystemProfile`` or (K,) round-time multipliers)
    choose the asynchronous engine's clock. ``compact_state`` keeps the (K,)
    selection metadata in bf16 (``core.state.to_bf16``). ``device`` defaults
    to ``"cuda"``; on a machine without a card that raises at ``run()``.
    ``compression`` ('int8' | 'topk', keeping ``topk_frac`` of each leaf)
    wraps the executor in a ``CompressedExecutor``: a codec the named
    schedule cannot carry raises ``ExecutorCompatError``, unless the
    schedule was only the config default, which then falls back to the
    sequential executor with a warning.
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
    compression: Optional[str] = None    # None | 'int8' | 'topk'
    topk_frac: float = 0.1
    aggregator: Union[str, Aggregator] = "fedavg"
    hooks: Sequence[Union[str, RoundHook]] = ()
    availability: Optional[np.ndarray] = None  # (rounds, K) bool masks
    verbose: bool = False
    round_policy: Optional[str] = None
    async_cfg: Optional[Any] = None      # fed.async_engine.AsyncConfig
    system: Optional[Any] = None         # SystemProfile | (K,) multipliers
    topology: Optional[str] = None
    device: Union[str, torch.device] = "cuda"
    noise: Optional[NoiseFn] = None
    init_params: Optional[Dict[str, Any]] = None
    hier_cfg: Optional[Any] = None
    edge_noise: Optional[EdgeNoiseFn] = None
    compact_state: bool = False

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
        topo = self.resolved_topology
        if topo == "hierarchical":
            # The hierarchical engine owns both round policies: its unit of
            # cloud arrival is an edge aggregate, not a client update.
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
        if policy == "async":
            from repro_torch.fed.async_engine import AsyncFederatedEngine

            return AsyncFederatedEngine(self)
        if self.async_cfg is not None or self.system is not None:
            # The sync engine has no clock: modelling a homogeneous instant
            # fleet while the config says otherwise would mislead.
            raise ValueError(
                "async_cfg/system are only consumed by round_policy='async'; "
                "the sync engine has no wall clock to apply them to")
        return FederatedEngine(self)


def _codec_schedule_conflict(spec: FederatedSpec, name: str) -> Optional[str]:
    """Why ``spec.compression`` cannot ride the named schedule, or None."""
    if spec.compression is None or name != "batched":
        return None
    if spec.compression == "topk":
        return "compression='topk' keeps per-client host-side residuals"
    if spec.compression == "int8" and spec.fed.client_chunk:
        return ("compression='int8' needs the full (M, ...) client stack, "
                "which chunked execution (client_chunk > 0) never materializes")
    return None


def _resolve_executor(spec: FederatedSpec) -> ClientExecutor:
    ex = spec.executor
    explicit = ex is not None
    if ex is None or isinstance(ex, str):
        name = ex or spec.fed.client_execution
        if name not in EXECUTORS:
            raise ValueError(
                f"client_execution must be one of {sorted(EXECUTORS)}, got {name!r}")
        conflict = _codec_schedule_conflict(spec, name)
        if conflict and not explicit:
            # The schedule was only the config default: fall back, loudly.
            warnings.warn(
                f"{conflict}; falling back to the sequential executor (pass "
                "client_execution='sequential' to silence, or 'batched' to "
                "make this an error)", stacklevel=3)
            name = "sequential"
        ex = EXECUTORS[name](spec)
    if spec.compression is not None:
        # An explicitly requested incompatible pair raises in here.
        ex = CompressedExecutor(ex, spec.compression, spec.topk_frac)
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
    hooks: List[RoundHook] = []
    for h in spec.hooks:
        if isinstance(h, str):
            if h not in HOOKS:
                raise ValueError(f"unknown hook {h!r}; registered: {sorted(HOOKS)}")
            h = HOOKS[h](spec)
        hooks.append(h)
    if spec.verbose and not any(isinstance(h, VerboseHook) for h in hooks):
        hooks.append(VerboseHook())
    # Stable priority order (higher first): telemetry producers run before
    # the hooks that read their registry, wherever the spec listed them.
    hooks.sort(key=lambda h: -getattr(h, "priority", 0))
    # The metrics hook runs first, so every other hook (checkpointing in
    # particular) sees the round's series already appended.
    mh = next((h for h in hooks if isinstance(h, MetricsHook)), None)
    if mh is None:
        mh = MetricsHook()
    else:
        hooks.remove(mh)
    hooks.insert(0, mh)
    return hooks


class FederatedEngine:
    """Algorithm-1 skeleton over pluggable executor / aggregator / hooks.

    One ``run()`` = ``fed.rounds`` rounds of: draw → select → execute →
    aggregate → fold observations into ``ClientState`` → eval → hooks. The
    engine owns the skeleton and the resumable state (params, client state,
    noise generators, host RNG); everything else is a plugin."""

    def __init__(self, spec: FederatedSpec):
        self.spec = spec
        self.executor = _resolve_executor(spec)
        self.aggregator = _resolve_aggregator(spec)
        self.hooks = _resolve_hooks(spec)
        self.metrics = next(h for h in self.hooks if isinstance(h, MetricsHook))

        self.selector_name = spec.resolved_selector
        score_cfg = spec.score_cfg or HeteRoScoreConfig()
        sel_cfg = spec.sel_cfg or SelectorConfig(num_selected=spec.fed.num_selected)
        select = make_selector(self.selector_name, sel_cfg, score_cfg)
        if spec.availability is not None:
            select = fed_avail.mask_selector(select, spec.availability,
                                             num_selected=spec.fed.num_selected)
        self._select = select
        self.eval_fn = spec.eval_fn or default_eval
        self.metric_name = spec.metric_name or (
            "metric" if spec.eval_fn is not None else default_metric_name(spec.model))

        self.mu = spec.fed.mu
        # The telemetry plane (repro_torch.obs): TelemetryHook swaps in a
        # live TraceRecorder at run start; the no-op default makes every
        # instrumentation site one attribute read.
        self.tracer = NULL_TRACER
        # The async engines replace this with their VirtualClock; hooks find
        # it through ``getattr(engine, "clock", None)``.
        self.clock = None
        self.wire_total = 0
        self.raw_total = 0
        self.device: Optional[torch.device] = None
        self.params: Any = None
        self.state: Optional[ClientState] = None
        self.noise: Optional[NoiseFn] = None
        self.rng: Optional[np.random.Generator] = None
        # The default draws' generators by name, checkpointed with the run.
        self.generators: Dict[str, torch.Generator] = {}
        self.start_round = 0
        self._rounds_done = 0

    # -- lifecycle ---------------------------------------------------------

    def set_mu(self, mu: float) -> None:
        """Rebind the FedProx coefficient (``AdaptiveMuHook``)."""
        self.mu = float(mu)
        self.executor.set_mu(self.mu)

    def run(self) -> FLResult:
        self._start()
        ctx = RoundContext(engine=self)
        for h in self.hooks:
            h.on_run_start(ctx)
        eval_batch = _to_device(self.spec.data.eval_batch(), self.device)
        for t in range(self.start_round, self.spec.fed.rounds):
            ctx.round_idx = t
            for h in self.hooks:
                h.on_round_start(ctx)
            self._run_round(ctx, t, eval_batch)
            for h in self.hooks:
                h.on_round_end(ctx)
        extras: Dict[str, Any] = {}
        for h in self.hooks:
            h.on_run_end(ctx)
            h.contribute(extras)
        return self._result(extras)

    def draw_names(self) -> tuple:
        """The names of the draws each round takes: the selector's, and
        ``"remask"`` when the run has an availability trace."""
        names = selector_draws(self.selector_name)
        return names + (("remask",) if self.spec.availability is not None else ())

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
        self.generators = {}
        if spec.noise is not None:
            self.noise = spec.noise
        else:
            noise_gen = torch.Generator(device=dev)
            noise_gen.manual_seed(fed.seed)
            self.generators["noise"] = noise_gen
            names = self.draw_names()
            self.noise = lambda t, k: draw(noise_gen, names, k)
        self.state = init_client_state(spec.data.num_clients, spec.data.label_js,
                                       device=dev)
        if spec.compact_state:
            self.state = to_bf16(self.state)
        self.rng = np.random.default_rng(fed.seed)
        self.start_round = 0
        self._rounds_done = 0
        self.wire_total = 0
        self.raw_total = 0
        self.metrics.reset()  # before the hooks: a resume repopulates these

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
        self.wire_total += cohort.wire_bytes
        self.raw_total += cohort.raw_bytes
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
        ctx.obs_loss = obs_loss
        ctx.obs_sqnorm = obs_sqnorm
        self._eval(ctx, eval_batch)
        self._trace_round(t, ("select", t0, t1, {}),
                          ("execute", t1, t2, {"cohort": int(len(selected))}),
                          ("aggregate", t2, t3, {}))
        ctx.train_loss = float(np.mean(obs_loss[selected])) if len(selected) else 0.0
        ctx.sim_time = float(t + 1)  # sync rounds cost "1" on the time axis
        self._rounds_done = t + 1

    def _eval(self, ctx: RoundContext, eval_batch: Any) -> None:
        """The round's eval metric and its host time (the metric's float()
        waits for the device)."""
        t0 = time.perf_counter()
        ctx.metric = self.eval_fn(self.spec.model, self.params, eval_batch)
        t1 = time.perf_counter()
        ctx.eval_ms = (t1 - t0) * 1e3
        self._eval_span = (t0, t1)

    def _trace_round(self, t: int, *phases) -> None:
        """Record the round's phase spans, then its ``eval`` span, on the
        wall timeline: each phase ``(name, t_start, t_end, args)`` with the
        clock readings its ``*_ms`` was taken from, the round added to its
        args."""
        if not self.tracer.enabled:
            return
        for name, a, b, args in phases:
            self.tracer.wall_span(name, a, b, args={"round": t, **args})
        self.tracer.wall_span("eval", *self._eval_span, args={"round": t})

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
        (the hierarchical engine its ``cloud_uploads``, the async engines
        their ``wall_clock`` and ``round_staleness``)."""
        sel_hist = np.stack(self.metrics.selected)
        return FLResult(
            accuracy=np.array(self.metrics.metric),
            train_loss=np.array(self.metrics.train_loss),
            selection_counts=sel_hist.sum(axis=0),
            selected_history=sel_hist,
            params=self.params,
            wire_bytes=self.wire_total,
            raw_bytes=self.raw_total,
            metric_name=self.metric_name,
            mu_history=extras.get("mu_history"),
            wall_clock=extras.get("wall_clock"),
            round_staleness=extras.get("round_staleness"),
            cloud_uploads=extras.get("cloud_uploads"),
            select_ms=np.asarray(self.metrics.select_ms),
            execute_ms=np.asarray(self.metrics.execute_ms),
            aggregate_ms=np.asarray(self.metrics.aggregate_ms),
            eval_ms=np.asarray(self.metrics.eval_ms),
            serving=extras.get("serving"),
            served_metric=extras.get("served_metric"),
            telemetry=extras.get("telemetry"),
        )

    # -- checkpoint / resume ----------------------------------------------
    #
    # The base engine owns the snapshot layout (versioned and schema-checked,
    # ``repro_torch.ckpt``); subclasses add their per-round state through
    # ``extra_state`` / ``extra_likes`` / ``load_extra_state``. The snapshot
    # records ``snapshot_kind``, so a resume into the wrong engine fails
    # before any leaf loads. Where the reference persists its PRNG key, the
    # port persists the default noise generators' states (tree
    # ``noise_state``); a caller's ``noise`` is a function of the round.

    @property
    def snapshot_kind(self) -> str:
        """Engine identity stamped into (and checked against) snapshots."""
        return "sync/flat"

    def extra_state(self) -> Tuple[Dict[str, Any], Dict[str, Any], Dict[str, Any]]:
        """Subclass hook: extra ``(trees, arrays, meta)`` to persist. Names
        share one namespace with the base snapshot's; the meta is stored
        under ``"extra"`` and handed back to the two methods below."""
        return {}, {}, {}

    def extra_likes(self, meta: Dict[str, Any]) -> Dict[str, Any]:
        """Subclass hook: restore templates for ``extra_state`` trees; gets
        the snapshot's full meta before any array loads."""
        return {}

    def load_extra_state(self, trees: Dict[str, Any], arrays: Dict[str, Any],
                         meta: Dict[str, Any]) -> None:
        """Subclass hook: re-install restored extras into engine fields."""

    def _noise_state(self) -> Dict[str, torch.Tensor]:
        return {name: g.get_state() for name, g in self.generators.items()}

    def save(self, path: str) -> str:
        """Write the full resumable state after the current round."""
        t = self._rounds_done
        trees = {"params": self.params, "client_state": self.state,
                 "noise_state": self._noise_state()}
        agg_state = self.aggregator.get_state()
        if agg_state is not None:
            trees["aggregator_state"] = agg_state
        arrays = {
            "metric": np.asarray(self.metrics.metric, np.float64),
            "train_loss": np.asarray(self.metrics.train_loss, np.float64),
            "selected_history": np.stack(self.metrics.selected).astype(np.uint8),
            "select_ms": np.asarray(self.metrics.select_ms, np.float64),
            "execute_ms": np.asarray(self.metrics.execute_ms, np.float64),
            "aggregate_ms": np.asarray(self.metrics.aggregate_ms, np.float64),
            "eval_ms": np.asarray(self.metrics.eval_ms, np.float64),
        }
        extra_trees, extra_arrays, extra_meta = self.extra_state()
        clash = (set(trees) | {"aggregator_state"}) & set(extra_trees)
        clash |= set(arrays) & set(extra_arrays)
        if clash:
            raise ValueError(f"extra_state name collision: {sorted(clash)}")
        trees.update(extra_trees)
        arrays.update(extra_arrays)
        hook_states = {str(i): s for i, h in enumerate(self.hooks)
                       if (s := h.state_dict()) is not None}
        meta = {
            "round": t,
            "engine": self.snapshot_kind,
            "mu": self.mu,
            "wire_bytes": self.wire_total,
            "raw_bytes": self.raw_total,
            "metric_name": self.metric_name,
            "np_rng_state": self.rng.bit_generator.state,
            "hook_states": hook_states,
            "extra": extra_meta,
        }
        return torch_ckpt.save_federated_round(
            path, round_idx=t, trees=trees, arrays=arrays, meta=meta)

    def restore(self, path: str, round_idx: Optional[int] = None) -> int:
        """Restore a ``save()`` snapshot; returns the round to resume from.

        Called after ``run()`` has drawn the initial state (the restore is
        structure-driven) — ``CheckpointHook`` does this from
        ``on_run_start``. Every schema, dtype and engine-kind disagreement
        raises ``CheckpointMismatchError`` before the engine changes."""
        head = torch_ckpt.read_federated_meta(path, round_idx)
        written_by = head.get("engine")
        if written_by != self.snapshot_kind:
            raise torch_ckpt.CheckpointMismatchError(
                f"snapshot round {head['round']} under {path!r} was written "
                f"by engine {written_by!r}; this engine is "
                f"{self.snapshot_kind!r} — resume with a matching "
                "round_policy/topology configuration")
        agg_like = self.aggregator.get_state()
        if agg_like is None:
            # Momentum velocity shares the params structure but is f32.
            agg_like = {k: v.to(torch.float32) for k, v in self.params.items()}
        likes = {"params": self.params, "client_state": self.state,
                 "noise_state": self._noise_state(), "aggregator_state": agg_like}
        likes.update(self.extra_likes(head))
        trees, arrays, meta = torch_ckpt.restore_federated_round(
            path, likes=likes, round_idx=int(head["round"]),
            optional=("aggregator_state",))
        self.params = trees["params"]
        self.state = trees["client_state"]
        for name, g in self.generators.items():
            g.set_state(trees["noise_state"][name])
        if "aggregator_state" in trees:
            self.aggregator.set_state(trees["aggregator_state"])
        self.rng.bit_generator.state = meta["np_rng_state"]
        self.wire_total = int(meta.get("wire_bytes", 0))
        self.raw_total = int(meta.get("raw_bytes", 0))
        if abs(meta.get("mu", self.mu) - self.mu) > 1e-12:
            self.set_mu(meta["mu"])
        self.metrics.metric = [float(x) for x in arrays["metric"]]
        self.metrics.train_loss = [float(x) for x in arrays["train_loss"]]
        self.metrics.selected = [m.astype(bool) for m in arrays["selected_history"]]
        for name in ("select_ms", "execute_ms", "aggregate_ms", "eval_ms"):
            setattr(self.metrics, name, [float(x) for x in arrays[name]])
        for i_str, s in meta.get("hook_states", {}).items():
            i = int(i_str)
            if i < len(self.hooks):
                self.hooks[i].load_state_dict(s)
        self.load_extra_state(trees, arrays, meta)
        self.start_round = int(meta["round"])
        self._rounds_done = self.start_round
        return self.start_round
