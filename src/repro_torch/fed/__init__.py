"""Federated substrate: partitioning, FedProx clients, batched cohort
execution, update compression, aggregation, the round engines (sync and
async, flat and hierarchical), the virtual clock, availability masks,
checkpoint hooks and the adversarial scenarios."""

from repro_torch.fed.async_engine import (AsyncConfig, AsyncFederatedEngine,
                                          BufferedAggregator, staleness_weights)
from repro_torch.fed.availability import (AvailabilityTrace, SystemProfile,
                                          mask_async_selector, mask_selector)
from repro_torch.fed.batched import (make_batched_local_train,
                                     stack_client_trees, train_clients_batched)
from repro_torch.fed.clock import Completion, LatencyModel, VirtualClock
from repro_torch.fed.engine import (AGGREGATORS, EXECUTORS, HOOKS, AdaptiveMuHook,
                                    Aggregator, BatchedExecutor, CheckpointHook,
                                    ClientExecutor, CohortUpdates, CompressedExecutor,
                                    ExecutorCompatError, FedAvg,
                                    FedAvgM, FederatedEngine, FederatedSpec, FLResult,
                                    KillAtRound, MetricsHook, RoundContext, RoundHook,
                                    SequentialExecutor, SimulatedPreemption,
                                    VerboseHook, WeightedFedAvg, register_aggregator,
                                    register_executor, register_hook)
from repro_torch.fed.hierarchy import (EdgeCohort, HierarchicalEngine,
                                       HierarchyConfig, edge_budgets)
from repro_torch.fed.loop import run_federated
from repro_torch.fed.partition import EdgePartition, partition_edges
from repro_torch.fed.scenarios import (SCENARIOS, BuiltScenario, LabelDriftHook,
                                       ScenarioConfig, make_scenario)

__all__ = [
    "AGGREGATORS", "EXECUTORS", "HOOKS", "AdaptiveMuHook", "Aggregator",
    "AsyncConfig", "AsyncFederatedEngine", "AvailabilityTrace", "BatchedExecutor",
    "BufferedAggregator", "BuiltScenario", "CheckpointHook", "ClientExecutor",
    "CohortUpdates", "Completion", "CompressedExecutor", "EdgeCohort", "EdgePartition",
    "ExecutorCompatError", "FedAvg", "FedAvgM", "FederatedEngine", "FederatedSpec",
    "FLResult", "HierarchicalEngine", "HierarchyConfig", "KillAtRound",
    "LabelDriftHook", "LatencyModel", "MetricsHook", "RoundContext", "RoundHook",
    "SCENARIOS", "ScenarioConfig", "SequentialExecutor", "SimulatedPreemption",
    "SystemProfile", "TelemetryHook", "VerboseHook", "VirtualClock", "WeightedFedAvg",
    "edge_budgets", "make_batched_local_train", "make_scenario", "mask_async_selector",
    "mask_selector", "partition_edges", "register_aggregator", "register_executor",
    "register_hook", "run_federated", "stack_client_trees", "staleness_weights",
    "train_clients_batched",
]


def __getattr__(name):
    # PEP 562: repro_torch.obs.hook imports repro_torch.fed.engine, so an
    # eager import here would be circular whenever obs.hook loads first.
    if name == "TelemetryHook":
        from repro_torch.obs.hook import TelemetryHook

        return TelemetryHook
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
