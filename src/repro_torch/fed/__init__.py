"""Federated substrate: partitioning, FedProx clients, batched cohort
execution, aggregation, the round engines (sync and async, flat and
hierarchical), the virtual clock, availability masks and checkpoint hooks."""

from repro_torch.fed.async_engine import (AsyncConfig, AsyncFederatedEngine,
                                          BufferedAggregator, staleness_weights)
from repro_torch.fed.availability import (AvailabilityTrace, SystemProfile,
                                          mask_async_selector, mask_selector)
from repro_torch.fed.batched import (make_batched_local_train,
                                     stack_client_trees, train_clients_batched)
from repro_torch.fed.clock import Completion, LatencyModel, VirtualClock
from repro_torch.fed.engine import (AGGREGATORS, EXECUTORS, HOOKS, AdaptiveMuHook,
                                    Aggregator, BatchedExecutor, CheckpointHook,
                                    CohortUpdates, ExecutorCompatError, FedAvg,
                                    FedAvgM, FederatedEngine, FederatedSpec, FLResult,
                                    KillAtRound, MetricsHook, RoundContext, RoundHook,
                                    SequentialExecutor, SimulatedPreemption,
                                    VerboseHook, WeightedFedAvg, register_aggregator,
                                    register_executor, register_hook)
from repro_torch.fed.hierarchy import (EdgeCohort, HierarchicalEngine,
                                       HierarchyConfig, edge_budgets)
from repro_torch.fed.loop import run_federated
from repro_torch.fed.partition import EdgePartition, partition_edges

__all__ = [
    "AGGREGATORS", "EXECUTORS", "HOOKS", "AdaptiveMuHook", "Aggregator",
    "AsyncConfig", "AsyncFederatedEngine", "AvailabilityTrace", "BatchedExecutor",
    "BufferedAggregator", "CheckpointHook", "CohortUpdates", "Completion",
    "EdgeCohort", "EdgePartition", "ExecutorCompatError", "FedAvg", "FedAvgM",
    "FederatedEngine", "FederatedSpec", "FLResult", "HierarchicalEngine",
    "HierarchyConfig", "KillAtRound", "LatencyModel", "MetricsHook", "RoundContext",
    "RoundHook", "SequentialExecutor", "SimulatedPreemption", "SystemProfile",
    "VerboseHook", "VirtualClock", "WeightedFedAvg", "edge_budgets",
    "make_batched_local_train", "mask_async_selector", "mask_selector",
    "partition_edges", "register_aggregator", "register_executor", "register_hook",
    "run_federated", "stack_client_trees", "staleness_weights", "train_clients_batched",
]
