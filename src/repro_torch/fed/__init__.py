"""Federated substrate: partitioning, FedProx clients, batched cohort
execution, aggregation, and the sync round engines (flat and hierarchical)."""

from repro_torch.fed.batched import (make_batched_local_train,
                                     stack_client_trees, train_clients_batched)
from repro_torch.fed.engine import (AGGREGATORS, EXECUTORS, Aggregator,
                                    BatchedExecutor, CohortUpdates, FedAvg,
                                    FedAvgM, FederatedEngine, FederatedSpec, FLResult,
                                    MetricsHook, RoundContext, RoundHook,
                                    SequentialExecutor, VerboseHook,
                                    WeightedFedAvg, register_aggregator,
                                    register_executor)
from repro_torch.fed.hierarchy import (EdgeCohort, HierarchicalEngine,
                                       HierarchyConfig, edge_budgets)
from repro_torch.fed.loop import run_federated
from repro_torch.fed.partition import EdgePartition, partition_edges

__all__ = [
    "AGGREGATORS", "EXECUTORS", "Aggregator", "BatchedExecutor",
    "CohortUpdates", "EdgeCohort", "EdgePartition", "FedAvg", "FedAvgM",
    "FederatedEngine",
    "FederatedSpec", "FLResult", "HierarchicalEngine", "HierarchyConfig",
    "MetricsHook", "RoundContext", "RoundHook", "SequentialExecutor",
    "VerboseHook", "WeightedFedAvg", "edge_budgets", "make_batched_local_train",
    "partition_edges", "register_aggregator", "register_executor",
    "run_federated", "stack_client_trees", "train_clients_batched",
]
