"""Federated substrate: partitioning, FedProx clients, batched cohort
execution, aggregation and the sync/flat round engine."""

from repro_torch.fed.batched import (make_batched_local_train,
                                     stack_client_trees, train_clients_batched)
from repro_torch.fed.engine import (AGGREGATORS, EXECUTORS, Aggregator,
                                    BatchedExecutor, CohortUpdates, FedAvg,
                                    FederatedEngine, FederatedSpec, FLResult,
                                    MetricsHook, RoundContext, RoundHook,
                                    SequentialExecutor, VerboseHook,
                                    register_aggregator, register_executor)
from repro_torch.fed.loop import run_federated

__all__ = [
    "AGGREGATORS", "EXECUTORS", "Aggregator", "BatchedExecutor",
    "CohortUpdates", "FedAvg", "FederatedEngine", "FederatedSpec", "FLResult",
    "MetricsHook", "RoundContext", "RoundHook", "SequentialExecutor",
    "VerboseHook", "make_batched_local_train", "register_aggregator",
    "register_executor", "run_federated",
    "stack_client_trees", "train_clients_batched",
]
