"""Checkpointing: flattened-keypath npz save/restore, plus the versioned,
schema-checked federated round-state snapshots ``fed.engine.CheckpointHook``
uses for mid-run resume (counterpart of ``repro.ckpt``, same file layout)."""

from repro_torch.ckpt.checkpoint import (
    FORMAT_VERSION,
    CheckpointMismatchError,
    latest_federated_round,
    latest_step,
    list_federated_rounds,
    prune_federated_rounds,
    read_federated_meta,
    restore_checkpoint,
    restore_federated_round,
    save_checkpoint,
    save_federated_round,
)

__all__ = [
    "FORMAT_VERSION",
    "CheckpointMismatchError",
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "save_federated_round",
    "restore_federated_round",
    "latest_federated_round",
    "list_federated_rounds",
    "prune_federated_rounds",
    "read_federated_meta",
]
