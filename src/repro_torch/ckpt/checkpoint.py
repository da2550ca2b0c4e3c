"""Checkpointing without external deps: flattened-keypath ``.npz`` shards.

Counterpart of ``repro.ckpt.checkpoint``, with the same on-disk layout, so
either package reads the other's files. Two layers:

  * ``save_checkpoint`` / ``restore_checkpoint`` — params-only snapshots
    with a free-form ``meta_<step>.json`` (final-model export, serving).
  * ``save_federated_round`` / ``restore_federated_round`` — the full
    resumable state of a federated run: named trees (global params,
    ``ClientState``, the noise generators' states, aggregator state, pending
    in-flight deltas) plus raw metric arrays and a JSON meta carrying the
    host numpy RNG state, the virtual clock, and engine-specific extras.
    ``fed.engine.CheckpointHook`` round-trips this, so a run killed at round
    t and resumed matches the uninterrupted run bitwise.

A tree is a nest of dicts (keys in sorted order, as JAX flattens them),
lists or tuples, and dataclasses (fields in declaration order), with torch
tensors or numpy arrays at the leaves; ``None`` holds no leaf. Keypaths are
encoded unambiguously — ``d:`` dict key, ``s:`` sequence index, ``a:``
dataclass attribute, ``f:`` flattened index — so a dict key ``"0"`` and a
sequence index ``0`` never collide. Federated snapshots are versioned
(``FORMAT_VERSION``) and schema-checked: the JSON meta records every tree's
keypaths and true dtypes, and a restore that disagrees on version, tree
set, keypath, dtype or shape raises ``CheckpointMismatchError``. bfloat16
leaves are stored as their uint16 bit patterns (``np.savez`` has no
bfloat16), through a torch bit view, so they round-trip bitwise, as do NaN
payloads, ±0 and ±inf of every float leaf.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# The reference's snapshot layout version; restore refuses any other.
FORMAT_VERSION = 3


class CheckpointMismatchError(ValueError):
    """Snapshot disagrees with what the restoring engine expects.

    Raised on format-version, engine-kind, tree-set, keypath, dtype or shape
    mismatches. Distinct from I/O-level corruption (truncated npz,
    unparseable JSON): a mismatch is a misconfigured resume, which
    ``CheckpointHook`` never papers over by falling back to an older
    snapshot, while corruption falls back (loudly).
    """


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def _is_leaf(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, int, float, bool))


def _flatten_with_path(tree: Any, path: Tuple[str, ...] = ()):
    """(keypath segments, leaf) pairs in JAX's flattening order."""
    if tree is None:
        return
    if _is_leaf(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_path(tree[k], path + (f"d:{k}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_path(v, path + (f"s:{i}",))
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _flatten_with_path(getattr(tree, f.name), path + (f"a:{f.name}",))
    else:
        raise TypeError(f"cannot checkpoint a leaf of type {type(tree).__name__}")


def _key(path: Tuple[str, ...]) -> str:
    return "/".join(path)


def _unflatten(like: Any, leaves: Dict[str, Any], path: Tuple[str, ...] = ()) -> Any:
    """``like``'s structure with each leaf replaced by ``leaves[keypath]``."""
    if like is None:
        return None
    if _is_leaf(like):
        return leaves[_key(path)]
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, path + (f"d:{k}",)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [_unflatten(v, leaves, path + (f"s:{i}",)) for i, v in enumerate(like)]
        return out if isinstance(like, list) else type(like)(out)
    return type(like)(**{f.name: _unflatten(getattr(like, f.name), leaves,
                                            path + (f"a:{f.name}",))
                         for f in dataclasses.fields(like)})


def _dtype_name(leaf: Any) -> str:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16"
        return torch.empty(0, dtype=leaf.dtype).numpy().dtype.name
    return np.asarray(leaf).dtype.name


def _encode(leaf: Any) -> Tuple[np.ndarray, str]:
    """(storable array, true dtype name). bf16 → its uint16 bit pattern."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), _dtype_name(t)
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":   # an ml_dtypes array from a caller
        return arr.view(np.uint16), "bfloat16"
    return arr, arr.dtype.name


def _decode(arr: np.ndarray, dtype_name: str):
    """Invert ``_encode``: a bitwise view, never a value-converting cast.
    bf16 comes back as a torch tensor, every other dtype as numpy."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return arr


def _materialize(stored: np.ndarray, dtype_name: str, like: Any):
    """The stored leaf in the template's kind: a tensor on the template's
    device, or a numpy array."""
    if isinstance(like, torch.Tensor):
        value = _decode(stored, dtype_name)
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.array(value))
        return value.to(like.device)
    if dtype_name == "bfloat16":
        return _decode(stored, dtype_name)
    return np.array(stored)


def _flatten(tree: Any) -> Dict[str, Any]:
    return {_key(p): leaf for p, leaf in _flatten_with_path(tree)}


# ---------------------------------------------------------------------------
# Params-only checkpoints
# ---------------------------------------------------------------------------


def save_checkpoint(path: str, params: Any, *, step: int = 0,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, f"ckpt_{step:08d}.npz")
    np.savez(fname, **{k: _encode(v)[0] for k, v in _flatten(params).items()})
    meta = {"step": step, **(extra or {})}
    with open(os.path.join(path, f"meta_{step:08d}.json"), "w") as f:
        json.dump(meta, f)
    return fname


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(m.group(1)) for f in os.listdir(path)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def restore_checkpoint(path: str, like: Any, step: Optional[int] = None
                       ) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of ``like`` (same keypaths required); each
    leaf takes the template's dtype (bf16 from its bit pattern)."""
    step = latest_step(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    data = np.load(os.path.join(path, f"ckpt_{step:08d}.npz"))
    flat_like = _flatten(like)
    missing = set(flat_like) - set(data.files)
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")
    leaves = {}
    for key, leaf in flat_like.items():
        arr = data[key]
        if _dtype_name(leaf) == "bfloat16":
            value = _decode(arr, "bfloat16")
        elif isinstance(leaf, torch.Tensor):
            value = torch.from_numpy(np.array(arr)).to(leaf.dtype)
        else:
            value = np.asarray(arr, dtype=np.asarray(leaf).dtype)
        leaves[key] = value.to(leaf.device) if isinstance(leaf, torch.Tensor) else value
    with open(os.path.join(path, f"meta_{step:08d}.json")) as f:
        meta = json.load(f)
    return _unflatten(like, leaves), meta


# ---------------------------------------------------------------------------
# Federated round-state checkpoints (fed.engine.CheckpointHook)
# ---------------------------------------------------------------------------


def save_federated_round(path: str, *, round_idx: int, trees: Dict[str, Any],
                         arrays: Dict[str, Any], meta: Dict[str, Any]) -> str:
    """Write one versioned, schema-checked federated-round snapshot.

    ``trees`` are restored structure-driven (a ``like`` template is required
    at restore); ``arrays`` are raw arrays returned as they are (metric
    series whose length depends on the round). ``meta`` must be
    JSON-serializable. The JSON sidecar records ``FORMAT_VERSION`` and the
    full schema (every tree's keypaths and true dtypes, every array's dtype).
    """
    os.makedirs(path, exist_ok=True)
    flat: Dict[str, np.ndarray] = {}
    schema_trees: Dict[str, Dict[str, str]] = {}
    for name, tree in trees.items():
        schema_trees[name] = {}
        for key, leaf in _flatten(tree).items():
            stored, dtype_name = _encode(leaf)
            flat[f"tree:{name}/{key}"] = stored
            schema_trees[name][key] = dtype_name
    schema_arrays: Dict[str, str] = {}
    for name, arr in arrays.items():
        stored, dtype_name = _encode(arr)
        flat[f"array:{name}"] = stored
        schema_arrays[name] = dtype_name
    fname = os.path.join(path, f"fedround_{round_idx:08d}.npz")
    np.savez(fname, **flat)
    payload = {
        "format_version": FORMAT_VERSION,
        "round": round_idx,
        "schema": {"trees": schema_trees, "arrays": schema_arrays},
        **meta,
    }
    with open(os.path.join(path, f"fedround_{round_idx:08d}.json"), "w") as f:
        json.dump(payload, f)
    return fname


def list_federated_rounds(path: str) -> List[int]:
    """All snapshot rounds under ``path``, ascending (empty if none)."""
    if not os.path.isdir(path):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(path)
                  if (m := re.match(r"fedround_(\d+)\.npz$", f)))


def latest_federated_round(path: str) -> Optional[int]:
    rounds = list_federated_rounds(path)
    return rounds[-1] if rounds else None


def prune_federated_rounds(path: str, keep_last: int) -> List[int]:
    """Delete all but the newest ``keep_last`` snapshots; returns removed."""
    if keep_last < 1:
        raise ValueError(f"keep_last must be ≥ 1, got {keep_last}")
    stale = list_federated_rounds(path)[:-keep_last]
    for r in stale:
        for suffix in ("npz", "json"):
            fp = os.path.join(path, f"fedround_{r:08d}.{suffix}")
            if os.path.exists(fp):
                os.remove(fp)
    return stale


def read_federated_meta(path: str, round_idx: Optional[int] = None) -> Dict[str, Any]:
    """Load (and version-check) a snapshot's JSON meta without its arrays.

    Engines read this first to learn how many in-flight deltas the snapshot
    carries (the restore templates depend on it).
    """
    round_idx = latest_federated_round(path) if round_idx is None else round_idx
    if round_idx is None:
        raise FileNotFoundError(f"no federated checkpoint under {path}")
    with open(os.path.join(path, f"fedround_{round_idx:08d}.json")) as f:
        meta = json.load(f)
    version = meta.get("format_version")
    if version != FORMAT_VERSION:
        raise CheckpointMismatchError(
            f"federated checkpoint {path} round {round_idx} has format "
            f"version {version!r}; this build reads only version "
            f"{FORMAT_VERSION} — re-run from scratch or restore with a "
            "matching build (no silent cross-version restore)")
    return meta


def restore_federated_round(
    path: str, *, likes: Dict[str, Any], round_idx: Optional[int] = None,
    optional: Tuple[str, ...] = (), subset: bool = False,
) -> Tuple[Dict[str, Any], Dict[str, Any], Dict[str, Any]]:
    """Restore a ``save_federated_round`` snapshot, schema-checked.

    ``likes`` maps tree name → template tree (same keypaths and dtypes as at
    save time); restored leaves take the template's kind (a tensor on its
    device, or numpy). Names in ``optional`` are skipped when absent from
    the snapshot. Unknown snapshot trees, missing or extra keypaths, dtype
    and shape disagreements raise ``CheckpointMismatchError`` before the
    engine is touched. ``subset=True`` relaxes only the unknown-tree check.
    Returns ``(trees, arrays, meta)``; arrays come back as numpy, bf16 ones
    as torch tensors.
    """
    round_idx = latest_federated_round(path) if round_idx is None else round_idx
    meta = read_federated_meta(path, round_idx)
    schema = meta["schema"]
    unknown = sorted(set(schema["trees"]) - set(likes))
    if unknown and not subset:
        raise CheckpointMismatchError(
            f"snapshot round {round_idx} carries trees the restoring engine "
            f"did not ask for: {unknown} — engine/snapshot mismatch "
            "(was the checkpoint written by a different run configuration?)")

    data = np.load(os.path.join(path, f"fedround_{round_idx:08d}.npz"))
    trees: Dict[str, Any] = {}
    for name, like in likes.items():
        if name not in schema["trees"]:
            if name in optional:
                continue
            raise CheckpointMismatchError(
                f"snapshot round {round_idx} is missing required tree "
                f"{name!r} (has: {sorted(schema['trees'])})")
        recorded = schema["trees"][name]
        want = _flatten(like)
        missing = sorted(set(recorded) - set(want))
        extra = sorted(set(want) - set(recorded))
        if missing or extra:
            raise CheckpointMismatchError(
                f"tree {name!r} keypaths disagree with snapshot round "
                f"{round_idx}: missing from template {missing[:5]}, "
                f"unknown to snapshot {extra[:5]}")
        leaves = {}
        for key, leaf in want.items():
            if recorded[key] != _dtype_name(leaf):
                raise CheckpointMismatchError(
                    f"tree {name!r} leaf {key!r}: snapshot dtype "
                    f"{recorded[key]} != template dtype {_dtype_name(leaf)} "
                    "(e.g. a compact_state=True/False flip between save and resume)")
            stored = data[f"tree:{name}/{key}"]
            if tuple(stored.shape) != tuple(np.shape(leaf)):
                raise CheckpointMismatchError(
                    f"tree {name!r} leaf {key!r}: snapshot shape "
                    f"{tuple(stored.shape)} != template shape "
                    f"{tuple(np.shape(leaf))} (was the checkpoint written "
                    "by a different architecture/config?)")
            leaves[key] = _materialize(stored, recorded[key], leaf)
        trees[name] = _unflatten(like, leaves)
    arrays = {name: _decode(data[f"array:{name}"], dtype_name)
              for name, dtype_name in schema["arrays"].items()}
    return trees, arrays, meta
