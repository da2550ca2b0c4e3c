"""Dirichlet label-skew partitioning + distribution divergence (paper Sec IV),
and the client → edge grouping of the hierarchical topology.

numpy code, the same as ``repro.fed.partition`` (the port keeps its own copy
so that it imports nothing of the JAX package). ``js_divergence(P_k, P_avg)``
feeds the diversity score D_k(t) (Eq 4).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


def dirichlet_proportions(
    rng: np.random.Generator, num_clients: int, num_classes: int, alpha: float
) -> np.ndarray:
    """(K, C) row-stochastic client label distributions ~ Dir(α)."""
    return rng.dirichlet(np.full(num_classes, alpha), size=num_clients)


def dirichlet_partition(
    labels: np.ndarray,
    num_clients: int,
    alpha: float,
    seed: int = 0,
    min_per_client: int = 8,
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Partition sample indices by Dirichlet label skew.

    Returns (per-client index arrays, (K, C) empirical label distributions).
    Re-draws until every client has ≥ min_per_client samples.
    """
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    num_classes = len(classes)
    for _ in range(100):
        props = dirichlet_proportions(rng, num_clients, num_classes, alpha)
        client_idx: List[List[int]] = [[] for _ in range(num_clients)]
        for ci, c in enumerate(classes):
            idx = np.flatnonzero(labels == c)
            rng.shuffle(idx)
            # proportional split of this class across clients
            w = props[:, ci] / max(props[:, ci].sum(), 1e-12)
            counts = np.floor(w * len(idx)).astype(int)
            counts[-1] = len(idx) - counts[:-1].sum()
            start = 0
            for k in range(num_clients):
                client_idx[k].extend(idx[start : start + counts[k]])
                start += counts[k]
        sizes = np.array([len(ix) for ix in client_idx])
        if sizes.min() >= min_per_client:
            break
    out = [np.array(sorted(ix), dtype=np.int64) for ix in client_idx]
    dists = np.zeros((num_clients, num_classes))
    for k, ix in enumerate(out):
        if len(ix):
            binc = np.bincount(labels[ix].astype(int), minlength=num_classes)
            dists[k] = binc / binc.sum()
    return out, dists


def js_divergence(p: np.ndarray, q: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """Jensen–Shannon divergence (base e, ∈ [0, log 2]). Broadcasts over rows."""
    p = np.asarray(p, dtype=np.float64) + eps
    q = np.asarray(q, dtype=np.float64) + eps
    p = p / p.sum(axis=-1, keepdims=True)
    q = q / q.sum(axis=-1, keepdims=True)
    m = 0.5 * (p + q)
    kl_pm = np.sum(p * np.log(p / m), axis=-1)
    kl_qm = np.sum(q * np.log(q / m), axis=-1)
    return 0.5 * (kl_pm + kl_qm)


def client_label_js(dists: np.ndarray) -> np.ndarray:
    """JS(P_k || P_avg) for every client — the D_k(t) static factor."""
    avg = dists.mean(axis=0, keepdims=True)
    return js_divergence(dists, avg)


# ---------------------------------------------------------------------------
# Edge grouping for the hierarchical topology (fed.hierarchy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EdgePartition:
    """Static client → edge assignment for hierarchical federation.

    Invariants (checked on construction): every client belongs to exactly
    one edge, every edge id is in ``[0, edge_count)``, and every edge is
    non-empty.
    """

    assignment: np.ndarray  # (K,) int32 — edge id of each client
    edge_count: int

    def __post_init__(self):
        a = np.asarray(self.assignment)
        if a.ndim != 1:
            raise ValueError("edge assignment must be a (K,) vector")
        if self.edge_count < 1 or self.edge_count > len(a):
            raise ValueError(
                f"edge_count must be in [1, K={len(a)}], got {self.edge_count}")
        if a.min() < 0 or a.max() >= self.edge_count:
            raise ValueError("edge ids must lie in [0, edge_count)")
        if len(np.unique(a)) != self.edge_count:
            raise ValueError("every edge must own at least one client")

    @property
    def num_clients(self) -> int:
        return len(self.assignment)

    @property
    def sizes(self) -> np.ndarray:
        """(E,) number of clients per edge."""
        return np.bincount(self.assignment, minlength=self.edge_count)

    def members(self, edge: int) -> np.ndarray:
        """Sorted client ids belonging to ``edge``."""
        return np.flatnonzero(self.assignment == edge)

    def member_lists(self) -> List[np.ndarray]:
        return [self.members(e) for e in range(self.edge_count)]


def partition_edges(
    label_js: np.ndarray,
    edge_count: int,
    mode: str = "similarity",
    seed: int = 0,
) -> EdgePartition:
    """Group K clients into ``edge_count`` edges of near-equal size.

    mode='similarity' sorts clients by their label-skew divergence
    JS(P_k || P_avg) (stable argsort) and cuts the sorted order into
    contiguous blocks, so clients with similar skew share an edge.
    mode='random' assigns a seeded uniform permutation to blocks instead.
    Block sizes differ by at most one (``np.array_split``).
    """
    js = np.asarray(label_js)
    k = len(js)
    if not 1 <= edge_count <= k:
        raise ValueError(f"edge_count must be in [1, K={k}], got {edge_count}")
    if mode == "similarity":
        order = np.argsort(js, kind="stable")
    elif mode == "random":
        order = np.random.default_rng(seed).permutation(k)
    else:
        raise ValueError(
            f"partition mode must be 'similarity' or 'random', got {mode!r}")
    assignment = np.empty(k, np.int32)
    for e, block in enumerate(np.array_split(order, edge_count)):
        assignment[block] = e
    return EdgePartition(assignment=assignment, edge_count=edge_count)
