"""Radio-range link derivation: position traces -> per-round graphs.

A copy of the JAX package's ``repro/mobility/links.py`` (numpy only):
the same traces give identical arrays in both packages.

Turns a ``(R, K, 2)`` position trace into the ``(R, K, K)`` weighted
adjacency stack the consensus layer consumes. Link weight models the
V2V channel coarsely:

* ``binary``    — 1 inside ``radio_range``, 0 outside (unit-disk graph);
* ``quadratic`` — ``1 - (d/range)^2`` clipped to [0, 1]: free-space
  path-loss-shaped quality that fades smoothly toward the range edge,
  with weights below ``min_quality`` dropped (a link that barely closes
  the budget is not worth a model transfer).

The stack is plain numpy (host-side, built once per run); the trainer
moves it to device as the scan's per-round mixing input. Nothing here
guarantees connectivity — partitions are a *feature* of the vehicular
setting, and downstream mixing renormalizes per component
(repro_torch.mobility.mixing).
"""
from __future__ import annotations

import numpy as np

LINK_QUALITIES = ("binary", "quadratic")


def pairwise_distances(positions: np.ndarray) -> np.ndarray:
    """(R, K, 2) positions -> (R, K, K) Euclidean distances."""
    d = positions[:, :, None, :] - positions[:, None, :, :]
    return np.sqrt((d.astype(np.float64) ** 2).sum(-1))


def _check_link_params(radio_range: float, link_quality: str) -> None:
    if radio_range <= 0:
        raise ValueError(f"radio_range must be positive, got {radio_range}")
    if link_quality not in LINK_QUALITIES:
        raise ValueError(f"unknown link_quality {link_quality!r} "
                         f"(choose from {LINK_QUALITIES})")


def _link_weights(d: np.ndarray, radio_range: float, link_quality: str,
                  min_quality: float) -> np.ndarray:
    """Distances -> link weights in [0, 1] (any shape, no diagonal
    handling — callers zero self links). The ONE weight model shared by
    the dense and sparse stack builders."""
    if link_quality == "binary":
        return (d <= radio_range).astype(np.float32)
    w = np.clip(1.0 - (d / radio_range) ** 2, 0.0, 1.0)
    return np.where(w >= min_quality, w, 0.0).astype(np.float32)


def radio_adjacency(positions: np.ndarray, radio_range: float, *,
                    link_quality: str = "binary",
                    min_quality: float = 0.05) -> np.ndarray:
    """(R, K, K) float32 link-weight stack from a position trace.

    Symmetric, zero diagonal, weights in [0, 1]. ``binary`` gives the
    unit-disk graph; ``quadratic`` additionally down-weights marginal
    links so the mixing trusts strong (near) neighbors more.
    """
    _check_link_params(radio_range, link_quality)
    d = pairwise_distances(positions)
    w = _link_weights(d, radio_range, link_quality, min_quality)
    r, k = w.shape[0], w.shape[1]
    w[:, np.arange(k), np.arange(k)] = 0.0
    return w


def sparse_radio_stack(positions: np.ndarray, radio_range: float,
                       degree: int, *, link_quality: str = "binary",
                       min_quality: float = 0.05,
                       mask: np.ndarray | None = None):
    """Top-``degree`` sparse link stack straight from a position trace:
    ``(idx (R, K, D) int32, val (R, K, D) f32)`` — never materializes
    the ``(R, K, K)`` stack (only one round's ``(K, K)`` distances are
    transient), which is the memory step that takes R·K to city scale.

    Each node keeps its ``degree`` NEAREST in-range neighbors (for the
    quadratic model nearest == strongest, so this matches sparsifying
    the dense stack by weight whenever the true degree fits in D).
    Nodes with fewer in-range neighbors zero-pad; isolated nodes get an
    all-zero row (pure self-update downstream). ``mask``: optional
    static ``(K, K)`` 0/1 adjacency intersected per round.
    """
    from repro_torch.core.topology import validate_degree

    r, k = positions.shape[0], positions.shape[1]
    degree = validate_degree(degree, k)
    _check_link_params(radio_range, link_quality)
    m = None if mask is None else np.asarray(mask, np.float32)
    idx = np.zeros((r, k, degree), np.int32)
    val = np.zeros((r, k, degree), np.float32)
    for t in range(r):                       # one (K, K) round at a time
        delta = positions[t, :, None, :] - positions[t, None, :, :]
        d = np.sqrt((delta.astype(np.float64) ** 2).sum(-1))
        w = _link_weights(d, radio_range, link_quality, min_quality)
        np.fill_diagonal(w, 0.0)
        if m is not None:
            w *= m
        # rank live links by distance (-inf kills dead/self/masked)
        score = np.where(w > 0, -d, -np.inf)
        top = np.argpartition(score, -degree, axis=1)[:, -degree:]
        idx[t] = top
        val[t] = np.take_along_axis(w, top, axis=1)
    return idx, val


def degree_stats(adj_stack: np.ndarray) -> dict:
    """Per-round degree summary of a ``(R, K, K)`` adjacency stack —
    the observability needed to pick a sane sparse top-D cap.

    * ``max_degree`` / ``mean_degree`` — (R,) per-round node degrees
      (link count, not weight mass);
    * ``isolated`` — (R,) nodes with degree 0 per round;
    * ``max_degree_overall`` — the smallest D that loses no link in any
      round (a sparse stack with ``degree >= max_degree_overall`` is
      exact).
    """
    up = np.asarray(adj_stack) > 0
    deg = up.sum(axis=2)                                   # (R, K)
    return {
        "max_degree": deg.max(axis=1).astype(np.int64),
        "mean_degree": deg.mean(axis=1).astype(np.float64),
        "isolated": (deg == 0).sum(axis=1).astype(np.int64),
        "max_degree_overall": int(deg.max()) if deg.size else 0,
    }


def handover_stats(adj_stack: np.ndarray) -> dict:
    """Churn summary of a ``(R, K, K)`` adjacency stack.

    * ``links_per_round``   — mean undirected link count;
    * ``handovers``         — total link state flips (up->down or
      down->up) between consecutive rounds, undirected;
    * ``churn_rate``        — handovers / (rounds-1) / possible links:
      the fraction of node pairs whose connectivity changes per round;
    * ``isolated_node_rounds`` — (round, node) pairs with degree 0;
    * ``partitioned_rounds``   — rounds whose graph is disconnected.
    """
    up = np.asarray(adj_stack) > 0
    r, k = up.shape[0], up.shape[1]
    iu = np.triu_indices(k, 1)
    links = up[:, iu[0], iu[1]]                        # (R, K*(K-1)/2)
    flips = int(np.sum(links[1:] != links[:-1])) if r > 1 else 0
    possible = max(links.shape[1], 1)
    return {
        "rounds": r,
        "links_per_round": float(links.sum(1).mean()) if r else 0.0,
        "handovers": flips,
        "churn_rate": flips / max(r - 1, 1) / possible,
        "isolated_node_rounds": int((~up.any(axis=2)).sum()),
        "partitioned_rounds": int(sum(num_components(up[t]) > 1
                                      for t in range(r))),
    }


def num_components(adj: np.ndarray) -> int:
    """Connected components of one (K, K) adjacency (union-find)."""
    k = adj.shape[0]
    parent = list(range(k))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(k):
        for j in range(i + 1, k):
            if adj[i, j] > 0:
                parent[find(i)] = find(j)
    return len({find(i) for i in range(k)})
