"""Mobility-driven cluster assignment: per-round ``(R, K)`` stacks.

A copy of the JAX package's ``repro/hierarchy/clustering.py`` (numpy only):
the same inputs give identical arrays in both packages.

A cluster is a radio-connected group of vehicles that runs DENSE
intra-cluster consensus with a cluster-local gamma (see
``repro_torch.hierarchy.mixing``). Assignments are compiled ONCE per run from
the kinematic trace — the same host-side "compile the whole schedule,
then scan" pattern as the mobility eta stacks and the fault plans — and
ride the round scan as an ``(R, K)`` int32 stack.

Construction per round:

1. connected components of the thresholded radio adjacency (the same
   union-find as ``repro_torch.mobility.links.num_components``, here keeping
   the labels instead of just counting roots);
2. components larger than ``max_cluster_size`` are split recursively by
   farthest-point bisection on vehicle positions (two seed vehicles at
   maximum separation, every member joins the nearer seed) — without
   positions the split degrades to deterministic index halving;
3. hysteresis: a vehicle whose fresh assignment differs from last
   round's keeps its OLD crowd while it still hears at least one old
   co-member over the radio (it adopts whatever fresh label the
   majority of those heard co-members got). Clusters pushed over
   capacity by sticky members evict the stickiest-farthest ones back
   to their fresh label. This keeps boundary vehicles from thrashing
   between two clusters on alternate rounds.

Labels are canonicalized to ``0..C-1`` in order of first appearance per
round, so downstream code may use them directly as segment ids.
"""
from __future__ import annotations

import numpy as np

__all__ = ["cluster_stack", "cluster_round", "remerge_flags",
           "component_labels"]


def component_labels(adj: np.ndarray) -> np.ndarray:
    """(K, K) adjacency -> (K,) connected-component labels (root ids).

    The same union-find (path halving) as
    ``repro_torch.mobility.links.num_components``, returning each node's root
    instead of the root count."""
    a = np.asarray(adj)
    k = a.shape[0]
    parent = np.arange(k)

    def find(i: int) -> int:
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    ii, jj = np.nonzero(a > 0)
    for i, j in zip(ii, jj):
        if i < j:
            ri, rj = find(i), find(j)
            if ri != rj:
                parent[ri] = rj
    return np.array([find(i) for i in range(k)])


def _split_oversized(members: np.ndarray, pos: np.ndarray | None,
                     max_size: int) -> list[np.ndarray]:
    """Recursively bisect a member list until every part fits.

    Farthest-point seeding on positions: the two members at maximum
    pairwise distance seed the halves and everyone joins the nearer
    seed. Degenerate geometry (coincident positions — zero spread) and
    the position-free case fall back to index halving, which always
    makes progress."""
    if members.size <= max_size:
        return [members]
    halves = None
    if pos is not None:
        p = pos[members]
        d = np.linalg.norm(p[:, None, :] - p[None, :, :], axis=-1)
        i0, j0 = np.unravel_index(np.argmax(d), d.shape)
        if d[i0, j0] > 0:
            nearer = d[:, i0] <= d[:, j0]
            a, b = members[nearer], members[~nearer]
            if a.size and b.size:
                halves = (a, b)
    if halves is None:
        mid = members.size // 2
        halves = (members[:mid], members[mid:])
    return (_split_oversized(halves[0], pos, max_size)
            + _split_oversized(halves[1], pos, max_size))


def _partition(adj: np.ndarray, pos: np.ndarray | None,
               max_size: int) -> np.ndarray:
    """One round's fresh partition: components, then capacity splits."""
    labels = component_labels(adj)
    out = np.empty(labels.shape[0], dtype=np.int64)
    nxt = 0
    for root in np.unique(labels):
        members = np.flatnonzero(labels == root)
        for part in _split_oversized(members, pos, max_size):
            out[part] = nxt
            nxt += 1
    return out


def _canonicalize(labels: np.ndarray) -> np.ndarray:
    """Relabel to 0..C-1 in order of first appearance (deterministic)."""
    seen: dict[int, int] = {}
    out = np.empty_like(labels)
    for i, lab in enumerate(labels):
        if lab not in seen:
            seen[lab] = len(seen)
        out[i] = seen[lab]
    return out


def cluster_round(adj: np.ndarray, pos: np.ndarray | None,
                  prev: np.ndarray | None, max_size: int,
                  hysteresis: bool = True) -> np.ndarray:
    """One round's cluster assignment (K,) int — fresh partition plus
    the sticky-membership hysteresis described in the module docstring.
    ``prev`` is last round's (canonical) assignment or None."""
    raw = _partition(adj, pos, max_size)
    if prev is None or not hysteresis:
        return _canonicalize(raw)
    k = raw.shape[0]
    out = raw.copy()
    sticky = np.zeros(k, dtype=bool)
    for n in range(k):
        mates = np.flatnonzero((prev == prev[n]) & (np.arange(k) != n))
        heard = mates[np.asarray(adj[n, mates]) > 0]
        if heard.size == 0:
            continue
        # join the fresh cluster the majority of heard old mates landed
        # in; ties break toward the smallest label (np.bincount argmax)
        target = int(np.bincount(raw[heard]).argmax())
        if target != raw[n]:
            out[n] = target
            sticky[n] = True
    # capacity repair: clusters pushed over max_size by sticky members
    # evict sticky members (index order — deterministic) back to their
    # fresh label until they fit
    for lab in np.unique(out):
        members = np.flatnonzero(out == lab)
        excess = members.size - max_size
        if excess <= 0:
            continue
        movable = members[sticky[members]][::-1]
        for n in movable[:excess]:
            out[n] = raw[n]
    return _canonicalize(out)


def cluster_stack(adj_stack: np.ndarray,
                  positions: np.ndarray | None = None,
                  *, max_cluster_size: int,
                  hysteresis: bool = True) -> np.ndarray:
    """(R, K, K) adjacency stack -> (R, K) int32 cluster assignments.

    ``positions`` is the (R, K, 2) kinematic trace driving proximity
    splits (None: index splits). Hysteresis chains round to round, so —
    like the mobility traces and fault plans — resumed segments must
    compute the stack from round 0 and slice, never restart it mid-run
    (``repro_torch.hierarchy.mixing.hier_scenario_stacks`` does exactly that).
    """
    adj_stack = np.asarray(adj_stack)
    rounds = adj_stack.shape[0]
    out = np.empty(adj_stack.shape[:2], dtype=np.int32)
    prev = None
    for t in range(rounds):
        pos_t = None if positions is None else np.asarray(positions[t])
        prev = cluster_round(adj_stack[t], pos_t, prev,
                             max_cluster_size, hysteresis)
        out[t] = prev
    return out


def remerge_flags(cluster: np.ndarray) -> np.ndarray:
    """(R, K) assignments -> (R,) f32 re-merge flags.

    Round t is flagged 1.0 when the fleet has FEWER clusters than round
    t-1 — previously partitioned groups rejoined radio contact. The
    flag triggers the post-partition consensus burst (extra
    intra-cluster passes) in ``repro_torch.hierarchy.mixing.hier_mix_flat``,
    the scan-resident form of ``consensus.simulate_rounds`` catch-up."""
    counts = np.array([np.unique(c).size for c in np.asarray(cluster)])
    flags = np.zeros(counts.shape[0], dtype=np.float32)
    if counts.shape[0] > 1:
        flags[1:] = (counts[1:] < counts[:-1]).astype(np.float32)
    return flags
