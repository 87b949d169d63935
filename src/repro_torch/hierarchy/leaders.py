"""Leader election for hierarchical consensus (Mobility-Aware DFL,

A copy of the JAX package's ``repro/hierarchy/leaders.py`` (numpy only):
the same inputs give identical arrays in both packages.
arXiv 2503.06443).

Each cluster elects ONE leader per round; leaders run the sparse
inter-cluster tier (``repro_torch.hierarchy.mixing``) while everyone runs the
dense intra-cluster tier. Selection criteria are
``repro_torch.registry.leader_policies`` plugins scoring each member against
its co-members::

    @leader_policies.register("degree")
    def policy(members, adj, pos, persist) -> scores (m,)

* ``degree`` — highest weighted radio degree WITHIN the cluster (the
  best-connected relay; uses the link-quality weights when the trace
  carries them).
* ``centrality`` — the cluster medoid: smallest summed distance to
  co-members (central vehicles keep the whole cluster in range
  longest). Falls back to ``degree`` when the trace has no positions
  (static topologies).
* ``contact_duration`` — largest summed FORWARD link persistence with
  co-members: how many consecutive future rounds each link survives
  (``link_persistence``). Elects the vehicle whose cluster contacts
  will last, per the mobility-aware selection of arXiv 2503.06443.

Ties break toward the lowest vehicle id (argmax picks the first max).

The same paper selects leaders JOINTLY with per-cluster local-iteration
counts; :func:`local_iteration_counts` derives advisory counts from
mean intra-cluster contact duration (stable clusters can afford more
local work between syncs). They are surfaced as telemetry for the
paper-table sweep — the compiled scan keeps the config-static
``local_steps`` (a traced per-cluster step count would force a
per-round host dispatch, which the scan contract forbids).
"""
from __future__ import annotations

import numpy as np

from repro_torch.registry import leader_policies

__all__ = ["elect_leaders", "leader_table", "link_persistence",
           "local_iteration_counts"]


@leader_policies.register("degree")
def _degree_policy(members, adj, pos, persist):
    return np.asarray(adj)[np.ix_(members, members)].sum(axis=1)


@leader_policies.register("centrality")
def _centrality_policy(members, adj, pos, persist):
    if pos is None:
        return _degree_policy(members, adj, pos, persist)
    p = np.asarray(pos)[members]
    d = np.linalg.norm(p[:, None, :] - p[None, :, :], axis=-1)
    return -d.sum(axis=1)


@leader_policies.register("contact_duration")
def _contact_policy(members, adj, pos, persist):
    return np.asarray(persist)[np.ix_(members, members)].sum(axis=1)


def link_persistence(adj_stack: np.ndarray) -> np.ndarray:
    """(R, K, K) adjacency stack -> (R, K, K) forward link persistence.

    ``persist[t, i, j]`` = number of consecutive rounds >= t the link
    (i, j) stays up (0 when down at t). One backward pass:
    ``persist[t] = up[t] * (1 + persist[t+1])``."""
    up = (np.asarray(adj_stack) > 0).astype(np.int32)
    out = np.zeros_like(up)
    out[-1] = up[-1]
    for t in range(up.shape[0] - 2, -1, -1):
        out[t] = up[t] * (1 + out[t + 1])
    return out


def elect_leaders(cluster: np.ndarray, adj_stack: np.ndarray,
                  positions: np.ndarray | None = None,
                  *, policy: str = "degree") -> np.ndarray:
    """Per-round leader election: (R, K) cluster stack -> (R, K) int32
    ``leader_of`` — entry [t, n] is the vehicle id of n's cluster leader
    at round t (a node leads iff ``leader_of[t, n] == n``)."""
    score_fn = leader_policies.get(policy)
    cluster = np.asarray(cluster)
    adj_stack = np.asarray(adj_stack)
    persist = (link_persistence(adj_stack)
               if policy == "contact_duration"
               else np.zeros_like(adj_stack, dtype=np.int32))
    rounds, k = cluster.shape
    out = np.empty((rounds, k), dtype=np.int32)
    for t in range(rounds):
        pos_t = None if positions is None else np.asarray(positions[t])
        for lab in np.unique(cluster[t]):
            members = np.flatnonzero(cluster[t] == lab)
            scores = np.asarray(
                score_fn(members, adj_stack[t], pos_t, persist[t]),
                dtype=np.float64)
            out[t, members] = members[int(np.argmax(scores))]
    return out


def leader_table(cluster: np.ndarray,
                 leader_of: np.ndarray) -> np.ndarray:
    """(R, K) stacks -> (R, C) leader ids per cluster, -1 padded.

    C is the max cluster count over the run; row t lists cluster c's
    leader vehicle id (clusters are canonical 0..C_t-1 per round)."""
    cluster = np.asarray(cluster)
    leader_of = np.asarray(leader_of)
    cmax = int(cluster.max()) + 1
    out = np.full((cluster.shape[0], cmax), -1, dtype=np.int32)
    for t in range(cluster.shape[0]):
        for lab in np.unique(cluster[t]):
            first = np.flatnonzero(cluster[t] == lab)[0]
            out[t, lab] = leader_of[t, first]
    return out


def local_iteration_counts(cluster: np.ndarray, adj_stack: np.ndarray,
                           *, base: int = 1,
                           max_iters: int = 4) -> np.ndarray:
    """Advisory per-cluster local-iteration counts (R, C), 0 padded.

    Clusters whose intra links persist longer than the fleet mean get
    proportionally more local iterations (clipped to
    ``[1, max_iters]``) — the joint selection of arXiv 2503.06443.
    Telemetry only; see the module docstring."""
    cluster = np.asarray(cluster)
    persist = link_persistence(adj_stack)
    cmax = int(cluster.max()) + 1
    rounds = cluster.shape[0]
    means = np.zeros((rounds, cmax))
    for t in range(rounds):
        for lab in np.unique(cluster[t]):
            members = np.flatnonzero(cluster[t] == lab)
            block = persist[t][np.ix_(members, members)]
            means[t, lab] = block.mean() if members.size > 1 else 0.0
    fleet = max(means[means > 0].mean(), 1e-9) if (means > 0).any() else 1.0
    out = np.zeros((rounds, cmax), dtype=np.int32)
    active = means > 0
    out[active] = np.clip(
        np.rint(base * means[active] / fleet), 1, max_iters).astype(np.int32)
    # singleton/quiet clusters that exist this round still do >= 1 pass
    for t in range(rounds):
        labs = np.unique(cluster[t])
        out[t, labs] = np.maximum(out[t, labs], 1)
    return out
