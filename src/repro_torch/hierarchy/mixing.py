"""Two-tier hierarchical mixing: dense intra-cluster consensus with a
cluster-local gamma + sparse inter-cluster leader consensus (the twin of
the JAX package's ``repro.hierarchy.mixing``).

* **intra tier** — each mobility cluster mixes among its members under
  its OWN stability bound ``gamma_c = min(cap, 0.99/∇_c)``, ∇_c the max
  row sum inside cluster c (kernel B6, per-node gamma);
* **inter tier** — each cluster's leader mixes its post-intra aggregate
  with the leaders of radio-adjacent clusters through the top-D sparse
  path (kernel B5); non-leader rows are all-zero, an exact self-update.
  It runs at full precision (the V2I backhaul, not the lossy V2V wire);
* **re-merge bursts** — rounds where the cluster count drops run
  ``burst`` extra intra passes. The flags are host data
  (``clustering.remerge_flags``), so the branch is taken in Python with
  no device read.

The geometry (clusters, leaders, index tables) is numpy, compiled once
per run for the whole horizon; the weights are tensors on the device of
the CND ratios, in a :class:`HierEta` of ``(R, ...)`` stacks.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import flatten, topology
from repro_torch.hierarchy import clustering, leaders
from repro_torch.kernels import cluster_mix as clm
from repro_torch.mobility import links, traces
from repro_torch.mobility.mixing import _sparse_rule, masked_sparse_stack, \
    side_device, sparse_gamma_stack

__all__ = [
    "HierEta", "hier_geometry", "build_hier_stacks", "hier_static_stacks",
    "hier_scenario_stacks", "constant_hier_stacks", "hier_mix_flat",
    "hier_gamma_stack", "masked_hier_stack",
]


class HierEta(NamedTuple):
    """Per-round two-tier mixing weights; ``(R, ...)`` stacks slice per
    round like :class:`topology.SparseEta`. The intra tier keeps every
    co-member link (``Di`` = largest cluster size - 1) and never points
    outside the member's cluster. ``plan`` (port-only) groups the intra
    table's receivers by cluster for kernel B6; it depends on
    ``intra.idx`` alone, so edits of the weights keep it."""

    cluster: torch.Tensor         # (..., K) int64 cluster id per node
    intra: topology.SparseEta     # (..., K, Di) co-member weights
    gamma_node: torch.Tensor      # (..., K) f32 cluster-local step size
    inter: topology.SparseEta     # (..., K, Dx) leader rows, others zero
    burst: torch.Tensor           # (...,) f32 re-merge flag, on the host
    plan: clm.ClusterPlan | None = None   # intra receiver groups (B6)


# ---------------------------------------------------------------------------
# Host-side geometry: clusters, leaders, index tables (compiled once).
# ---------------------------------------------------------------------------

def hier_geometry(adj_stack: np.ndarray,
                  positions: np.ndarray | None, *,
                  max_cluster_size: int, leader_policy: str,
                  inter_degree: int, hysteresis: bool = True):
    """(R, K, K) link weights -> the round-stacked index geometry:
    ``(cluster (R,K), leader_of (R,K), burst (R,), intra_idx,
    intra_w (R,K,Di), inter_idx, inter_w (R,K,Dx))``, numpy, identical to
    the JAX package's. Computed for the full horizon and sliced by the
    caller (hysteresis chains round to round)."""
    adj_stack = np.asarray(adj_stack, np.float32)
    rounds, k = adj_stack.shape[:2]
    cluster = clustering.cluster_stack(
        adj_stack, positions, max_cluster_size=max_cluster_size,
        hysteresis=hysteresis)
    leader_of = leaders.elect_leaders(cluster, adj_stack, positions,
                                      policy=leader_policy)
    burst = clustering.remerge_flags(cluster)
    largest = max(int(np.bincount(c).max()) for c in cluster)
    di = int(min(max(largest - 1, 1), k - 1))
    dx = int(min(max(int(inter_degree), 1), k - 1))
    intra_idx = np.zeros((rounds, k, di), np.int32)
    intra_w = np.zeros((rounds, k, di), np.float32)
    inter_idx = np.zeros((rounds, k, dx), np.int32)
    inter_w = np.zeros((rounds, k, dx), np.float32)
    eye = np.eye(k, dtype=bool)
    for t in range(rounds):
        c = cluster[t]
        # intra: keep every co-member radio link (di bounds the count
        # by construction, so this tier is dense within the block)
        w = adj_stack[t] * (c[:, None] == c[None, :])
        w[eye] = 0.0
        score = np.where(w > 0, w, -np.inf)
        idx = np.argpartition(score, -di, axis=1)[:, -di:]
        val = np.take_along_axis(w, idx, axis=1)
        intra_idx[t] = idx.astype(np.int32)
        intra_w[t] = val
        # inter: clusters are adjacent when ANY cross-member link is
        # up; the leader edge carries the strongest such link
        cmax_t = int(c.max()) + 1
        cw = np.zeros((cmax_t, cmax_t), np.float32)
        ii, jj = np.nonzero(adj_stack[t] > 0)
        cross = c[ii] != c[jj]
        np.maximum.at(cw, (c[ii[cross]], c[jj[cross]]),
                      adj_stack[t][ii[cross], jj[cross]])
        ldr = np.array([leader_of[t][np.flatnonzero(c == lab)[0]]
                        for lab in range(cmax_t)])
        for lab in range(cmax_t):
            nb = np.flatnonzero(cw[lab] > 0)
            if nb.size == 0:
                continue
            order = nb[np.argsort(-cw[lab, nb], kind="stable")][:dx]
            led = ldr[lab]
            inter_idx[t, led, :order.size] = ldr[order]
            inter_w[t, led, :order.size] = cw[lab, order]
    return (cluster, leader_of, burst, intra_idx, intra_w,
            inter_idx, inter_w)


# ---------------------------------------------------------------------------
# Device-side weights (composes with the CND ratios).
# ---------------------------------------------------------------------------

def _build_round(cluster, intra_idx, intra_w, inter_idx, inter_w, *,
                 rule: str, ratios, sizes, gamma_cap: float):
    """One round's weights from the index geometry: the run's mixing rule
    on the cluster-restricted link rows, a per-cluster gamma from a
    segment max of the row sums, and inter rows row-normalized over the
    kept leaders. Empty cluster ids keep a -inf segment max and are never
    gathered."""
    k = cluster.shape[0]
    intra_val = _sparse_rule(intra_idx, intra_w, rule, ratios, sizes)
    rowsum = intra_val.sum(dim=-1)
    maxrow = torch.full((k,), -torch.inf, dtype=torch.float32,
                        device=rowsum.device).scatter_reduce(
        0, cluster, rowsum, "amax", include_self=False)
    gamma_c = torch.minimum(
        torch.tensor(gamma_cap, dtype=torch.float32, device=rowsum.device),
        0.99 / torch.clamp_min(maxrow, 1e-6))
    gamma_node = gamma_c[cluster]
    s = inter_w.sum(dim=-1, keepdim=True)
    inter_val = torch.where(s > 0, inter_w / torch.clamp_min(s, 1e-12),
                            torch.zeros_like(inter_w))
    inter = topology.SparseEta(inter_idx, inter_val)
    return intra_val, gamma_node, inter_val, topology.stable_gamma(
        inter, gamma_cap)


def build_hier_stacks(geometry, *, rule: str, ratios, sizes,
                      gamma_cap: float):
    """Geometry stacks -> ``(HierEta (R, ...), gammas (R,))`` on the
    device of ``ratios``/``sizes``. ``gammas`` is the INTER-tier step
    size; the intra tier's per-node gammas travel inside the HierEta, with
    the intra table's plan (its receivers grouped by cluster)."""
    cluster, _, burst, intra_idx, intra_w, inter_idx, inter_w = geometry
    dev = side_device(ratios, sizes)

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    cl = put(cluster, torch.int64)
    i1, w1 = put(intra_idx, torch.int32), put(intra_w, torch.float32)
    i2, w2 = put(inter_idx, torch.int32), put(inter_w, torch.float32)
    rounds = [_build_round(cl[r], i1[r], w1[r], i2[r], w2[r], rule=rule,
                           ratios=ratios, sizes=sizes, gamma_cap=gamma_cap)
              for r in range(cl.shape[0])]
    intra_val, gamma_node, inter_val, gammas = (torch.stack(x)
                                                for x in zip(*rounds))
    h = HierEta(cluster=cl, intra=topology.SparseEta(i1, intra_val),
                gamma_node=gamma_node,
                inter=topology.SparseEta(i2, inter_val),
                burst=torch.as_tensor(np.asarray(burst), dtype=torch.float32),
                plan=clm.plan_stack(intra_idx, cluster, dev))
    return h, gammas


def hier_static_stacks(adj, *, rule: str, ratios, sizes, gamma_cap: float,
                       max_cluster_size: int, leader_policy: str,
                       inter_degree: int, hysteresis: bool = True):
    """One static (K, K) graph (numpy) -> a single-round
    ``(HierEta, gamma)`` with no leading R axis (broadcast with
    :func:`constant_hier_stacks`)."""
    geo = hier_geometry(np.asarray(adj)[None], None,
                        max_cluster_size=max_cluster_size,
                        leader_policy=leader_policy,
                        inter_degree=inter_degree, hysteresis=hysteresis)
    h, gammas = build_hier_stacks(geo, rule=rule, ratios=ratios, sizes=sizes,
                                  gamma_cap=gamma_cap)
    one = HierEta(h.cluster[0], topology.SparseEta(h.intra.idx[0],
                                                   h.intra.val[0]),
                  h.gamma_node[0], topology.SparseEta(h.inter.idx[0],
                                                      h.inter.val[0]),
                  torch.zeros((), dtype=torch.float32),
                  None if h.plan is None
                  else clm.ClusterPlan(*(t[0] for t in h.plan)))
    return one, gammas[0]


def hier_scenario_stacks(mob, rounds: int, k: int, *, rule: str,
                         gamma_cap: float, ratios, sizes,
                         max_cluster_size: int, leader_policy: str,
                         inter_degree: int, hysteresis: bool = True,
                         start: int = 0):
    """trace -> links -> clusters -> leaders -> two-tier weights for rounds
    ``[start, start + rounds)``. The trace AND the clusters are computed
    from round 0 and sliced at ``start``, so a resumed segment sees the
    clusters an unsegmented run would."""
    pos = traces.trace(mob.kind, start + rounds, k, speed=mob.speed,
                       speed_jitter=mob.speed_jitter, area=mob.area,
                       dt=mob.dt, seed=mob.seed)
    adj = links.radio_adjacency(pos, mob.radio_range,
                                link_quality=mob.link_quality,
                                min_quality=mob.min_quality)
    geo = hier_geometry(adj, pos, max_cluster_size=max_cluster_size,
                        leader_policy=leader_policy,
                        inter_degree=inter_degree, hysteresis=hysteresis)
    geo = tuple(g[start:] for g in geo)
    return build_hier_stacks(geo, rule=rule, ratios=ratios, sizes=sizes,
                             gamma_cap=gamma_cap)


def _broadcast(t: torch.Tensor, rounds: int) -> torch.Tensor:
    return t.expand((rounds,) + tuple(t.shape))


def constant_hier_stacks(h: HierEta, gamma, rounds: int):
    """Broadcast a single-round :class:`HierEta` / scalar gamma to
    ``(R, ...)`` stacks: the static-topology case."""
    stack = HierEta(
        _broadcast(h.cluster, rounds),
        topology.SparseEta(_broadcast(h.intra.idx, rounds),
                           _broadcast(h.intra.val, rounds)),
        _broadcast(h.gamma_node, rounds),
        topology.SparseEta(_broadcast(h.inter.idx, rounds),
                           _broadcast(h.inter.val, rounds)),
        _broadcast(h.burst, rounds),
        None if h.plan is None else clm.ClusterPlan(
            *(_broadcast(t, rounds) for t in h.plan)))
    g = torch.as_tensor(gamma, dtype=torch.float32,
                        device=h.gamma_node.device)
    return stack, _broadcast(g.reshape(()), rounds)


def hier_gamma_stack(h: HierEta, gamma_cap: float) -> torch.Tensor:
    """(R,) inter-tier step sizes of a hierarchical stack."""
    return sparse_gamma_stack(h.inter, gamma_cap)


def masked_hier_stack(h: HierEta, link_mask) -> HierEta:
    """Compose a fault-plan ``(R, K, K)`` link mask into BOTH tiers: a
    crashed node's intra row drains to zero (pure self-update), its columns
    vanish from co-members' rows with mass-preserving renorm, and a crashed
    LEADER also drops out of the inter tier, so its cluster skips
    inter-cluster mixing for the outage."""
    return h._replace(intra=masked_sparse_stack(h.intra, link_mask),
                      inter=masked_sparse_stack(h.inter, link_mask))


# ---------------------------------------------------------------------------
# Device mix.
# ---------------------------------------------------------------------------

def hier_mix_flat(buf: torch.Tensor, h: HierEta, gamma_inter, *,
                  wire=None, wire_self=None,
                  burst_passes: int = 1) -> torch.Tensor:
    """One round's two-tier consensus on the flat (K, P) buffer:

    1. intra: per-node-gamma cluster gather-mix (B6) over co-member wire
       payloads (``wire``/``wire_self``; None mixes the clean buffer);
    2. inter: leaders sparse-mix their post-intra aggregates (B5) at full
       precision;
    3. re-merge burst: ``burst_passes`` extra intra passes when this
       round's host flag ``h.burst`` is set.
    """
    out = flatten.cluster_mix_flat(buf, h.intra.idx, h.intra.val,
                                   h.gamma_node, wire=wire,
                                   wire_self=wire_self, plan=h.plan)
    out = flatten.sparse_mix_flat(out, h.inter.idx, h.inter.val, gamma_inter)
    if burst_passes > 0 and float(h.burst) > 0:
        for _ in range(burst_passes):
            out = flatten.cluster_mix_flat(out, h.intra.idx, h.intra.val,
                                           h.gamma_node, plan=h.plan)
    return out
