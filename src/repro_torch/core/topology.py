"""Communication graphs and mixing-weight construction (paper eqs. 6-7).

A topology is an adjacency over K nodes (base stations). Mixing weights
eta[k, i] are row-normalized over k's neighborhood (excluding self), per
eq. 6, with Ë_i = E_i' / E_i the CND distinct-data ratio (eq. 7). The
policies are plain tensor code on the device of their inputs.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.registry import mixing_policies


class SparseEta(NamedTuple):
    """Top-D sparse mixing weights: ``idx[..., k, d]`` is the node index
    of k's d-th neighbor (int32) and ``val[..., k, d]`` its weight (f32).
    Empty slots (isolated nodes, degree padding) carry ``val == 0``; a
    gathered row scaled by zero contributes nothing, so an all-zero row is
    a pure self-update. ``(R, K, D)`` stacks slice per round like dense
    ``(R, K, K)`` stacks."""

    idx: torch.Tensor
    val: torch.Tensor

    @property
    def degree(self) -> int:
        return self.idx.shape[-1]


def validate_degree(degree: int, k: int) -> int:
    """A top-D degree must satisfy 1 <= D <= K-1 (no self loops); out of
    range raises rather than clamps."""
    degree = int(degree)
    if not 1 <= degree <= k - 1:
        raise ValueError(
            f"degree={degree} out of range for K={k} nodes: need "
            f"1 <= degree <= K-1 = {k - 1} (each node has at most K-1 "
            f"neighbors; requesting more would silently clamp)")
    return degree


def sparsify_eta(eta: torch.Tensor, degree: int) -> SparseEta:
    """Dense (..., K, K) eta -> top-``degree`` :class:`SparseEta`, the
    survivors rescaled to each row's original mass (row sums, and so the
    gamma bound, are unchanged; all-zero rows stay zero).

    Ties keep the lower index first, as ``jax.lax.top_k`` does: the first
    ``degree`` entries of a stable descending sort (``torch.topk``
    promises no order among equal values)."""
    k = eta.shape[-1]
    degree = validate_degree(degree, k)
    eta32 = eta.to(torch.float32)
    val, idx = torch.sort(eta32, dim=-1, descending=True, stable=True)
    val, idx = val[..., :degree], idx[..., :degree]
    kept = torch.clamp_min(val, 0.0)              # eta is nonnegative
    mass = eta32.sum(dim=-1)
    keptmass = kept.sum(dim=-1)
    scale = torch.where(keptmass > 0, mass / torch.clamp_min(keptmass, 1e-12),
                        torch.zeros_like(mass))
    return SparseEta(idx=idx.to(torch.int32).contiguous(),
                     val=(kept * scale[..., None]).contiguous())


def densify_eta(sp: SparseEta, k: int) -> torch.Tensor:
    """Scatter a :class:`SparseEta` back to a dense (..., K, K) eta;
    zero-weight slots add nothing, duplicate indices add."""
    val = sp.val.to(torch.float32)
    out = torch.zeros(val.shape[:-1] + (k,), dtype=torch.float32,
                      device=val.device)
    return out.scatter_add_(-1, sp.idx.long(), val)


def adjacency(kind: str, k: int, *, seed: int = 0,
              edge_prob: float = 0.5) -> np.ndarray:
    """(K, K) 0/1 float32 adjacency, no self loops, symmetric, built from
    an undirected edge set (a K=2 ring is the single edge {0, 1}).

    ``erdos``: G(K, p) with ``edge_prob`` and a deterministic ``seed``;
    connectivity is not guaranteed."""
    edges: set[tuple[int, int]] = set()
    if kind == "ring":
        edges = {tuple(sorted((i, (i + 1) % k))) for i in range(k)
                 if i != (i + 1) % k}
    elif kind == "full":
        edges = {(i, j) for i in range(k) for j in range(i + 1, k)}
    elif kind == "chain":
        edges = {(i, i + 1) for i in range(k - 1)}
    elif kind == "erdos":
        rng = np.random.default_rng(np.random.SeedSequence([seed, k]))
        edges = {(i, j) for i in range(k) for j in range(i + 1, k)
                 if rng.random() < edge_prob}
    else:
        raise ValueError(f"unknown topology {kind!r}")
    a = np.zeros((k, k), dtype=np.float32)
    for i, j in edges:
        a[i, j] = a[j, i] = 1.0
    return a


def cnd_mixing(adj: torch.Tensor, ratios: torch.Tensor) -> torch.Tensor:
    """eta[k,i] = Ë_i / sum_{j in N_k} Ë_j (paper eq. 6), zero off-graph."""
    w = adj * ratios[None, :]
    denom = torch.clamp_min(w.sum(dim=1, keepdim=True), 1e-12)
    return w / denom


def uniform_mixing(adj: torch.Tensor) -> torch.Tensor:
    """eta[k,i] = 1/|N_k| — CFA-style, redundancy-blind."""
    denom = torch.clamp_min(adj.sum(dim=1, keepdim=True), 1e-12)
    return adj / denom


def datasize_mixing(adj: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """eta[k,i] ∝ E_i (raw dataset sizes, no dedup) — FedAvg-style."""
    w = adj * sizes[None, :].to(torch.float32)
    denom = torch.clamp_min(w.sum(dim=1, keepdim=True), 1e-12)
    return w / denom


def metropolis_mixing(adj: torch.Tensor) -> torch.Tensor:
    """Metropolis-Hastings neighbor weights 1/(1 + max(d_k, d_i)); the
    self weight stays implicit in the consensus step."""
    deg = adj.sum(dim=1)
    return adj / (1.0 + torch.maximum(deg[:, None], deg[None, :]))


# Registered mixing policies: ``rule(adj, *, ratios=None, sizes=None)``.
mixing_policies.register(
    "cnd", lambda adj, *, ratios=None, sizes=None: cnd_mixing(adj, ratios))
mixing_policies.register(
    "datasize",
    lambda adj, *, ratios=None, sizes=None: datasize_mixing(adj, sizes))
mixing_policies.register(
    "uniform", lambda adj, *, ratios=None, sizes=None: uniform_mixing(adj))
mixing_policies.register(
    "metropolis",
    lambda adj, *, ratios=None, sizes=None: metropolis_mixing(adj))


# Which mixing rule each algorithm's exchange uses (paper Sec. 5.3).
ALGORITHM_MIXING = {
    "cdfl": "cnd",
    "cfa": "datasize",
    "fedavg": "datasize",
    "cdfa_m": "uniform",
    "dpsgd": "uniform",
    "metropolis": "metropolis",
}


def mixing_weights(adj: torch.Tensor, rule: str,
                   ratios: torch.Tensor | None = None,
                   sizes: torch.Tensor | None = None,
                   degree: int | None = None):
    """Dense (K, K) eta from the selected registered mixing policy, or,
    with ``degree``, its top-``degree`` :class:`SparseEta`."""
    eta = mixing_policies.get(rule)(adj, ratios=ratios, sizes=sizes)
    if degree is None:
        return eta
    return sparsify_eta(eta, degree)


def renormalize_rows(eta: torch.Tensor,
                     target_rows: torch.Tensor | None = None) -> torch.Tensor:
    """Rescale each row's surviving entries to sum to ``target_rows[k]``
    (default 1); fully drained rows stay all-zero, never NaN. Rows run
    along the last axis, so (R, K, K) stacks and (K, D) / (R, K, D)
    sparse weight rows renormalize the same way."""
    s = eta.sum(dim=-1)
    t = torch.ones_like(s) if target_rows is None else target_rows
    scale = torch.where(s > 0, t / torch.clamp_min(s, 1e-12),
                        torch.zeros_like(s))
    return eta * scale[..., None]


def max_row_sum(eta) -> torch.Tensor:
    """∇ = max_k sum_i eta[k,i] — the paper's bound: gamma in (0, 1/∇).
    A :class:`SparseEta` row sums over its D kept weights."""
    if isinstance(eta, SparseEta):
        return eta.val.sum(dim=-1).max()
    return eta.sum(dim=1).max()


def stable_gamma(eta, cap: float) -> torch.Tensor:
    """``cap`` clipped to the stability bound gamma < 1/∇ (0.99 safety
    factor; an empty graph keeps the cap)."""
    nabla = max_row_sum(eta)
    bound = 0.99 / torch.clamp_min(nabla, 1e-6)
    return torch.minimum(torch.tensor(cap, dtype=torch.float32,
                                      device=nabla.device), bound)


def consensus_matrix(eta: torch.Tensor, gamma) -> torch.Tensor:
    """The K×K operator A with A @ W implementing eq. (5):
    phi_k = W_k + gamma * sum_i eta[k,i] (W_i - W_k)."""
    k = eta.shape[0]
    row = eta.sum(dim=1)
    eye = torch.eye(k, dtype=eta.dtype, device=eta.device)
    return eye * (1.0 - gamma * row)[None, :].T + gamma * eta


def spectral_gap(a: torch.Tensor) -> float:
    """1 - |lambda_2| of the consensus matrix: consensus convergence rate."""
    if a.shape[0] <= 1:
        return 1.0
    ev = torch.sort(torch.abs(torch.linalg.eigvals(a))).values
    return float(1.0 - ev[-2])
