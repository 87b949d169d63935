"""Distinct-count-derived weights: sampling probabilities and eta scaling.

Two consumers of the streaming sketches:

* **Sampling**: per-slot probabilities proportional to the inverse
  count-min multiplicity estimate, so each DISTINCT item contributes about
  equally to the local gradient (:func:`sampling_weights` and
  :func:`weighted_indices`).
* **Mixing**: eta COLUMNS scaled by the neighbors' estimated effective
  (distinct) cardinality, with a mass-preserving row renorm
  (:func:`reweight_eta`): the streaming analog of the paper's eq. 6 CND
  weights. Row mass is kept, so the ``stable_gamma`` bound of the
  unweighted stack stays valid, as for fault link masks. A spread
  dead-band (``max(est) / min(est) > spread_gate``) keeps HLL noise from
  moving eta: below it the original eta passes through bit for bit.

Also registers the static ``"redundancy"`` mixing policy: eq. 6 with
effective cardinalities ``ratios * sizes`` instead of the ratios alone.

Every function takes leading batch axes (a ``(V,)`` variant axis) before
the node axis; a shared (K, K) eta or (K, D) table scaled by (V, K)
estimates comes back with the variant axis.
"""
from __future__ import annotations

import torch

from repro_torch.core import topology
from repro_torch.registry import mixing_policies


def redundancy_mixing(adj: torch.Tensor, ratios: torch.Tensor,
                      sizes: torch.Tensor) -> torch.Tensor:
    """eta[k,i] ∝ adj[k,i] * Ë_i * E_i: a neighbor's weight proportional to
    its estimated effective (distinct) cardinality, zero off-graph, rows
    normalized to 1 over the neighborhood."""
    eff = ratios * torch.clamp_min(sizes.to(torch.float32), 1.0)
    w = adj * eff[None, :]
    denom = torch.clamp_min(w.sum(dim=1, keepdim=True), 1e-12)
    return w / denom


mixing_policies.register(
    "redundancy",
    lambda adj, *, ratios=None, sizes=None:
        redundancy_mixing(adj, ratios, sizes))


def mixing_scale(est: torch.Tensor, spread_gate: float):
    """(..., K) distinct estimates -> ((..., K) column scale, (...) apply
    flag). The scale is mean-normalized (a uniform fleet scales by about 1
    everywhere); the flag trips only when the max/min spread clears the
    dead-band."""
    safe = torch.clamp_min(est, 1.0)
    spread = safe.amax(dim=-1) / torch.clamp_min(safe.amin(dim=-1), 1e-6)
    return safe / _mean(safe), spread > spread_gate


def _mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the last axis as the sum divided by the count, as XLA
    computes it: on the card PyTorch's ``mean`` (and a division by a
    Python number) multiplies by the count's reciprocal, which can differ
    by an ulp, enough to flip a threshold."""
    total = x.sum(dim=-1, keepdim=True)
    return total / torch.full_like(total, x.shape[-1])


def _take(scale: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``scale[..., idx]`` per batch entry: scale (..., K), a shared (K, D)
    table or (..., K, D) tables -> (..., K, D)."""
    idx = idx.long()
    if idx.dim() == 2:
        return scale[..., idx]
    lead = torch.broadcast_shapes(scale.shape[:-1], idx.shape[:-2])
    k, d = idx.shape[-2:]
    return torch.gather(scale.expand(lead + scale.shape[-1:]), -1,
                        idx.expand(lead + (k, d)).flatten(-2)).view(
                            lead + (k, d))


def _scaled(eta, scale: torch.Tensor, apply: torch.Tensor):
    """Dense (..., K, K) eta or a ``SparseEta`` with its columns scaled by
    ``scale`` (..., K) and every row rescaled to its original mass, where
    ``apply``; the original eta elsewhere (bit for bit)."""
    if isinstance(eta, topology.SparseEta):
        val = eta.val
        scaled = val * _take(scale, eta.idx)
    else:
        val = eta
        scaled = eta * scale[..., None, :]
    target = val.sum(dim=-1)
    s = scaled.sum(dim=-1)
    rescale = torch.where(s > 0, target / torch.clamp_min(s, 1e-12), 0.0)
    out = torch.where(apply[..., None, None], scaled * rescale[..., None],
                      val)
    if isinstance(eta, topology.SparseEta):
        return topology.SparseEta(eta.idx, out)
    return out


def reweight_eta(eta, est: torch.Tensor, spread_gate: float):
    """Scale eta columns by the estimated effective cardinality, keeping
    each row's original mass (the stable_gamma contract). ``eta`` is a
    dense (K, K) matrix, a ``topology.SparseEta`` or a hierarchical stack
    (both tiers are rescaled); below the spread gate the ORIGINAL eta
    passes through bit for bit."""
    if hasattr(eta, "intra"):   # repro_torch.hierarchy.mixing.HierEta
        return eta._replace(
            intra=reweight_eta(eta.intra, est, spread_gate),
            inter=reweight_eta(eta.inter, est, spread_gate))
    scale, apply = mixing_scale(est, spread_gate)
    return _scaled(eta, scale, apply)


def scale_eta_columns(eta, scale: torch.Tensor):
    """Scale eta columns by an arbitrary (K,) factor with the renorm of
    :func:`reweight_eta`: the drift-detection hook, where a node whose data
    regime shifted gets its column discounted (``scale < 1``) or zeroed
    ("reset") while every row keeps its mass. When no column is discounted
    the original eta passes through bit for bit. Dense, ``SparseEta`` and
    hierarchical stacks (both tiers)."""
    if hasattr(eta, "intra"):   # repro_torch.hierarchy.mixing.HierEta
        return eta._replace(intra=scale_eta_columns(eta.intra, scale),
                            inter=scale_eta_columns(eta.inter, scale))
    return _scaled(eta, scale, (scale < 1.0).any(dim=-1))


def drift_novelty(mult: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-node novel-sample fraction, the drift signal.

    mult: (..., K, N) pre-update count-min multiplicity estimates of every
    slot; idx: (..., K, S, B) this round's sampled slot indices. Returns
    (..., K) fractions of sampled slots the (decayed) sketch has
    effectively never seen (estimate < 0.5)."""
    sampled = torch.gather(mult, -1, idx.flatten(-2).long())
    return _mean((sampled < 0.5).to(torch.float32))[..., 0]


def sampling_weights(mult: torch.Tensor, n_items, n: int) -> torch.Tensor:
    """(..., K, N) multiplicity estimates -> sampling weights
    ``1 / max(mult, 1)`` (an unseen or unique item keeps weight 1, a
    duplicated one is downweighted by its estimated stream count). Padded
    slots beyond each node's true item count (``n_items`` (K,)) get
    weight 0."""
    w = 1.0 / torch.clamp_min(mult, 1.0)
    if n_items is not None:
        counts = torch.as_tensor(n_items, device=mult.device)
        valid = (torch.arange(n, device=mult.device)[None, :]
                 < counts.to(torch.int64)[:, None])
        w = torch.where(valid, w, 0.0)
    return w


def weighted_indices(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Transform uniform draws into weighted slot indices through each
    node's normalized CDF (inverse-transform sampling).

    u: (..., K, S, B) uniforms in [0, 1); w: (..., K, N) nonnegative
    weights. Returns int64 indices with u's shape: the same keying as the
    uniform sampler, so segmentation invariance is untouched."""
    cdf = torch.cumsum(w, dim=-1)
    cdf = cdf / torch.clamp_min(cdf[..., -1:], 1e-12)
    i = torch.searchsorted(cdf, u.flatten(-2).contiguous(), right=True)
    return torch.clamp(i, 0, cdf.shape[-1] - 1).view(u.shape)
