"""Byzantine-robust mixing plugins: trimmed-mean and median consensus.

The eq. 5 mix is a fixed convex combination: one adversarial neighbor
broadcasting ``-W`` (sign flip) or ``c * W`` pulls every honest node off
the consensus manifold, because the weighted mean has a breakdown point of
zero. Coordinate-wise order statistics fix that: each node sorts, per
parameter, the payloads of its neighborhood (own value included) and takes

* ``trimmed_mean`` — the mean with the ``trim`` largest and ``trim``
  smallest values discarded (the plain masked mean when the neighborhood
  is too small to trim, ``count <= 2*trim``);
* ``median``       — the middle value (mean of the two middles for even
  counts).

Robust rules ignore the eta VALUES (uniform trust over the neighborhood
support) and make the consensus step nonlinear. The aggregate is kernel
B7 (:func:`repro_torch.kernels.ops.robust_agg`).

Registered in :data:`repro_torch.registry.robust_rules` as factories
``fed -> exchange(buf, sent, eta, gamma) -> buf``. They need the dense
transport: order statistics need every neighbor row materialized.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.registry import robust_rules


def sorted_weights(mask: torch.Tensor, mode: str, trim: int) -> torch.Tensor:
    """(K, K) position-weight matrix addressing each row's SORTED
    candidate values (ascending, masked slots past position ``count-1``).

    Row k has ``c = mask[k].sum()`` live candidates. ``median`` puts
    0.5/0.5 on the middle pair (twice 0.5 on the same slot for odd c);
    ``trimmed_mean`` spreads 1/(c-2t) over positions [t, c-t) with
    ``t = trim`` when c > 2*trim else 0. Empty rows get all-zero weights.
    """
    k = mask.shape[0]
    c = mask.sum(dim=1).to(torch.int32)[:, None]                 # (K, 1)
    j = torch.arange(k, dtype=torch.int32, device=mask.device)[None, :]
    if mode == "median":
        w = 0.5 * ((j == (c - 1) // 2).to(torch.float32)
                   + (j == c // 2).to(torch.float32))
    elif mode == "trimmed_mean":
        t = torch.where(c > 2 * trim, trim, 0)
        inside = (j >= t) & (j < c - t)
        w = inside.to(torch.float32) / torch.clamp_min(c - 2 * t, 1)
    else:
        raise ValueError(f"unknown robust mode {mode!r}")
    return torch.where(c > 0, w, torch.zeros_like(w))


def robust_exchange(buf: torch.Tensor, sent: torch.Tensor, eta: torch.Tensor,
                    gamma, *, mode: str, trim: int = 1) -> torch.Tensor:
    """One robust consensus step on the flat (K, P) buffer:

        OUT_k = BUF_k + gamma * (agg_k - BUF_k)

    with ``agg_k`` the coordinate-wise ``mode`` statistic over node k's
    neighborhood support ``{i : eta[k,i] > 0} ∪ {k}``: sender payloads
    from ``sent`` (after the wire guard), k's own slot from its clean
    buffer. Nodes with no live neighbor keep BUF (pure self-update)."""
    from repro_torch.kernels import ops

    k = buf.shape[0]
    eye = torch.eye(k, dtype=torch.bool, device=buf.device)
    mask = ((eta > 0) | eye).to(torch.float32)
    weights = sorted_weights(mask, mode, trim)
    agg = ops.robust_agg(weights, mask, buf, sent.contiguous())
    has_nb = (eta.sum(dim=1) > 0).to(buf.dtype)[:, None]
    g = torch.as_tensor(gamma, dtype=buf.dtype, device=buf.device)
    return buf + g * has_nb * (agg - buf)


def make_robust(fed):
    """Resolve ``fed.robust`` to an ``exchange(buf, sent, eta, gamma)``
    callable via the registry (None -> None: paper mixing)."""
    if fed.robust is None:
        return None
    return robust_rules.get(fed.robust)(fed)


@robust_rules.register("trimmed_mean")
def _make_trimmed_mean(fed):
    trim = int(fed.trim)
    if trim < 0:
        raise ValueError(f"trim must be >= 0, got {trim}")
    return functools.partial(robust_exchange, mode="trimmed_mean", trim=trim)


@robust_rules.register("median")
def _make_median(fed):
    return functools.partial(robust_exchange, mode="median", trim=0)
