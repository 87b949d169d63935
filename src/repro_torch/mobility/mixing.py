"""Per-round mixing stacks: (R, K, K) link weights -> (R, K, K) eta, or
(R, K, D) sparse link rows -> a :class:`SparseEta` stack.

The per-round rule is the same ``topology.mixing_weights`` dispatch the
static path uses, applied round by round, so a constant stack equals the
hoisted static weights. A node with no in-range neighbors gets an
all-zero eta row (eq. 5 then degrades to a pure self-update, no NaN),
and each connected component renormalizes over its own members.
Everything here is tensor code on the device of its inputs.
"""
from __future__ import annotations

import torch

from repro_torch.core import topology


def side_device(ratios, sizes):
    """The device of the round-invariant side inputs (None: default)."""
    side = ratios if ratios is not None else sizes
    return None if side is None else side.device


def eta_stack(adj_stack, rule: str, ratios: torch.Tensor | None = None,
              sizes: torch.Tensor | None = None) -> torch.Tensor:
    """(R, K, K) per-round mixing weights from a link-weight stack;
    ``ratios``/``sizes`` are the round-invariant CND ratios / dataset
    sizes (their device is the result's)."""
    dev = side_device(ratios, sizes)
    adj = torch.as_tensor(adj_stack, dtype=torch.float32, device=dev)
    return torch.stack([topology.mixing_weights(a, rule, ratios, sizes)
                        for a in adj])


def gamma_stack(etas: torch.Tensor, gamma_cap: float) -> torch.Tensor:
    """(R,) per-round step sizes: ``topology.stable_gamma`` per round."""
    return torch.stack([topology.stable_gamma(e, gamma_cap) for e in etas])


def masked_eta_stack(etas: torch.Tensor, link_mask) -> torch.Tensor:
    """Compose a fault-plan ``(R, K, K)`` link mask into an eta stack.

    Each round's surviving entries are rescaled to the row's pre-mask mass
    (``topology.renormalize_rows``): for row-normalized policies that is
    exactly recomputing the weights on the masked adjacency, for
    metropolis it keeps the sub-stochastic row mass. Rows drained by a
    crash or total link loss come out all-zero: a pure self-update."""
    etas = etas.to(torch.float32)
    mask = torch.as_tensor(link_mask, dtype=torch.float32,
                           device=etas.device)
    return topology.renormalize_rows(etas * mask, etas.sum(dim=-1))


def masked_sparse_stack(sp: topology.SparseEta,
                        link_mask) -> topology.SparseEta:
    """Compose a fault-plan ``(R, K, K)`` link mask into a sparse stack by
    editing the (R, K, D) rows: each kept edge gathers its mask bit,
    dropped edges go to zero and the survivors are rescaled to the row's
    pre-mask mass (the sparse twin of :func:`masked_eta_stack`). Stacks
    with a leading variant axis share the one mask, as dense ones do."""
    mask = torch.as_tensor(link_mask, dtype=torch.float32,
                           device=sp.val.device)
    # (V, R, K, D) variant stacks gather from the one (R, K, K) mask
    mask = mask.expand(sp.idx.shape[:-1] + mask.shape[-1:])
    m = torch.gather(mask, -1, sp.idx.long())
    return topology.SparseEta(
        sp.idx, topology.renormalize_rows(sp.val * m, sp.val.sum(dim=-1)))


def constant_stacks(eta: torch.Tensor, gamma, rounds: int):
    """Broadcast one (K, K) eta / scalar gamma to (R, K, K) / (R,): the
    static-topology case of the per-round stacks."""
    g = torch.as_tensor(gamma, dtype=torch.float32, device=eta.device)
    return (eta.expand((rounds,) + tuple(eta.shape)),
            g.reshape(()).expand(rounds))


def _sparse_rule(idx: torch.Tensor, val: torch.Tensor, rule: str,
                 ratios, sizes) -> torch.Tensor:
    """One round's mixing weights on sparse (K, D) link rows: the four
    built-in policies computed on the gathered neighbor entries (``x[idx]``
    replaces the dense ``adj * x[None, :]``). Rows renormalize over their
    kept entries; all-zero rows stay zero."""
    rows = idx.long()
    if rule == "metropolis":
        deg = val.sum(dim=-1)                            # weighted degree
        return val / (1.0 + torch.maximum(deg[:, None], deg[rows]))
    if rule == "cnd":
        w = val * ratios[rows]
    elif rule == "datasize":
        w = val * sizes[rows].to(torch.float32)
    elif rule == "uniform":
        w = (val > 0).to(torch.float32)
    else:
        raise ValueError(
            f"mixing rule {rule!r} has no sparse implementation "
            f"(sparse mixing_format supports the built-in rules "
            f"cnd/datasize/uniform/metropolis; use mixing_format="
            f"'dense' for custom registered policies)")
    s = w.sum(dim=-1, keepdim=True)
    return torch.where(s > 0, w / torch.clamp_min(s, 1e-12),
                       torch.zeros_like(w))


def sparse_eta_stack(idx, val, rule: str, ratios: torch.Tensor | None = None,
                     sizes: torch.Tensor | None = None) -> topology.SparseEta:
    """(R, K, D) link idx/val -> per-round sparse mixing weights, on the
    device of ``ratios``/``sizes``."""
    dev = side_device(ratios, sizes)
    idx = torch.as_tensor(idx, dtype=torch.int32, device=dev)
    val = torch.as_tensor(val, dtype=torch.float32, device=dev)
    out = torch.stack([_sparse_rule(i, v, rule, ratios, sizes)
                       for i, v in zip(idx, val)])
    return topology.SparseEta(idx=idx.contiguous(), val=out.contiguous())


def sparse_gamma_stack(sp: topology.SparseEta,
                       gamma_cap: float) -> torch.Tensor:
    """(R,) per-round step sizes from a sparse stack: the same bound, row
    sums over the D kept weights."""
    return torch.stack([
        topology.stable_gamma(topology.SparseEta(i, v), gamma_cap)
        for i, v in zip(sp.idx, sp.val)])


def constant_sparse_stacks(sp: topology.SparseEta, gamma, rounds: int):
    """Broadcast one (K, D) sparse eta / scalar gamma to (R, K, D) / (R,)."""
    g = torch.as_tensor(gamma, dtype=torch.float32, device=sp.val.device)
    return (topology.SparseEta(
                sp.idx.expand((rounds,) + tuple(sp.idx.shape)),
                sp.val.expand((rounds,) + tuple(sp.val.shape))),
            g.reshape(()).expand(rounds))


def stack_variant_stacks(stacks):
    """Stack per-VARIANT per-round mixing stacks along a new leading (V,)
    axis for the batched fleet driver: dense ``(R, K, K)`` tensors become
    ``(V, R, K, K)``; ``SparseEta`` ``(R, K, D)`` pairs become one
    ``SparseEta`` with ``(V, R, K, D)`` stacks (stacked field by field, no
    dense intermediate). Only call this when variants genuinely differ: V
    copies of one scenario should stay a single shared stack, which
    ``run_rounds_batch`` hands every variant (eta stride 0 in kernel
    B1)."""
    first = stacks[0]
    if isinstance(first, topology.SparseEta):
        return topology.SparseEta(
            torch.stack([torch.as_tensor(s.idx) for s in stacks]),
            torch.stack([torch.as_tensor(s.val) for s in stacks]))
    return torch.stack([torch.as_tensor(s) for s in stacks])
