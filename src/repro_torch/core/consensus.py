"""Consensus aggregation (paper eq. 5) on node-stacked parameter dicts, in
simulation: every leaf carries a leading node axis K, the dict is packed
into one flat ``(K, P)`` buffer (:mod:`repro_torch.core.flatten`) and the
consensus operator is one fused call over the whole buffer — kernel B1
for the eq. 5 delta mix, B2 for a precomposed ``A @ BUF`` — not one
product per leaf. Results come back as leaf views of the output buffer.

The JAX package's one-shot dispatch between a per-leaf and a flat form,
and its virtual-buffer CPU lowering, are XLA:CPU workarounds; the port
has the one flat path.

Mesh mode (:func:`ring_neighbors`, :func:`ring_consensus_shard`,
:func:`ring_sketch_exchange`): each rank of the ring holds ONE node, and
the exchange with its two ring neighbors is a ``permute_tensor`` over the
process group of the named mesh dimensions — the counterpart of the
reference's ``ppermute`` inside ``shard_map``. These need a process
group; without one they raise.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import flatten, topology


def apply_matrix(params: dict, matrix: torch.Tensor) -> dict:
    """``phi = A @ W`` over the leading node axis of every leaf, fused over
    the whole dict through the flat buffer (kernel B2). ``matrix``: (K, K)."""
    buf, layout = flatten.flatten(params)
    return flatten.unflatten(flatten.apply_matrix_flat(buf, matrix), layout)


def consensus_step(params: dict, eta: torch.Tensor, gamma,
                   self_weight: float = 1.0) -> dict:
    """Paper eq. (5): ``phi_k = sw * W_k + gamma * sum_i eta_ki (W_i - W_k)``,
    one fused delta-form mix of the packed buffer (kernel B1).

    ``eta``: (K, K) neighbor weights (zero diagonal / off-graph). With
    ``self_weight=1`` this is the standard consensus update; gamma must lie
    in (0, 1/max_row_sum(eta)) for stability."""
    buf, layout = flatten.flatten(params)
    out = flatten.mix_flat(buf, eta, gamma, self_weight)
    return flatten.unflatten(out, layout)


def partial_consensus_step(params: dict, eta, gamma, fraction: float) -> dict:
    """C-DFA(M): consensus on the first ``fraction`` of the leaves only
    (paper Sec. 5.3), a column prefix of the flat buffer."""
    buf, layout = flatten.flatten(params)
    prefix = flatten.prefix_length(layout, fraction)
    out = flatten.partial_mix_flat(buf, eta, gamma, prefix)
    return flatten.unflatten(out, layout)


def disagreement(params: dict) -> torch.Tensor:
    """Mean squared deviation of the node params from the node mean: the
    consensus Lyapunov quantity (0 when all nodes agree)."""
    buf, layout = flatten.flatten(params)
    return flatten.disagreement_flat(buf, layout.total)


def simulate_rounds(params: dict, eta: torch.Tensor, gamma,
                    rounds: int = 1):
    """Pure consensus iteration, no gradients: ``rounds`` applications of
    the eq. 5 operator ``A`` (kernel B2) to the packed buffer. Returns the
    params after the last round and the ``(rounds,)`` disagreement series,
    each entry measured on the buffer entering that round."""
    buf, layout = flatten.flatten(params)
    a = topology.consensus_matrix(eta.to(torch.float32), gamma)
    series = []
    for _ in range(rounds):
        series.append(flatten.disagreement_flat(buf, layout.total))
        buf = flatten.apply_matrix_flat(buf, a)
    ds = torch.stack(series) if series else buf.new_zeros((0,))
    return flatten.unflatten(buf, layout), ds


# --------------------------------------------------------------------------
# Mesh mode: ring consensus via permute_tensor over the fed group.
# --------------------------------------------------------------------------

def _ring_group(axis: str | Sequence[str], mesh):
    """``(process group, size)`` of the ring over the mesh dimensions
    ``axis``; several dimensions form one ring in mesh order (pod major on
    the two-pod mesh, so the ring crosses pods exactly twice)."""
    import torch.distributed as dist
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    if mesh is None:
        raise ValueError(f"the ring over {axes} needs the DeviceMesh that "
                         f"names them")
    if not dist.is_initialized():
        raise RuntimeError(f"the ring over {axes} needs a process group; "
                           f"none is initialized")
    sub = mesh[axes]
    if len(axes) > 1:
        sub = sub._flatten()
    return sub.get_group(), sub.size()


def _destinations(pairs, size: int) -> list:
    """(src, dst) pairs as ``permute_tensor``'s list: entry i is the
    destination of ring position i."""
    dst = [None] * size
    for src, to in pairs:
        dst[src] = to
    if None in dst:
        raise ValueError(f"ring pairs {pairs} do not cover {size} positions")
    return dst


def ring_neighbors(x: torch.Tensor, axis: str | Sequence[str], perms=None,
                   mesh=None):
    """Return (prev, next) copies of x from the ring neighbors along the
    named mesh dimension(s) (paper's N̄_k = {k-1, k+1} V2X exchange).

    ``perms``: optional precomputed (fwd, bwd) (src, dst) pair lists
    (see :func:`repro_torch.launch.mesh.fed_ring_perms`); derived from the
    ring's size when omitted. ``mesh``: the DeviceMesh whose dimensions
    ``axis`` names (port-only)."""
    return _ring_pass(x, x, axis, perms, mesh)


def _ring_pass(forward: torch.Tensor, backward: torch.Tensor,
               axis: str | Sequence[str], perms=None, mesh=None):
    """``forward`` sent to the next rank of the ring and ``backward`` to
    the previous one (port-only): returns (what the previous rank sent
    forward, what the next rank sent back). :func:`ring_neighbors` sends
    one tensor both ways; the mesh step sends a rank's last nodes forward
    and its first nodes back."""
    from torch.distributed._functional_collectives import permute_tensor
    group, size = _ring_group(axis, mesh)
    if perms is None:
        fwd = [(i, (i + 1) % size) for i in range(size)]
        bwd = [(i, (i - 1) % size) for i in range(size)]
    else:
        fwd, bwd = perms
    nxt = permute_tensor(forward.contiguous(), _destinations(fwd, size),
                         group)                               # from k-1
    prv = permute_tensor(backward.contiguous(), _destinations(bwd, size),
                         group)                               # from k+1
    return nxt, prv


def ring_consensus_shard(params, eta_prev: torch.Tensor,
                         eta_next: torch.Tensor, gamma,
                         axis: str | Sequence[str], *,
                         wire_dtype: str = "f32", shards: int = 1,
                         perms=None, mesh=None):
    """Eq. (5) on a physical ring: every fed rank holds ONE node's params
    (no leading K dim here).

    eta_prev/eta_next: this node's weights for its two ring neighbors
    (from the CND sketch exchange). The tree is packed ONCE into a
    lane-padded flat ``(P,)`` f32 vector and the whole exchange is one
    permute per direction per round (per column chunk), through
    :func:`repro_torch.core.transport.ring_exchange_shard`, which carries
    the wire codec and the column-chunked transfer."""
    from repro_torch.core import transport as _transport

    vec, layout = flatten.flatten_one(params)
    out = _transport.ring_exchange_shard(
        vec, eta_prev, eta_next, gamma, axis,
        wire_dtype=wire_dtype, shards=shards, perms=perms, mesh=mesh)
    return flatten.unflatten_one(out, layout)


def ring_sketch_exchange(ratio: torch.Tensor, axis: str | Sequence[str],
                         mesh=None):
    """Exchange CND distinct-ratios with the ring neighbors and normalize
    to eq. (6) weights: eta_i = r_i / (r_prev + r_next)."""
    r_prev, r_next = ring_neighbors(ratio, axis, mesh=mesh)
    denom = torch.clamp_min(r_prev + r_next, 1e-12)
    return r_prev / denom, r_next / denom
