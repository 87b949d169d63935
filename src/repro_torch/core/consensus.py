"""Consensus aggregation (paper eq. 5) on node-stacked parameter dicts, in
simulation: every leaf carries a leading node axis K, the dict is packed
into one flat ``(K, P)`` buffer (:mod:`repro_torch.core.flatten`) and the
consensus operator is one fused call over the whole buffer — kernel B1
for the eq. 5 delta mix, B2 for a precomposed ``A @ BUF`` — not one
product per leaf. Results come back as leaf views of the output buffer.

The JAX package's one-shot dispatch between a per-leaf and a flat form,
and its virtual-buffer CPU lowering, are XLA:CPU workarounds; the port
has the one flat path. The mesh-mode ring exchange (``ring_neighbors``,
``ring_consensus_shard``, ``ring_sketch_exchange``) comes with the
port's device mesh.
"""
from __future__ import annotations

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
