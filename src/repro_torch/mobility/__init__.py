"""Vehicular mobility: time-varying consensus topologies, in three stages
(the twin of the JAX package's ``repro.mobility``)::

    positions  = traces.trace(kind, R, K, ...)          # (R, K, 2), numpy
    adj_stack  = links.radio_adjacency(positions, rng)  # (R, K, K), numpy
    etas       = mixing.eta_stack(adj_stack, rule, ...) # (R, K, K), torch

:func:`scenario_stacks` and :func:`sparse_scenario_stacks` compose them
from a :class:`repro_torch.configs.base.MobilityConfig`; the trainer
consumes one round's slice per round. Traces and links are host numpy,
built once per run; the stacks live on the device of the CND ratios.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import MobilityConfig
from repro_torch.mobility import links, mixing, traces
from repro_torch.mobility.links import (degree_stats, handover_stats,
                                        num_components, radio_adjacency,
                                        sparse_radio_stack)
from repro_torch.mobility.mixing import (constant_sparse_stacks,
                                         constant_stacks, eta_stack,
                                         gamma_stack, masked_eta_stack,
                                         masked_sparse_stack,
                                         sparse_eta_stack,
                                         sparse_gamma_stack,
                                         stack_variant_stacks)
from repro_torch.mobility.traces import trace

__all__ = [
    "MobilityConfig", "adjacency_stack", "scenario_stacks",
    "sparse_scenario_stacks", "trace", "radio_adjacency",
    "sparse_radio_stack", "handover_stats", "degree_stats",
    "num_components", "eta_stack", "gamma_stack", "sparse_eta_stack",
    "sparse_gamma_stack", "constant_stacks", "constant_sparse_stacks",
    "masked_eta_stack", "masked_sparse_stack", "stack_variant_stacks",
    "links", "mixing", "traces",
]


def _positions(mob: MobilityConfig, rounds: int, k: int,
               start: int) -> np.ndarray:
    """Rounds ``[start, start + rounds)`` of the scenario's trace,
    generated from round 0 so a resumed run continues the same
    trajectory."""
    return trace(mob.kind, start + rounds, k, speed=mob.speed,
                 speed_jitter=mob.speed_jitter, area=mob.area, dt=mob.dt,
                 seed=mob.seed)[start:]


def adjacency_stack(mob: MobilityConfig, rounds: int, k: int,
                    mask: np.ndarray | None = None,
                    start: int = 0) -> np.ndarray:
    """(R, K, K) link-weight stack for a mobility scenario; ``mask``: an
    optional static 0/1 adjacency intersected with every round."""
    adj = radio_adjacency(_positions(mob, rounds, k, start), mob.radio_range,
                          link_quality=mob.link_quality,
                          min_quality=mob.min_quality)
    if mask is not None:
        adj = adj * np.asarray(mask, np.float32)[None]
    return adj


def scenario_stacks(mob: MobilityConfig, rounds: int, k: int, *, rule: str,
                    gamma_cap: float, ratios=None, sizes=None,
                    mask: np.ndarray | None = None, start: int = 0):
    """trace -> links -> mixing: ``(etas (R, K, K), gammas (R,))`` for
    rounds ``[start, start + rounds)``."""
    adj = adjacency_stack(mob, rounds, k, mask=mask, start=start)
    etas = eta_stack(adj, rule, ratios=ratios, sizes=sizes)
    return etas, gamma_stack(etas, gamma_cap)


def sparse_scenario_stacks(mob: MobilityConfig, rounds: int, k: int, *,
                           rule: str, gamma_cap: float, degree: int,
                           ratios=None, sizes=None,
                           mask: np.ndarray | None = None, start: int = 0):
    """The sparse twin of :func:`scenario_stacks`: trace -> top-``degree``
    link rows -> sparse mixing, never materializing an (R, K, K) stack.
    Returns ``(SparseEta (R, K, D), gammas (R,))``."""
    idx, val = sparse_radio_stack(_positions(mob, rounds, k, start),
                                  mob.radio_range, degree,
                                  link_quality=mob.link_quality,
                                  min_quality=mob.min_quality, mask=mask)
    sp = sparse_eta_stack(idx, val, rule, ratios=ratios, sizes=sizes)
    return sp, sparse_gamma_stack(sp, gamma_cap)
