"""Redundancy scenario generators -> per-node item streams.

A redundancy scenario rewrites WHICH item each dataset slot holds:
``compile_plan`` produces a round-invariant ``(K, N)`` slot -> source item
map (host-side numpy, once per run; a copy of the JAX package's, identical
arrays) and ``apply_plan`` gathers the node datasets through it (one
gather per leaf). The streaming sketches then see the true item
identities via the plan's global ``item_ids`` (shared or duplicated items
share an id), so redundancy is ESTIMATED on the stream, never read off the
generator.

Generators are :data:`repro_torch.registry.redundancy_scenarios` plugins:
``gen(plan, cfg, rng, k, n)`` mutates the plan dict in place; per-scenario
rngs decorrelate via ``SeedSequence([seed, crc32(name)])`` so adding a
scenario never perturbs another's stream. Everything is deterministic in
``IngestConfig.seed`` and independent of run segmentation.
"""
from __future__ import annotations

import zlib
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.registry import redundancy_scenarios


class IngestPlan(NamedTuple):
    """Compiled redundancy scenario (host-side numpy, static per run)."""
    src_node: np.ndarray   # (K, N) int32 source node per slot
    src_slot: np.ndarray   # (K, N) int32 source slot per slot
    item_ids: np.ndarray   # (K, N) int32 global item identity per slot


def _rng(seed: int, kind: str) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, zlib.crc32(kind.encode())]))


def _affected(cfg, k: int, default) -> tuple[int, ...]:
    nodes = tuple(cfg.affected) if cfg.affected else tuple(default)
    bad = [i for i in nodes if not 0 <= i < k]
    if bad:
        raise ValueError(f"IngestConfig.affected indices {bad} out of "
                         f"range for num_nodes={k}")
    return nodes


@redundancy_scenarios.register("duplicate_heavy")
def duplicate_heavy(plan: dict, cfg, rng, k: int, n: int) -> None:
    """Affected nodes keep a small distinct pool and fill the rest of
    their stream with duplicates drawn from it: ``duplicate_fraction`` of
    the slots are copies, so the pool holds ``(1 - fraction) * n`` distinct
    items. Default affected set: the second half of the fleet."""
    nodes = _affected(cfg, k, range(k // 2, k))
    pool = max(1, int(round((1.0 - cfg.duplicate_fraction) * n)))
    for node in nodes:
        dup = rng.integers(0, pool, size=max(0, n - pool))
        plan["src_slot"][node] = np.concatenate(
            [np.arange(pool), dup]).astype(np.int32)


@redundancy_scenarios.register("sensor_overlap")
def sensor_overlap(plan: dict, cfg, rng, k: int, n: int) -> None:
    """Platoon neighbors share a sliding window of items: node k's first
    ``overlap_window`` slots hold the TAIL of its predecessor's stream (two
    vehicles driving the same road segment record the same scene). Each
    node stays duplicate-free internally, but the fleet's union is smaller
    than the sum of its parts."""
    nodes = _affected(cfg, k, range(k))
    win = min(cfg.overlap_window, n)
    for node in nodes:
        src = (node - 1) % k
        if src == node:
            continue
        plan["src_node"][node, :win] = src
        plan["src_slot"][node, :win] = np.arange(n - win, n)


@redundancy_scenarios.register("skewed_multiset")
def skewed_multiset(plan: dict, cfg, rng, k: int, n: int) -> None:
    """Zipf-skewed item frequencies: slot j's item is drawn with
    probability proportional to ``(j+1)^-zipf_alpha``, so a few items
    dominate each affected node's stream while the tail stays distinct."""
    nodes = _affected(cfg, k, range(k))
    p = (np.arange(1, n + 1, dtype=np.float64) ** -cfg.zipf_alpha)
    p /= p.sum()
    for node in nodes:
        plan["src_slot"][node] = rng.choice(n, size=n, p=p).astype(np.int32)


def compile_plan(cfg, k: int, n: int) -> IngestPlan:
    """Compile the scenario into the (K, N) slot -> item map: the identity
    map first, then the registered generator mutates it. The global
    item-id space is ``source_node * n + source_slot``, so items shared
    across slots (or nodes) share an id, the identity the streaming
    sketches hash."""
    plan = {
        "src_node": np.repeat(np.arange(k, dtype=np.int32)[:, None],
                              n, axis=1),
        "src_slot": np.repeat(np.arange(n, dtype=np.int32)[None, :],
                              k, axis=0),
    }
    gen = redundancy_scenarios.get(cfg.scenario)
    gen(plan, cfg, _rng(cfg.seed, cfg.scenario), k, n)
    src_node = plan["src_node"].astype(np.int32)
    src_slot = plan["src_slot"].astype(np.int32)
    if src_node.shape != (k, n) or src_slot.shape != (k, n):
        raise ValueError(f"scenario {cfg.scenario!r} produced map shapes "
                         f"{src_node.shape}/{src_slot.shape} != {(k, n)}")
    if (src_slot < 0).any() or (src_slot >= n).any() \
            or (src_node < 0).any() or (src_node >= k).any():
        raise ValueError(f"scenario {cfg.scenario!r} produced out-of-range "
                         f"source indices")
    item_ids = (src_node.astype(np.int64) * n + src_slot).astype(np.int32)
    return IngestPlan(src_node=src_node, src_slot=src_slot,
                      item_ids=item_ids)


def apply_plan(data: dict, plan: IngestPlan) -> dict:
    """Materialize the redundant per-node streams: one gather per leaf.

    data: a dict of (K, N, ...) tensors, gathered on their device. Applied
    once per ``run_rounds`` call to the ORIGINAL datasets, so it is
    idempotent across the segments of a run."""
    out = {}
    for name, arr in data.items():
        node = torch.as_tensor(plan.src_node, device=arr.device).long()
        slot = torch.as_tensor(plan.src_slot, device=arr.device).long()
        out[name] = arr[node, slot]
    return out
