"""Streaming redundancy sketches: rolling count-min + HyperLogLog.

One :class:`SketchState` per run holds the per-node estimators:
``(K, H, W)`` count-min counters and ``(K, M)`` HLL registers on the
device next to the flat ``(K, P)`` parameter buffer. They ride the
trainer's state from round to round, so the ingest path is a few
scatter-adds and register-maxes a round, with no host sync and no hashing
inside the round loop.

A redundancy scenario's slot -> item map is round-invariant
(:func:`repro_torch.ingest.scenarios.compile_plan`), so every slot's sketch
coordinates (count-min bucket per hash row, HLL register index and rank)
are computed ONCE per run into a :class:`SlotHashes` table with the CND
sketch's ``_mix32`` avalanche; a round gathers the sampled slots' rows.

Estimators follow the standard literature:
* count-min (Cormode & Muthukrishnan): point update ``cm[h, b_h] += 1``,
  point query ``min_h cm[h, b_h]``, an overestimate-only multiplicity
  bound absent decay; ``decay < 1`` ages the counters every round.
* HyperLogLog (Flajolet et al. 2007): register ``h & (M-1)``, rank = the
  leading-zero run of the remaining bits + 1, bias-corrected harmonic
  mean with the small-range linear-counting correction.

Every function takes leading batch axes before the node axis (a ``(V,)``
variant axis in batched sweeps). The count-min update adds each bucket's
integer hit count of the round in one f32 add, so it is deterministic on
the card: the JAX package adds 1.0 once per hit, which gives the same
counts while ``decay == 1`` (whole numbers below 2**24) and may differ in
the last bit once ``decay < 1``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.sketch import _mix32
from repro_torch.device import resolve_device


class SketchState(NamedTuple):
    """Per-node rolling sketches (ride the trainer's state)."""
    cm: torch.Tensor      # (..., K, H, W) f32 count-min counters
    hll: torch.Tensor     # (..., K, M) int32 HyperLogLog registers
    seen: torch.Tensor    # (..., K) f32 total items streamed so far


class SlotHashes(NamedTuple):
    """Precomputed sketch coordinates per dataset slot (static per run)."""
    buckets: torch.Tensor  # (K, N, H) int64 count-min bucket per hash row
    regs: torch.Tensor     # (K, N) int64 HLL register index
    rhos: torch.Tensor     # (K, N) int32 HLL rank (leading-zero run + 1)


def init_state(k: int, cfg, device=None) -> SketchState:
    """Empty sketches for ``k`` nodes (shapes from the IngestConfig)."""
    dev = resolve_device(device)
    return SketchState(
        cm=torch.zeros((k, cfg.cm_hashes, cfg.cm_width),
                       dtype=torch.float32, device=dev),
        hll=torch.zeros((k, cfg.hll_registers), dtype=torch.int32,
                        device=dev),
        seen=torch.zeros((k,), dtype=torch.float32, device=dev))


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of int64 values in [0, 2**32) read as uint32 (32 for
    zero), by a shift ladder: torch has no clz."""
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        small = x < (1 << (32 - s))           # the top s bits are clear
        n = n + torch.where(small, s, 0)
        x = torch.where(small, x << s, x)
    return n + (x == 0).to(n.dtype)


def slot_hashes(item_ids: torch.Tensor, cfg) -> SlotHashes:
    """Hash every slot's item id once, for the whole run.

    item_ids: (K, N) int32 global item identities (shared or duplicated
    items share an id, :func:`repro_torch.ingest.scenarios.compile_plan`).
    The uint32 arithmetic runs in int64 masked to 32 bits."""
    ids = torch.as_tensor(item_ids).to(torch.int64) & 0xFFFFFFFF
    w = cfg.cm_width
    buckets = torch.stack([_mix32(ids, 211 + j) % w
                           for j in range(cfg.cm_hashes)], dim=-1)
    m = cfg.hll_registers
    log2m = int(m).bit_length() - 1
    h0 = _mix32(ids, 131)
    regs = h0 & (m - 1)
    # rank of the remaining 32 - log2m bits: h0 >> log2m has its top log2m
    # bits clear, so clz - log2m + 1 lies in [1, 32 - log2m + 1], the
    # all-zero tail mapping to the largest rank (clz(0) = 32)
    rhos = (_clz32(h0 >> log2m) - log2m + 1).to(torch.int32)
    return SlotHashes(buckets=buckets, regs=regs, rhos=rhos)


def _per_node(table: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """``table[k, flat[..., k, j]]`` for a (K, N, ...) slot table and
    (..., K, J) slot indices: (..., K, J, ...)."""
    rows = torch.arange(table.shape[0], device=flat.device)[:, None]
    return table[rows, flat]


def update(state: SketchState, sh: SlotHashes, idx: torch.Tensor,
           decay: float = 1.0) -> SketchState:
    """Fold one round's sampled minibatches into the rolling sketches.

    idx: (..., K, S, B) per-node sampled slot indices (the indices the
    local steps train on). ``decay`` < 1 ages the count-min counters
    before the fold; the HLL registers are monotone and never decay."""
    flat = idx.flatten(-2).long()                         # (..., K, J)
    cm = state.cm
    lead, (h, w) = cm.shape[:-2], cm.shape[-2:]
    # each (node, row, bucket) counter's integer hits this round, then one
    # f32 add: integer atomics give the same counts in any order
    node = torch.arange(cm.numel() // (h * w), device=cm.device)
    lin = ((node.view(lead + (1, 1)) * h
            + torch.arange(h, device=cm.device)) * w
           + _per_node(sh.buckets, flat))                 # (..., K, J, H)
    hits = torch.zeros(cm.numel(), dtype=torch.int64, device=cm.device)
    hits.scatter_add_(0, lin.reshape(-1), torch.ones_like(lin).reshape(-1))
    if decay != 1.0:
        cm = cm * decay
    cm = cm + hits.view(cm.shape).to(torch.float32)
    hll = state.hll.scatter_reduce(-1, _per_node(sh.regs, flat),
                                   _per_node(sh.rhos, flat), reduce="amax")
    return SketchState(cm=cm, hll=hll,
                       seen=state.seen + float(flat.shape[-1]))


def hll_cardinality(hll: torch.Tensor) -> torch.Tensor:
    """(..., K, M) registers -> (..., K) estimated distinct counts.

    Bias-corrected harmonic mean (alpha_M * M^2 / sum 2^-reg) with the
    small-range linear-counting correction (estimate <= 2.5M with empty
    registers). The 32-bit large-range correction is omitted: fleet
    datasets are orders of magnitude below 2**32 distinct items."""
    m = hll.shape[-1]
    if m >= 128:
        alpha = 0.7213 / (1.0 + 1.079 / m)
    elif m >= 64:
        alpha = 0.709
    elif m >= 32:
        alpha = 0.697
    else:
        alpha = 0.673
    # the constants divide as f32 tensors: a Python number over a tensor
    # would be its reciprocal times the number, rounded twice
    inv = torch.exp2(-hll.to(torch.float32)).sum(dim=-1)
    raw = torch.full_like(inv, alpha * m * m) / inv
    zeros = (hll == 0).sum(dim=-1).to(torch.float32)
    small = m * torch.log(torch.full_like(zeros, m)
                          / torch.clamp_min(zeros, 1.0))
    use_small = (raw <= 2.5 * m) & (zeros > 0)
    return torch.where(use_small, small, raw)


def multiplicity(cm: torch.Tensor, buckets: torch.Tensor) -> torch.Tensor:
    """Per-slot multiplicity estimates from the count-min counters.

    cm: (..., K, H, W); buckets: (K, N, H) slot bucket table. Returns
    (..., K, N): the min over hash rows, so estimates only ever OVERcount
    (collisions add, never subtract) absent decay."""
    b = buckets.permute(0, 2, 1)                          # (K, H, N)
    b = b.expand(cm.shape[:-1] + b.shape[-1:])
    return torch.gather(cm, -1, b).amin(dim=-2)
