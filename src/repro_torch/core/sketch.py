"""CND — Counting Non-repeated Data (paper Algorithm 1) in PyTorch.

Each data item is hashed by ``num_hashes`` independent integer hash
functions into a bitmap of ``m`` bits; the number of distinct items is
estimated from the set-bit counts. A SimHash-style signature (weighted
feature bit votes, Alg. 1 lines 10-30) gives a compact record of the local
data distribution.

This module holds the plain formulation. PyTorch has no ``>>``, ``<<``,
``%`` or ``+`` for ``uint32`` on the CPU, so the hash runs in ``int64``
and masks to 32 bits after every multiply and add: the low 32 bits of a
wrapped 64-bit product are the 32-bit product. Bitmaps are ``int32``
tensors holding the ``uint32`` bit pattern. :func:`cardinality` counts
bits through :func:`repro_torch.kernels.ops.cnd_popcount` (the B4 kernel
on the card); the trainer builds its bitmaps through
:func:`repro_torch.kernels.ops.cnd_bitmaps` (B3), which gives the same
bits as :func:`build_bitmaps`.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops

# Distinct odd constants per hash round (xxhash/murmur-style primes).
_PRIMES = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1)
_MASK = 0xFFFFFFFF


def _mix32(x: torch.Tensor, seed: int) -> torch.Tensor:
    """xxhash-style 32-bit avalanche on int64 tensors holding values in
    [0, 2**32)."""
    x = x ^ ((seed * 0x9E3779B9 + 0x7F4A7C15) & _MASK)
    x = (x * _PRIMES[seed % len(_PRIMES)]) & _MASK
    x = x ^ (x >> 15)
    x = (x * 0x85EBCA77) & _MASK
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE3D) & _MASK
    return x ^ (x >> 16)


def _to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same bit pattern."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def hash_items(items: torch.Tensor, num_hashes: int, m: int) -> torch.Tensor:
    """Hash each item (row of int32 feature tokens) into ``num_hashes``
    bucket indices in [0, m).

    items: (..., n, f) integer feature tokens, read as uint32.
    Returns (..., num_hashes, n) int32 bucket ids."""
    x = items.to(torch.int64) & _MASK
    rows = []
    for s in range(num_hashes):
        h = torch.zeros(items.shape[:-1], dtype=torch.int64,
                        device=items.device)
        # order-dependent fold over features (rolling combine, final mix)
        for j in range(items.shape[-1]):
            h = _mix32((h * 31 + x[..., j]) & _MASK, s + j)
        rows.append(_mix32(h, 101 + s) % m)
    return torch.stack(rows, dim=-2).to(torch.int32)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., m) {0,1} -> (..., m // 32) int32 words holding the uint32 bit
    pattern (bit b of word w is bucket 32 * w + b; the lanes of a word are
    disjoint, so OR == sum)."""
    m = bits.shape[-1]
    words = bits.to(torch.int64).reshape(bits.shape[:-1] + (m // 32, 32))
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return _to_int32_bits((words << shifts).sum(dim=-1))


def build_bitmaps(items: torch.Tensor, num_hashes: int = 3,
                  m: int = 8192) -> torch.Tensor:
    """Paper Alg. 1 lines 1-5: set Bitmap[hash(item)] = 1 per hash fn.

    items (..., n, f) -> (..., num_hashes, m // 32) int32 packed bitmaps
    (bit b of word w is bucket 32 * w + b)."""
    if m % 32:
        raise ValueError(f"m must be a multiple of 32, got {m}")
    idx = hash_items(items, num_hashes, m).to(torch.int64)   # (..., H, n)
    bits = torch.zeros(idx.shape[:-1] + (m,), dtype=torch.int64,
                       device=items.device)
    bits.scatter_(-1, idx, 1)
    return _pack_bits(bits)


def build_bitmaps_onehot(items: torch.Tensor, num_hashes: int = 3,
                         m: int = 8192,
                         block_items: int = 256) -> torch.Tensor:
    """Scatter-free bitmap build: each bitmap position is a compare and an
    any-reduction over the items, ``block_items`` items at a time (the
    formulation of the TPU kernel). The same bits as
    :func:`build_bitmaps`."""
    if m % 32:
        raise ValueError(f"m must be a multiple of 32, got {m}")
    idx = hash_items(items, num_hashes, m)                   # (..., H, n)
    positions = torch.arange(m, dtype=torch.int32, device=items.device)
    bits = torch.zeros(idx.shape[:-1] + (m,), dtype=torch.bool,
                       device=items.device)
    for start in range(0, idx.shape[-1], block_items):
        chunk = idx[..., start:start + block_items]
        bits |= (chunk[..., None] == positions).any(dim=-2)
    return _pack_bits(bits)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-word population count of int32 bit patterns (SWAR)."""
    x = x.to(torch.int64) & _MASK
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & _MASK) >> 24).to(torch.int32)


def set_bits(bitmaps: torch.Tensor) -> torch.Tensor:
    """Number of set bits per bitmap: (..., H, W) -> (..., H) int32."""
    return popcount(bitmaps).sum(dim=-1).to(torch.int32)


def cardinality(bitmaps: torch.Tensor,
                estimator: str = "paper_mean") -> torch.Tensor:
    """Estimate the number of distinct items from (..., H, W) bitmaps.

    paper_mean      — Alg. 1 line 9: mean of per-bitmap set-bit counts.
    linear_counting — -m ln(z/m) (Whang et al.), corrects the collision
                      undercount at high load factors.

    A saturated sketch clamps to the estimator's ceiling (m for
    paper_mean, m·ln(m) for linear_counting), and a zero-size sketch
    estimates 0. Leading dims (one per node) are kept."""
    if estimator not in ("paper_mean", "linear_counting"):
        raise ValueError(f"unknown estimator {estimator!r}")
    lead = bitmaps.shape[:-2]
    if bitmaps.numel() == 0:                              # H==0 or m==0
        return torch.zeros(lead, dtype=torch.float32, device=bitmaps.device)
    m = torch.tensor(float(bitmaps.shape[-1] * 32), dtype=torch.float32,
                     device=bitmaps.device)
    counts = ops.cnd_popcount(bitmaps.contiguous()).to(torch.float32)
    # the mean over the H bitmaps is the sum times the f32 reciprocal of
    # H: XLA compiles the JAX package's mean that way, and the ratios of
    # the two packages then agree bit for bit
    inv_h = torch.tensor(1.0 / counts.shape[-1], dtype=torch.float32,
                         device=bitmaps.device)
    if estimator == "paper_mean":
        return torch.minimum(counts.sum(dim=-1) * inv_h, m)
    z = torch.clamp_min(m - counts, 1.0)                  # zero bits
    cap = m * torch.log(torch.clamp_min(m, 2.0))          # z=1 ceiling
    return torch.minimum((-m * torch.log(z / m)).sum(dim=-1) * inv_h, cap)


def union_cardinality(bm_a: torch.Tensor, bm_b: torch.Tensor,
                      estimator: str = "paper_mean") -> torch.Tensor:
    """|A ∪ B| from the OR of the bitmaps: how much of a neighbor's data is
    new to a node (paper Sec. 4.3)."""
    return cardinality(bm_a | bm_b, estimator)


def difference_estimate(bm_self: torch.Tensor, bm_other: torch.Tensor,
                        estimator: str = "paper_mean") -> torch.Tensor:
    """Estimated count of the neighbor's items NOT present locally:
    |A ∪ B| − |A| ≈ |B \\ A|."""
    return (union_cardinality(bm_self, bm_other, estimator)
            - cardinality(bm_self, estimator))


def simhash(features: torch.Tensor, weights: torch.Tensor | None = None,
            n_bits: int = 64) -> torch.Tensor:
    """Weighted SimHash over a set of feature tokens (Alg. 1 lines 10-30).

    features: (n, f) int32 feature tokens; weights: (n, f) f32 feature
    weights (default 1). Returns the (n_bits,) int32 {0, 1} signature: bit
    j is set when the weighted votes of the features' hash bit j are
    positive."""
    feats = features.reshape(-1).to(torch.int64) & _MASK
    if weights is None:
        w = torch.ones(feats.shape, dtype=torch.float32,
                       device=features.device)
    else:
        w = weights.reshape(-1).to(torch.float32)
    shifts = torch.arange(32, dtype=torch.int64, device=features.device)
    bits64 = torch.cat(
        [(_mix32(feats, 7)[:, None] >> shifts) & 1,
         (_mix32(feats, 11)[:, None] >> shifts) & 1],
        dim=1)[:, :n_bits].to(torch.float32)                # (N, n_bits)
    votes = ((2.0 * bits64 - 1.0) * w[:, None]).sum(dim=0)
    return (votes > 0).to(torch.int32)


def signature_distance(sig_a: torch.Tensor,
                       sig_b: torch.Tensor) -> torch.Tensor:
    """Hamming distance between signatures: distribution dissimilarity."""
    return torch.sum(torch.abs(sig_a - sig_b))


def sketch_dataset(items: torch.Tensor, num_hashes: int = 3, m: int = 8192,
                   sig_bits: int = 64) -> dict:
    """Full CND sketch of one node's (n, f) dataset: bitmaps, signature
    and size."""
    return {
        "bitmaps": build_bitmaps(items, num_hashes, m),
        "signature": simhash(items, n_bits=sig_bits),
        "total": torch.tensor(items.shape[0], dtype=torch.int32,
                              device=items.device),
    }


def distinct_ratio(sketch: dict,
                   estimator: str = "paper_mean") -> torch.Tensor:
    """Ë_k = E_k' / E_k (paper eq. 7): estimated distinct / total, from a
    sketch ``{"bitmaps": (..., H, W), "total": (...)}``."""
    est = cardinality(sketch["bitmaps"], estimator)
    total = torch.clamp_min(
        torch.as_tensor(sketch["total"], device=est.device).to(torch.float32),
        1.0)
    return torch.clamp(est / total, 0.0, 1.0)


def expected_load_factor(n_distinct: int, m: int) -> float:
    """E[set bits] / m for n distinct balls in m bins (analysis helper)."""
    return 1.0 - math.exp(-n_distinct / m)
