"""Wrappers of the B3 ``cnd_bitmaps`` and B4 ``cnd_popcount`` CUDA kernels
(``csrc/cnd_sketch.cu``), which replace the Pallas kernels of
``src/repro/kernels/cnd_sketch.py``.

CUDA tensors only (see :mod:`repro_torch.kernels.consensus_mix` for the
conventions). Bitmaps are ``int32`` tensors holding the ``uint32`` bit
pattern of the reference's bitmaps. Each wrapper counts its launches in
its ``launches`` attribute.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.consensus_mix import _check_cuda, _require, _stream

_LIB = "cnd_sketch"
_MAX_SHARED = 48 * 1024        # static launch limit without opt-in


def cnd_bitmaps(items: torch.Tensor, num_hashes: int = 3,
                m: int = 8192) -> torch.Tensor:
    """Algorithm 1 lines 1-5 for every node in one launch: items
    (K, n, f) int32 -> (K, num_hashes, m // 32) int32 bitmaps. A 2-D
    ``(n, f)`` input is one node and returns ``(num_hashes, m // 32)``."""
    dev = _check_cuda(items)
    _require(items.dtype == torch.int32, "items must be int32")
    _require(items.dim() in (2, 3), f"items must be (K, n, f) or (n, f), "
                                    f"got {tuple(items.shape)}")
    _require(m > 0 and m % 32 == 0, f"m must be a positive multiple of 32, "
                                    f"got {m}")
    _require(num_hashes >= 1, "num_hashes must be >= 1")
    _require(num_hashes * m // 8 <= _MAX_SHARED,
             f"{num_hashes} bitmaps of {m} bits exceed the "
             f"{_MAX_SHARED}-byte shared-memory tile")
    single = items.dim() == 2
    batched = items[None] if single else items
    k, n, f = batched.shape
    _require(n >= 1 and f >= 1, "need at least one item and one feature")
    out = torch.empty((k, num_hashes, m // 32), dtype=torch.int32,
                      device=dev)
    lib = _build.library(_LIB)
    code = lib.repro_cnd_bitmaps(batched.data_ptr(), out.data_ptr(), k, n,
                                 f, num_hashes, m, _stream(dev))
    cnd_bitmaps.launches += 1
    _build.check(_LIB, "repro_cnd_bitmaps", code)
    return out[0] if single else out


cnd_bitmaps.launches = 0


def cnd_popcount(bitmaps: torch.Tensor) -> torch.Tensor:
    """Set bits per bitmap: (..., H, W) int32 -> (..., H) int32."""
    dev = _check_cuda(bitmaps)
    _require(bitmaps.dtype == torch.int32, "bitmaps must be int32")
    _require(bitmaps.dim() >= 1 and bitmaps.shape[-1] >= 1,
             f"bitmaps must be (..., W) with W >= 1, "
             f"got {tuple(bitmaps.shape)}")
    words = bitmaps.shape[-1]
    rows = bitmaps.numel() // words
    out = torch.empty(bitmaps.shape[:-1], dtype=torch.int32, device=dev)
    if rows == 0:
        return out
    lib = _build.library(_LIB)
    code = lib.repro_cnd_popcount(bitmaps.data_ptr(), out.data_ptr(), rows,
                                  words, _stream(dev))
    cnd_popcount.launches += 1
    _build.check(_LIB, "repro_cnd_popcount", code)
    return out


cnd_popcount.launches = 0
