"""Wrapper of the B7 ``robust_agg`` CUDA kernel (``csrc/robust_agg.cu``),
which replaces the Pallas kernel of ``src/repro/kernels/robust_agg.py``:
coordinate-wise trimmed-mean / median aggregation over each receiver's
masked neighbor payloads.

CUDA tensors only (see :mod:`repro_torch.kernels.consensus_mix` for the
conventions). The wrapper counts its launches in its ``launches``
attribute.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.consensus_mix import _check_cuda, _require, _stream

_LIB = "robust_agg"
_MAX_NODES = 1024
_COLS = 128         # the reference kernel's smallest column block


def check_args(weights: torch.Tensor, mask: torch.Tensor, buf: torch.Tensor,
               sent: torch.Tensor) -> tuple[int, int]:
    """Shape and dtype checks of B7; returns (K, P)."""
    _require(buf.dim() == 2, f"buf must be (K, P), got {tuple(buf.shape)}")
    k, p = buf.shape
    _require(1 <= k <= _MAX_NODES, f"K={k} outside [1, {_MAX_NODES}]")
    _require(weights.shape == (k, k) and mask.shape == (k, k),
             f"weights {tuple(weights.shape)} and mask "
             f"{tuple(mask.shape)} must be {(k, k)}")
    _require(sent.shape == buf.shape,
             f"sent {tuple(sent.shape)} != buf {tuple(buf.shape)}")
    _require(p % _COLS == 0, f"P={p} must be a multiple of {_COLS}")
    for name, t in (("weights", weights), ("mask", mask), ("buf", buf),
                    ("sent", sent)):
        _require(t.dtype == torch.float32, f"{name} must be float32")
    return k, p


def robust_agg(weights: torch.Tensor, mask: torch.Tensor, buf: torch.Tensor,
               sent: torch.Tensor) -> torch.Tensor:
    """``OUT[k] = sum_j weights[k, j] * sort_i({payload_i : mask[k, i]})[j]``.

    weights, mask (K, K) f32 with K <= 1024; buf, sent (K, P) f32 with P a
    multiple of 128 (the flat buffer's lane padding)."""
    dev = _check_cuda(weights, mask, buf, sent)
    k, p = check_args(weights, mask, buf, sent)
    lib = _build.library(_LIB)
    # the packed mask and W transposed by receiver group
    scratch = torch.empty((lib.repro_robust_agg_scratch_words(k),),
                          dtype=torch.int32, device=dev)
    out = torch.empty_like(buf)
    fn = "repro_robust_agg"
    code = lib.repro_robust_agg(
        weights.data_ptr(), mask.data_ptr(), buf.data_ptr(), sent.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), k, p, _stream(dev))
    robust_agg.launches += 1
    _build.check(_LIB, fn, code)
    return out


robust_agg.launches = 0
