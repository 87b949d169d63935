"""Public entry points of the B1-B7 kernels.

A CUDA tensor always goes to the hand-written kernel (which launches or
raises); a CPU tensor goes to the plain PyTorch version in
:mod:`repro_torch.kernels.ref`. Any other device raises. Higher layers
call these, never the kernel wrappers directly.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cluster_mix as _clm
from repro_torch.kernels import cnd_sketch as _cs
from repro_torch.kernels import consensus_mix as _cm
from repro_torch.kernels import ref
from repro_torch.kernels import robust_agg as _ra
from repro_torch.kernels import sparse_mix as _sm


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"repro_torch kernels run on cuda or cpu tensors, "
                     f"got {t.device}")


def flat_mix(eta, master, wire, gamma) -> torch.Tensor:
    """Fused eq. 5 delta mix on the flat buffer (B1):
    ``MASTER + gamma * (ETA @ WIRE - rowsum(ETA) * WIRE)``."""
    if _on_cuda(master):
        g = torch.as_tensor(gamma, dtype=torch.float32, device=master.device)
        return _cm.flat_mix(eta, master, wire, g.reshape(1))
    return ref.flat_mix(eta, master, wire, gamma)


def flat_consensus(matrix, buf) -> torch.Tensor:
    """``A @ BUF`` over the flat (K, P) buffer (B2)."""
    if _on_cuda(buf):
        return _cm.flat_consensus(matrix, buf)
    return ref.flat_consensus(matrix, buf)


def sparse_mix(idx, val, master, wire, gamma) -> torch.Tensor:
    """Top-D sparse eq. 5 delta mix on the flat buffer (B5):
    ``MASTER + gamma * (sum_d VAL W[IDX] - rowsum(VAL) * WIRE)``."""
    if _on_cuda(master):
        g = torch.as_tensor(gamma, dtype=torch.float32, device=master.device)
        return _sm.sparse_mix(idx, val, master, wire, g.reshape(1))
    return ref.sparse_mix(idx, val, master, wire, gamma)


def cluster_mix(idx, val, master, wself, wire, gamma_node) -> torch.Tensor:
    """Per-node-gamma cluster gather-mix (B6):
    ``MASTER + g[:, None] * (sum_d VAL W[IDX] - rowsum(VAL) * WSELF)``."""
    if _on_cuda(master):
        return _clm.cluster_mix(idx, val, master, wself, wire, gamma_node)
    return ref.cluster_mix(idx, val, master, wself, wire, gamma_node)


def robust_agg(weights, mask, buf, sent) -> torch.Tensor:
    """Coordinate-wise robust neighbor aggregation (B7):
    ``OUT[k] = sum_j weights[k, j] * sort_i({payload_i : mask[k, i]})[j]``,
    payload_i = ``sent[i]`` except the receiver's own slot ``buf[k]``."""
    if _on_cuda(buf):
        return _ra.robust_agg(weights, mask, buf, sent)
    return ref.robust_agg(weights, mask, buf, sent)


def cnd_bitmaps(items, num_hashes: int = 3, m: int = 8192) -> torch.Tensor:
    """CND bitmaps of (K, n, f) or (n, f) int32 feature tokens (B3)."""
    if _on_cuda(items):
        return _cs.cnd_bitmaps(items, num_hashes, m)
    return ref.cnd_bitmaps(items, num_hashes, m)


def cnd_popcount(bitmaps) -> torch.Tensor:
    """Set bits per bitmap, (..., H, W) -> (..., H) int32 (B4)."""
    if _on_cuda(bitmaps):
        return _cs.cnd_popcount(bitmaps)
    return ref.cnd_popcount(bitmaps)
