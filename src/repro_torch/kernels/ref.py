"""Plain PyTorch versions of the B1-B4 kernels: the CPU path of
:mod:`repro_torch.kernels.ops` and the yardstick the CUDA kernels are held
against on the card. Device-agnostic tensor code."""
from __future__ import annotations

import torch

from repro_torch.core import sketch as _sketch


def flat_mix(eta: torch.Tensor, master: torch.Tensor, wire: torch.Tensor,
             gamma) -> torch.Tensor:
    """``OUT = MASTER + gamma * (ETA @ WIRE - rowsum(ETA) * WIRE)`` with the
    wire upcast to f32 before the product."""
    eta32 = eta.float()
    w32 = wire.float()
    g = torch.as_tensor(gamma, dtype=torch.float32, device=master.device)
    row = eta32.sum(dim=1)
    mixed = eta32 @ w32
    return master + g.reshape(()) * (mixed - row[:, None] * w32)


def flat_consensus(matrix: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
    """``OUT = A @ BUF`` in f32."""
    return matrix.float() @ buf.float()


def cnd_bitmaps(items: torch.Tensor, num_hashes: int = 3,
                m: int = 8192) -> torch.Tensor:
    """Packed CND bitmaps — identical to the core sketch module."""
    return _sketch.build_bitmaps(items, num_hashes, m)


def cnd_popcount(bitmaps: torch.Tensor) -> torch.Tensor:
    return _sketch.set_bits(bitmaps)
