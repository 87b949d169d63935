"""Wrapper of the B10 ``rwkv6_scan`` CUDA kernel (``csrc/rwkv6_scan.cu``),
which replaces the Pallas kernel of ``src/repro/kernels/rwkv6_scan.py``:
the chunked RWKV6 wkv scan, here from an optional initial state.

CUDA tensors only (see :mod:`repro_torch.kernels.consensus_mix` for the
conventions). The kernel has no backward, as the TPU kernel has none, so
the wrapper refuses inputs that require grad. It counts its launches in
its ``launches`` attribute.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.consensus_mix import _check_cuda, _require, _stream

_LIB = "rwkv6_scan"
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
HEAD_SIZES = (16, 32, 64, 128)
CHUNKS = (16, 32, 64)


def check_args(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s0, chunk: int
               ) -> tuple[int, int, int, int]:
    """Shape and dtype checks of B10; returns (B, S, H, D)."""
    _require(r.dim() == 4, f"r must be (B, S, H, D), got {tuple(r.shape)}")
    b, seq, h, d = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        _require(t.shape == r.shape,
                 f"{name} {tuple(t.shape)} != r {tuple(r.shape)}")
    _require(u.shape == (h, d), f"u {tuple(u.shape)} != {(h, d)}")
    _require(s0 is None or s0.shape == (b, h, d, d),
             f"s0 {None if s0 is None else tuple(s0.shape)} != "
             f"{(b, h, d, d)}")
    _require(d in HEAD_SIZES, f"head size {d} not supported {HEAD_SIZES}")
    _require(chunk in CHUNKS, f"chunk {chunk} not supported {CHUNKS}")
    _require(seq % chunk == 0,
             f"sequence length {seq} is not a multiple of the chunk {chunk}")
    _require(r.dtype in _SUFFIX,
             f"dtype {r.dtype} not supported (float32 or bfloat16)")
    _require(k.dtype == r.dtype and v.dtype == r.dtype,
             f"r, k, v dtypes differ: {r.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("w", w), ("u", u), ("s0", s0)):
        _require(t is None or t.dtype == torch.float32,
                 f"{name} must be float32")
    return b, seq, h, d


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               s0: torch.Tensor | None = None,
               chunk: int = 16) -> tuple[torch.Tensor, torch.Tensor]:
    """r/k/v (B, S, H, D) float32 or bfloat16, w (B, S, H, D) float32,
    u (H, D) float32, s0 (B, H, D, D) float32 or None (zeros), all
    contiguous; D in 16 | 32 | 64 | 128, chunk in 16 | 32 | 64 dividing S
    -> (y (B, S, H, D) f32, final state (B, H, D, D) f32)."""
    _require(not any(t is not None and t.requires_grad
                     for t in (r, k, v, w, u, s0)),
             "rwkv6_scan has no backward (nor has the TPU kernel it "
             "ports): pass tensors that do not require grad")
    tensors = [r, k, v, w, u] + ([] if s0 is None else [s0])
    dev = _check_cuda(*tensors)
    b, seq, h, d = check_args(r, k, v, w, u, s0, chunk)
    y = torch.empty(r.shape, dtype=torch.float32, device=dev)
    sfin = torch.empty((b, h, d, d), dtype=torch.float32, device=dev)
    if b * h == 0:
        return y, sfin
    fn = f"repro_rwkv6_scan_{_SUFFIX[r.dtype]}"
    code = getattr(_build.library(_LIB), fn)(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        None if s0 is None else s0.data_ptr(), y.data_ptr(), sfin.data_ptr(),
        b, seq, h, d, chunk, _stream(dev))
    rwkv6_scan.launches += 1
    _build.check(_LIB, fn, code)
    return y, sfin


rwkv6_scan.launches = 0
