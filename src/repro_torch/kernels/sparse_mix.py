"""Wrapper of the B5 ``sparse_mix`` CUDA kernel (``csrc/sparse_mix.cu``),
which replaces the Pallas kernel of ``src/repro/kernels/sparse_mix.py``.

CUDA tensors only (see :mod:`repro_torch.kernels.consensus_mix` for the
conventions). The wrapper counts its launches in its ``launches``
attribute. Indices are not range-checked here: the stacks are checked
once where they are built.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.consensus_mix import _check_cuda, _require, _stream

_LIB = "sparse_mix"
_MAX_DEGREE = 48 * 1024 // 8    # D indices + weights in the 48 KB of
                                # dynamic shared memory a launch gets
                                # without an opt-in
_WIRE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def check_gather_args(idx, val, master, wire) -> tuple[int, int, int]:
    """Shape and dtype checks shared by B5 and B6; returns (K, D, P)."""
    _require(master.dim() == 2, f"master must be (K, P), got {master.shape}")
    k, p = master.shape
    _require(idx.dim() == 2 and idx.shape[0] == k,
             f"idx {tuple(idx.shape)} must be (K={k}, D)")
    d = idx.shape[1]
    _require(1 <= d <= _MAX_DEGREE, f"degree {d} outside [1, {_MAX_DEGREE}]")
    _require(val.shape == idx.shape,
             f"val {tuple(val.shape)} != idx {tuple(idx.shape)}")
    _require(wire.shape == master.shape,
             f"wire {tuple(wire.shape)} != master {tuple(master.shape)}")
    _require(idx.dtype == torch.int32, "idx must be int32")
    _require(val.dtype == torch.float32 and master.dtype == torch.float32,
             "val and master must be float32")
    _require(wire.dtype in _WIRE_SUFFIX,
             f"wire dtype {wire.dtype} not supported (float32 or bfloat16)")
    return k, d, p


def sparse_mix(idx: torch.Tensor, val: torch.Tensor, master: torch.Tensor,
               wire: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """``OUT_k = M_k + gamma * (sum_d val[k,d] W[idx[k,d]] - rowsum_k W_k)``.

    idx (K, D) int32; val (K, D) f32; master (K, P) f32; wire (K, P) f32
    or bf16; gamma a one-element f32 tensor on the same device, read by
    the kernel (no host synchronization)."""
    dev = _check_cuda(idx, val, master, wire, gamma)
    k, d, p = check_gather_args(idx, val, master, wire)
    _require(gamma.numel() == 1 and gamma.dtype == torch.float32,
             "gamma must be one float32 value")
    fn = f"repro_sparse_mix_{_WIRE_SUFFIX[wire.dtype]}"
    out = torch.empty_like(master)
    lib = _build.library(_LIB)
    code = getattr(lib, fn)(idx.data_ptr(), val.data_ptr(),
                            master.data_ptr(), wire.data_ptr(),
                            gamma.data_ptr(), out.data_ptr(), k, d, p,
                            _stream(dev))
    sparse_mix.launches += 1
    _build.check(_LIB, fn, code)
    return out


sparse_mix.launches = 0
