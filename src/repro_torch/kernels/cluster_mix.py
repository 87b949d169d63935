"""Wrapper of the B6 ``cluster_mix`` CUDA kernel (``csrc/sparse_mix.cu``),
which replaces the Pallas kernel of ``src/repro/kernels/cluster_mix.py``:
the B5 gather with a per-node step size and a separate self payload.

CUDA tensors only (see :mod:`repro_torch.kernels.consensus_mix` for the
conventions). The wrapper counts its launches in its ``launches``
attribute.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.consensus_mix import _check_cuda, _require, _stream
from repro_torch.kernels.sparse_mix import _LIB, _WIRE_SUFFIX, \
    check_gather_args


def cluster_mix(idx: torch.Tensor, val: torch.Tensor, master: torch.Tensor,
                wself: torch.Tensor, wire: torch.Tensor,
                gamma_node: torch.Tensor) -> torch.Tensor:
    """``OUT_k = M_k + g[k] * (sum_d val[k,d] W[idx[k,d]] - rowsum_k
    WSELF_k)``.

    As :func:`repro_torch.kernels.sparse_mix.sparse_mix`, plus wself
    (K, P) of the wire's dtype and gamma_node (K,) f32."""
    dev = _check_cuda(idx, val, master, wself, wire, gamma_node)
    k, d, p = check_gather_args(idx, val, master, wire)
    _require(wself.shape == wire.shape and wself.dtype == wire.dtype,
             f"wself {tuple(wself.shape)} {wself.dtype} must match the "
             f"wire {tuple(wire.shape)} {wire.dtype}")
    _require(gamma_node.shape == (k,) and gamma_node.dtype == torch.float32,
             f"gamma_node must be ({k},) float32")
    fn = f"repro_cluster_mix_{_WIRE_SUFFIX[wire.dtype]}"
    out = torch.empty_like(master)
    lib = _build.library(_LIB)
    code = getattr(lib, fn)(idx.data_ptr(), val.data_ptr(),
                            master.data_ptr(), wself.data_ptr(),
                            wire.data_ptr(), gamma_node.data_ptr(),
                            out.data_ptr(), k, d, p, _stream(dev))
    cluster_mix.launches += 1
    _build.check(_LIB, fn, code)
    return out


cluster_mix.launches = 0
