"""Wrappers of the B1 ``flat_mix``, B2 ``flat_consensus`` and B8
``consensus_mix`` CUDA kernels (``csrc/consensus_mix.cu``), which replace
the Pallas kernels of ``src/repro/kernels/consensus_mix.py``.

These wrappers take CUDA tensors only: they check device, dtype, shape
and contiguity, allocate the output with ``torch.empty``, launch on
PyTorch's current stream and raise on a CUDA error. The plain PyTorch
versions live in :mod:`repro_torch.kernels.ref`; :mod:`repro_torch.kernels.ops`
picks between the two by the tensor's device.

Each wrapper counts its launches in its ``launches`` attribute; B1 and B2
also count those with a variant axis in ``launches_variants``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_LIB = "consensus_mix"


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"CUDA kernel got a tensor on {t.device}; "
                             f"use repro_torch.kernels.ops for CPU tensors")
        _require(t.device == dev, "all tensors must be on one device")
        _require(t.is_contiguous(), "tensors must be contiguous")
    return dev


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _variants(eta: torch.Tensor, buf: torch.Tensor, what: str):
    """(V, K, P, eta_stride) of a (K, P) or (V, K, P) buffer and a (K, K)
    operator shared by every variant (stride 0) or (V, K, K), one a
    variant (stride K*K)."""
    _require(buf.dim() in (2, 3),
             f"{what} must be (K, P) or (V, K, P), got {tuple(buf.shape)}")
    v = buf.shape[0] if buf.dim() == 3 else 1
    k, p = buf.shape[-2:]
    _require(1 <= v <= 65535, f"{v} variants outside [1, 65535]")
    if eta.dim() == 2:
        _require(eta.shape == (k, k), f"eta {tuple(eta.shape)} != {(k, k)}")
        return v, k, p, 0
    _require(buf.dim() == 3 and eta.shape == (v, k, k),
             f"eta {tuple(eta.shape)} != {(k, k)} or {(v, k, k)}")
    return v, k, p, k * k


def flat_mix(eta: torch.Tensor, master: torch.Tensor, wire: torch.Tensor,
             gamma: torch.Tensor) -> torch.Tensor:
    """``OUT = MASTER + gamma * (ETA @ WIRE - rowsum(ETA) * WIRE)``.

    eta (K, K) f32; master (K, P) f32; wire (K, P) f32 or bf16; gamma a
    one-element f32 tensor on the same device. Accumulates in f32.

    With a variant axis, master and wire are (V, K, P), gamma holds V
    values and eta is (K, K), shared by every variant, or (V, K, K): one
    launch mixes all V, each variant as a V = 1 launch would, bit for
    bit."""
    dev = _check_cuda(eta, master, wire, gamma)
    v, k, p, eta_stride = _variants(eta, master, "master")
    _require(wire.shape == master.shape,
             f"wire {tuple(wire.shape)} != master {tuple(master.shape)}")
    _require(gamma.numel() == v, f"gamma must hold {v} value(s)")
    for name, t in (("eta", eta), ("master", master), ("gamma", gamma)):
        _require(t.dtype == torch.float32, f"{name} must be float32")
    if wire.dtype == torch.float32:
        fn = "repro_flat_mix_f32"
    elif wire.dtype == torch.bfloat16:
        fn = "repro_flat_mix_bf16"
    else:
        raise ValueError(f"wire dtype {wire.dtype} not supported "
                         f"(float32 or bfloat16)")
    out = torch.empty_like(master)
    lib = _build.library(_LIB)
    code = getattr(lib, fn)(eta.data_ptr(), master.data_ptr(),
                            wire.data_ptr(), gamma.data_ptr(),
                            out.data_ptr(), k, p, v, eta_stride, _stream(dev))
    flat_mix.launches += 1
    flat_mix.launches_variants += master.dim() == 3
    _build.check(_LIB, fn, code)
    return out


# launches, and those of them with a variant axis
flat_mix.launches = 0
flat_mix.launches_variants = 0


def flat_consensus(matrix: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
    """``OUT = A @ BUF`` for any (K, K) f32 operator and (K, P) f32 buffer,
    in full f32 (no tensor cores). With a variant axis, buf is (V, K, P)
    and the operator (K, K), shared, or (V, K, K)."""
    dev = _check_cuda(matrix, buf)
    v, k, p, a_stride = _variants(matrix, buf, "buf")
    _require(matrix.dtype == torch.float32 and buf.dtype == torch.float32,
             "flat_consensus takes float32 tensors")
    out = torch.empty_like(buf)
    lib = _build.library(_LIB)
    code = lib.repro_flat_consensus(matrix.data_ptr(), buf.data_ptr(),
                                    out.data_ptr(), k, p, v, a_stride,
                                    _stream(dev))
    flat_consensus.launches += 1
    flat_consensus.launches_variants += buf.dim() == 3
    _build.check(_LIB, "repro_flat_consensus", code)
    return out


flat_consensus.launches = 0
flat_consensus.launches_variants = 0


_MIX_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# eta and gamma staged in the 48 KB of dynamic shared memory a launch gets
# without an opt-in
_MAX_NEIGHBORS = 48 * 1024 // 4 - 1


def consensus_mix(w: torch.Tensor, neighbors: torch.Tensor, eta: torch.Tensor,
                  gamma: torch.Tensor) -> torch.Tensor:
    """``OUT = W + gamma * sum_i eta_i (NB_i - W)``, accumulated in f32 and
    returned in ``w``'s dtype.

    w (rows, L) and neighbors (N, rows, L), both float32 or both bfloat16;
    eta (N,) f32; gamma a one-element f32 tensor. eta and gamma are read
    by the kernel on the device (no host synchronization). Any N >= 1 and
    any rows."""
    dev = _check_cuda(w, neighbors, eta, gamma)
    _require(w.dim() == 2, f"w must be (rows, L), got {tuple(w.shape)}")
    _require(neighbors.dim() == 3 and neighbors.shape[1:] == w.shape,
             f"neighbors {tuple(neighbors.shape)} must be (N, "
             f"{w.shape[0]}, {w.shape[1]})")
    n = neighbors.shape[0]
    _require(1 <= n <= _MAX_NEIGHBORS,
             f"neighbor count {n} outside [1, {_MAX_NEIGHBORS}]")
    _require(eta.shape == (n,), f"eta {tuple(eta.shape)} != ({n},)")
    _require(gamma.numel() == 1, "gamma must hold one value")
    _require(eta.dtype == torch.float32 and gamma.dtype == torch.float32,
             "eta and gamma must be float32")
    _require(w.dtype in _MIX_SUFFIX,
             f"w dtype {w.dtype} not supported (float32 or bfloat16)")
    _require(neighbors.dtype == w.dtype,
             f"neighbors dtype {neighbors.dtype} != w dtype {w.dtype}")
    e = w.numel()
    _require(1 <= e < 2 ** 31, f"w holds {e} elements, outside [1, 2**31)")
    fn = f"repro_consensus_mix_{_MIX_SUFFIX[w.dtype]}"
    out = torch.empty_like(w)
    lib = _build.library(_LIB)
    code = getattr(lib, fn)(w.data_ptr(), neighbors.data_ptr(),
                            eta.data_ptr(), gamma.data_ptr(), out.data_ptr(),
                            n, e, _stream(dev))
    consensus_mix.launches += 1
    _build.check(_LIB, fn, code)
    return out


consensus_mix.launches = 0
