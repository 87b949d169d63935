"""Wrapper of the B9 ``flash_attention`` CUDA kernel
(``csrc/flash_attention.cu``), which replaces the Pallas kernel of
``src/repro/kernels/flash_attention.py``: online-softmax attention with
GQA, causal and sliding-window masks, q at position 0.

CUDA tensors only (see :mod:`repro_torch.kernels.consensus_mix` for the
conventions). The kernel has no backward, as the TPU kernel has none, so
the wrapper refuses inputs that require grad. The bf16 kernel reads q, k
and v through TMA, which needs 16-byte aligned tensors; the wrapper
refuses others (the f32 kernel takes any f32 view). It counts its
launches in its ``launches`` attribute, and apart by dtype in
``launches_f32`` and ``launches_bf16``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.consensus_mix import _check_cuda, _require, _stream

_LIB = "flash_attention"
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
HEAD_DIMS = (32, 64, 128)
# the f32 kernel's tiles (csrc/flash_attention.cu, namespace f32): a q tile
# is F32_ROWS flattened (position, head) rows of one (batch, kv head), row
# R being position R // G of query head kv_head * G + R % G; a block owns
# two q tiles and walks the keys in tiles of F32_KEYS, each cut into key
# chunks of f32_lanes(D) keys (a lane owns one key of each chunk)
F32_ROWS = 32
F32_KEYS = 64


def f32_lanes(d: int) -> int:
    """Lanes that share a row in the f32 kernel: 16, or 8 at D = 32."""
    return 16 if d >= 64 else 8


def f32_blocks(b: int, sq: int, h: int, kvh: int) -> list:
    """(batch, kv head, q tile, q tile) of each block of the f32 kernel,
    in block order: block x owns q tiles p and nt - 1 - p of the (batch,
    kv head) ``x % (B * KV)``, p = ``x // (B * KV)`` (the kernel's own
    formula), so the tile of the shortest causal rows rides with the tile
    of the longest; an odd middle tile rides alone."""
    nt = -(-sq * (h // kvh) // F32_ROWS)
    nbk = b * kvh
    return [((x % nbk) // kvh, (x % nbk) % kvh, x // nbk, nt - 1 - x // nbk)
            for x in range((nt + 1) // 2 * nbk)]


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window) -> tuple[int, int, int, int, int, int]:
    """Shape and dtype checks of B9; returns (B, Sq, Sk, H, KV, D)."""
    _require(q.dim() == 4 and k.dim() == 4,
             f"q and k must be (B, S, H, D), got {tuple(q.shape)} and "
             f"{tuple(k.shape)}")
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    _require(k.shape == (b, sk, kvh, d) and v.shape == k.shape,
             f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
             f"({b}, Sk, KV, {d})")
    _require(sk >= 1 and kvh >= 1 and h % kvh == 0,
             f"need Sk >= 1 and H={h} a multiple of KV={kvh}")
    _require(d in HEAD_DIMS, f"head dim {d} not supported {HEAD_DIMS}")
    _require(q.dtype in _SUFFIX,
             f"dtype {q.dtype} not supported (float32 or bfloat16)")
    _require(k.dtype == q.dtype and v.dtype == q.dtype,
             f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    _require(window is None or window >= 1,
             f"window must be None or >= 1, got {window}")
    return b, sq, sk, h, kvh, d


def check_aligned(**tensors: torch.Tensor) -> None:
    """TMA reads the bf16 kernel's q, k and v from 16-byte aligned
    addresses only (its ``out`` is always a fresh, aligned tensor): a
    view that starts inside its
    storage, at an offset that is not a multiple of 16 bytes, is refused
    (copy it with ``.clone()``)."""
    for name, t in tensors.items():
        off = t.data_ptr() % 16
        _require(off == 0, f"flash_attention: {name} must be 16-byte "
                           f"aligned for TMA, but starts {off} bytes past "
                           f"a 16-byte boundary (storage offset "
                           f"{t.storage_offset()})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None) -> torch.Tensor:
    """q (B, Sq, H, D); k/v (B, Sk, KV, D), contiguous, float32 or
    bfloat16, D in 32 | 64 | 128 -> (B, Sq, H, D) in q's dtype. Scale
    ``D**-0.5``; a key j is live for query i when ``j <= i`` (causal) and
    ``j > i - window`` (window). Any Sq and Sk."""
    _require(not (q.requires_grad or k.requires_grad or v.requires_grad),
             "flash_attention has no backward (nor has the TPU kernel it "
             "ports): pass tensors that do not require grad")
    dev = _check_cuda(q, k, v)
    b, sq, sk, h, kvh, d = check_args(q, k, v, window)
    out = torch.empty_like(q)
    if q.dtype == torch.bfloat16:
        check_aligned(q=q, k=k, v=v)
    if q.numel() == 0:
        return out
    fn = f"repro_flash_attention_{_SUFFIX[q.dtype]}"
    code = getattr(_build.library(_LIB), fn)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk,
        h, kvh, d, int(causal), -1 if window is None else int(window),
        d ** -0.5, _stream(dev))
    flash_attention.launches += 1
    name = f"launches_{_SUFFIX[q.dtype]}"
    setattr(flash_attention, name, getattr(flash_attention, name) + 1)
    _build.check(_LIB, fn, code)
    return out


flash_attention.launches = 0
flash_attention.launches_f32 = 0
flash_attention.launches_bf16 = 0
