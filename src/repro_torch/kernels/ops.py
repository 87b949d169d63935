"""Public entry points of the B1-B10 kernels.

A CUDA tensor always goes to the hand-written kernel (which launches or
raises); a CPU tensor goes to the plain PyTorch version in
:mod:`repro_torch.kernels.ref`, and so does a meta tensor inside
:func:`shapes_only` (the dry run). Any other device raises. Higher layers
call these, never the kernel wrappers directly.

B9 and B10 have no backward kernel, as the TPU kernels have none: the JAX
package trains its models by differentiating their plain arithmetic. When
grad is enabled and an input requires grad, :func:`flash_attention` and
:func:`rwkv6_scan` go through a ``torch.autograd.Function`` whose forward
dispatches as above on detached inputs (so a training forward on the card
launches the kernel) and whose backward recomputes the plain version and
differentiates it.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import cluster_mix as _clm
from repro_torch.kernels import cnd_sketch as _cs
from repro_torch.kernels import consensus_mix as _cm
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import robust_agg as _ra
from repro_torch.kernels import rwkv6_scan as _rw
from repro_torch.kernels import sparse_mix as _sm


_SHAPES_ONLY = False


@contextlib.contextmanager
def shapes_only():
    """Within, a meta tensor takes the plain version too: shapes and
    dtypes, no data (the dry run, ``launch/dryrun.py``). Outside, a meta
    tensor raises like any device but CUDA and the CPU."""
    global _SHAPES_ONLY
    prev, _SHAPES_ONLY = _SHAPES_ONLY, True
    try:
        yield
    finally:
        _SHAPES_ONLY = prev


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu" or _SHAPES_ONLY and t.device.type == "meta":
        return False
    raise ValueError(f"repro_torch kernels run on cuda or cpu tensors, "
                     f"got {t.device}")


def flat_mix(eta, master, wire, gamma) -> torch.Tensor:
    """Fused eq. 5 delta mix on the flat buffer (B1):
    ``MASTER + gamma * (ETA @ WIRE - rowsum(ETA) * WIRE)``. With a variant
    axis: master and wire (V, K, P), eta (K, K) shared or (V, K, K), gamma
    (V,)."""
    if _on_cuda(master):
        g = torch.as_tensor(gamma, dtype=torch.float32,
                            device=master.device).reshape(-1).contiguous()
        return _cm.flat_mix(eta, master, wire, g)
    return ref.flat_mix(eta, master, wire, gamma)


def consensus_mix(w, neighbors, eta, gamma) -> torch.Tensor:
    """One node's fused mix with its N neighbor copies (B8):
    ``W + gamma * sum_i eta_i (NB_i - W)`` for w (rows, L) and neighbors
    (N, rows, L), accumulated in f32 and returned in ``w``'s dtype. The
    neighbors are promoted to ``w``'s dtype."""
    if _on_cuda(w):
        f32 = dict(dtype=torch.float32, device=w.device)
        return _cm.consensus_mix(
            w.contiguous(), neighbors.to(w.dtype).contiguous(),
            torch.as_tensor(eta, **f32).contiguous(),
            torch.as_tensor(gamma, **f32).reshape(1))
    return ref.consensus_mix(w, neighbors, eta, gamma)


def consensus_mix_pytree(params: dict, neighbor_params: dict, eta,
                         gamma) -> dict:
    """Eq. 5 for one node's whole parameter dict at once: ``params`` leaves
    (...), ``neighbor_params`` leaves (N, ...). Self and neighbors are
    packed into ONE flat (N+1, P) buffer (self in row 0, each leaf at the
    promoted dtype of its pair) and mixed by one B1 call with the weights
    ``[0, eta]`` in row 0; row 0 comes back with every leaf in its own
    dtype."""
    from repro_torch.core import flatten

    stacked = {}
    for name, w in params.items():
        nb = neighbor_params[name]
        dt = torch.promote_types(w.dtype, nb.dtype)
        stacked[name] = torch.cat([w[None].to(dt), nb.to(dt)])
    buf, layout = flatten.flatten(stacked)
    n = buf.shape[0] - 1
    eta_full = torch.zeros((n + 1, n + 1), dtype=torch.float32,
                           device=buf.device)
    eta_full[0, 1:] = torch.as_tensor(eta, dtype=torch.float32,
                                      device=buf.device)
    mixed = flatten.unflatten(flatten.mix_flat(buf, eta_full, gamma), layout)
    return {name: mixed[name][0].to(w.dtype) for name, w in params.items()}


def flat_consensus(matrix, buf) -> torch.Tensor:
    """``A @ BUF`` over the flat (K, P) buffer (B2); with a variant axis,
    buf (V, K, P) and A (K, K) shared or (V, K, K)."""
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


def cluster_mix(idx, val, master, wself, wire, gamma_node, *,
                plan=None) -> torch.Tensor:
    """Per-node-gamma cluster gather-mix (B6):
    ``MASTER + g[:, None] * (sum_d VAL W[IDX] - rowsum(VAL) * WSELF)``.
    ``plan`` (port-only), one round's
    :class:`repro_torch.kernels.cluster_mix.ClusterPlan` of ``idx``, lets
    the kernel stage each group's rows once; the plain version needs
    none."""
    if _on_cuda(master):
        return _clm.cluster_mix(idx, val, master, wself, wire, gamma_node,
                                plan=plan)
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


def tma_aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and, in bf16, starting on a 16-byte boundary (what
    the bf16 B9 kernel's TMA loads read): a bf16 view at any other offset
    is copied, every other tensor passed as it is."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
        t = t.clone()
    return t


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _plain_grads(plain, inputs, outputs_grad, needs):
    """The gradients of ``plain(*inputs)`` for the inputs marked in
    ``needs``, by autograd of the plain version (None elsewhere)."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(inputs, needs)]
        outs = plain(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        wrt = [t for t, n in zip(leaves, needs) if n]
        grads = iter(torch.autograd.grad(outs, wrt, outputs_grad,
                                         allow_unused=True))
    return tuple(next(grads) if n else None for n in needs)


def _flash_attention(q, k, v, causal, window):
    """The dispatch of B9 (no graph is recorded here: the kernel gets
    detached inputs)."""
    if _on_cuda(q):
        return _fa.flash_attention(*(tma_aligned(t.detach())
                                     for t in (q, k, v)),
                                   causal=causal, window=window)
    return ref.flash_attention(q, k, v, causal=causal, window=window)


class _FlashAttention(torch.autograd.Function):
    """B9 forward (its plain version on the CPU), backward by autograd of
    the plain version recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.masks = (causal, window)
        return _flash_attention(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, grad):
        causal, window = ctx.masks
        grads = _plain_grads(
            lambda q, k, v: ref.flash_attention(q, k, v, causal=causal,
                                                window=window),
            ctx.saved_tensors, (grad,), ctx.needs_input_grad[:3])
        return grads + (None, None)


def flash_attention(q, k, v, *, causal: bool = True,
                    window=None) -> torch.Tensor:
    """Online-softmax GQA attention (B9): q (B, Sq, H, D), k/v (B, Sk, KV,
    D) -> (B, Sq, H, D) in q's dtype, q at position 0, scale ``D**-0.5``,
    causal and sliding-window masks. Any view is taken: B9 gets aligned
    copies of bf16 views that are not 16-byte aligned. Differentiable:
    the gradient is that of the plain version (see the module's note)."""
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window)
    return _flash_attention(q, k, v, causal, window)


def _rwkv6_scan(r, k, v, w, u, chunk, s0):
    """The dispatch of B10 (no graph is recorded here: the kernel gets
    detached inputs)."""
    if _on_cuda(r):
        f32 = [None if t is None else t.detach().float().contiguous()
               for t in (w, u, s0)]
        return _rw.rwkv6_scan(*(t.detach().contiguous() for t in (r, k, v)),
                              *f32, chunk=chunk)
    return ref.rwkv6_scan(r, k, v, w, u, s0=s0, chunk=chunk)


class _Rwkv6Scan(torch.autograd.Function):
    """B10 forward (its plain version on the CPU), backward by autograd of
    the plain wkv recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk, s0):
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.chunk = chunk
        return _rwkv6_scan(r, k, v, w, u, chunk, s0)

    @staticmethod
    def backward(ctx, grad_y, grad_s):
        r, k, v, w, u, s0 = ctx.saved_tensors
        needs = ctx.needs_input_grad
        grads = _plain_grads(
            lambda r, k, v, w, u, s0: ref.rwkv6_scan(
                r, k, v, w, u, s0=s0, chunk=ctx.chunk),
            (r, k, v, w, u, s0), (grad_y, grad_s),
            needs[:5] + needs[6:])
        return grads[:5] + (None, grads[5])


def rwkv6_scan(r, k, v, w, u, chunk: int = 32, s0=None):
    """Chunked RWKV6 wkv scan (B10): r/k/v/w (B, S, H, D), u (H, D), s0
    (B, H, D, D) or None (zeros) -> (y (B, S, H, D) f32, final state
    (B, H, D, D) f32). w, u and s0 are taken in f32, r/k/v in their own
    dtype; S a multiple of ``chunk``. The reference's order and default
    chunk, then the port's initial state. Differentiable: the gradient is
    that of the plain version (see the module's note)."""
    if _needs_grad(r, k, v, w, u, s0):
        return _Rwkv6Scan.apply(r, k, v, w, u, chunk, s0)
    return _rwkv6_scan(r, k, v, w, u, chunk, s0)
