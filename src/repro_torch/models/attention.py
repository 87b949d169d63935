"""Grouped-query attention with qk-norm, RoPE, causal + sliding-window
masking; train/prefill forward and single-token decode with a KV cache.

``forward`` attends through :func:`repro_torch.kernels.ops.flash_attention`:
kernel B9 on a CUDA tensor, :func:`attend` (the reference, as in the JAX
package) on a CPU tensor. ``decode_step`` stays on the plain grouped path
of the reference: its query sits at the cache length, and B9 puts q at
position 0.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers, pspec


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S_cache, KV, D)
    v: torch.Tensor
    length: torch.Tensor     # int32 — tokens currently in cache


def init(generator, cfg: ModelConfig, dtype=torch.float32, device=None):
    hd = cfg.resolved_head_dim()
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": layers._dense_init(generator, (cfg.d_model, cfg.num_heads * hd),
                                 **kw),
        "wk": layers._dense_init(generator,
                                 (cfg.d_model, cfg.num_kv_heads * hd), **kw),
        "wv": layers._dense_init(generator,
                                 (cfg.d_model, cfg.num_kv_heads * hd), **kw),
        "wo": layers._dense_init(generator, (cfg.num_heads * hd, cfg.d_model),
                                 **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = layers.rmsnorm_init(hd, **kw)
        p["k_norm"] = layers.rmsnorm_init(hd, **kw)
    return p


def _project_qkv(params, cfg: ModelConfig, x, positions):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim()
    h, kv = cfg.num_heads, cfg.num_kv_heads
    q = pspec.splittable(x @ params["wq"], -1, h).reshape(b, s, h, hd)
    k = pspec.splittable(x @ params["wk"], -1, kv).reshape(b, s, kv, hd)
    v = pspec.splittable(x @ params["wv"], -1, kv).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = layers.rmsnorm(params["q_norm"], q)
        k = layers.rmsnorm(params["k_norm"], k)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attend(q, k, v, *, causal: bool, window: Optional[int],
           q_offset: int = 0) -> torch.Tensor:
    """Reference GQA attention.

    q: (B, Sq, H, D); k/v: (B, Sk, KV, D). H % KV == 0.
    q_offset: absolute position of q[0] relative to k[0] (decode: cache len).
    window: sliding-window size (keys within [pos-window+1, pos]).
    Scores and softmax in f32; the probabilities are cast to v's dtype
    before the product with v, as in the JAX package.
    """
    h, kv = q.shape[2], k.shape[2]
    groups = h // kv
    if groups > 1:
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)
    # on a mesh (port-only): q, k and v over the batch and head shards
    # (for the repeated heads a local slice, their gradient gathered whole
    # before the repeat's backward folds H into (KV, groups)); each
    # (batch row, head) attends on its own, so every rank attends its
    # shards locally
    q = pspec.constrain(q, "batch", None, "heads", None)
    k = pspec.constrain(k, "batch", None, "heads", None)
    v = pspec.constrain(v, "batch", None, "heads", None)
    out = pspec.local_shards(
        lambda q, k, v: _attend(q, k, v, causal, window, q_offset),
        (q, k, v), dims=(0, 2))
    if out is None:
        out = _attend(q, k, v, causal, window, q_offset)
    return pspec.constrain(out, "batch", None, "heads", None)


def _attend(q, k, v, causal, window, q_offset):
    """:func:`attend` after the GQA repeat: q/k/v (B, S, H, D)."""
    sq, d = q.shape[1], q.shape[3]
    sk = k.shape[1]
    scores = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) \
        / math.sqrt(d)
    scores = pspec.constrain(scores, "batch", "heads", None, None)
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores = torch.where(mask[None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", probs.to(v.dtype), v)


def forward(params, cfg: ModelConfig, x, positions=None,
            window_override: Optional[int] = None):
    """Training / prefill self-attention over the full sequence."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(params, cfg, x, positions)
    window = window_override if window_override is not None \
        else cfg.sliding_window
    # on a mesh (port-only): each rank attends its own batch rows and
    # heads, through the kernel on the card, when q's and k/v's head
    # shards line up (every head dim whole, or KV divisible by the head
    # shards); else on the DTensors (:func:`attend`'s repeat first)
    q, k, v = (pspec.constrain(t, "batch", None, "heads", None)
               for t in (q, k, v))

    def fa(q, k, v):
        return ops.flash_attention(q, k, v, causal=True, window=window)

    out = pspec.local_shards(fa, (q, k, v), dims=(0, 2))
    if out is None:
        out = fa(q, k, v)
    # on a mesh (port-only): the merged heads over the head shards, so that
    # their gradient reaches the merge's backward placed as in the forward
    out = pspec.constrain(out.reshape(b, s, -1), "batch", None, "heads")
    return out @ params["wo"]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, window: Optional[int] = None,
               device=None) -> KVCache:
    """window: cap the cache to the sliding window (ring buffer)."""
    eff = min(max_len, window) if window else max_len
    hd = cfg.resolved_head_dim()
    shape = (batch, eff, cfg.num_kv_heads, hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros((), dtype=torch.int32, device=device))


def decode_step(params, cfg: ModelConfig, x, cache: KVCache,
                window_override: Optional[int] = None):
    """One-token decode: x (B, 1, d_model); returns (out, new_cache).

    The cache is a ring buffer of size S_cache; with a sliding window the
    buffer equals the window so positions wrap (long_500k path). The new
    token's k/v are written into ``cache.k``/``cache.v`` in place (the
    returned cache shares their storage): the JAX package returns fresh
    arrays, which here would copy the whole cache every token.
    """
    b = x.shape[0]
    s_cache = cache.k.shape[1]
    pos = cache.length.expand(b, 1)
    q, k, v = _project_qkv(params, cfg, x, pos)
    # the grouped view below splits the head dim into (KV, groups): on a
    # mesh whose head shards outnumber the KV heads that split cannot be
    # placed, so the query heads are replicated first (port-only; the
    # reference's partitioner reshards there by itself)
    q = pspec.constrain(q, "batch", None, "kv", None)
    slot = cache.length.long() % s_cache
    new_k = pspec.write_slot(cache.k, 1, slot, k.to(cache.k.dtype))
    new_v = pspec.write_slot(cache.v, 1, slot, v.to(cache.v.dtype))
    window = window_override if window_override is not None \
        else cfg.sliding_window

    # grouped-query einsums over the valid region of the ring buffer (no kv
    # repeat); operands in their dtype, scores in f32
    hd = q.shape[-1]
    kv = cfg.num_kv_heads
    groups = cfg.num_heads // kv
    qg = q.reshape(b, 1, kv, groups, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), new_k.float()) \
        / math.sqrt(hd)                                      # (b,kv,g,1,S)
    # slot indices -> absolute positions in the ring buffer
    idx = torch.arange(s_cache, device=x.device)
    length = cache.length.long()
    wraps = length >= s_cache
    abs_pos = torch.where(
        wraps,
        torch.where(idx <= slot, length - slot + idx,
                    length - slot - s_cache + idx),
        idx)
    valid = abs_pos <= length
    if window is not None:
        valid &= abs_pos > length - window
    scores = torch.where(valid[None, None, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(new_v.dtype), new_v)
    out = out.reshape(b, 1, -1) @ params["wo"]
    return out, KVCache(k=new_k, v=new_v, length=cache.length + 1)
