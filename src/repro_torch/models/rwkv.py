"""RWKV6 "Finch" time-mix block: attention-free, data-dependent decay
[arXiv:2404.05892], the counterpart of the JAX package's
``repro.models.rwkv``.

Per head h with head size D, the recurrence over time t is
    S_t = diag(w_t) S_{t-1} + k_t v_t^T                (state: D x D)
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
with the decay w_t a data-dependent function of x_t through a low-rank
(LoRA) map.

``forward`` takes the reference's rule: the chunked form when the
sequence is longer than one token and a multiple of ``CHUNK``, else the
sequential ``scan_reference``. ``chunked`` goes through
:func:`repro_torch.kernels.ops.rwkv6_scan`: kernel B10 on a CUDA tensor
(from the given state, if any), its plain version on a CPU tensor. Decode
(one token) runs ``scan_reference``, as in the JAX package. On a mesh
each rank runs the recurrence on its own batch rows and heads.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers, pspec

HEAD_SIZE = 64
LORA_RANK = 64
CHUNK = 16
MAX_LOG_DECAY = 4.0   # w >= exp(-4) ~ 0.018/step


class RwkvState(NamedTuple):
    s: torch.Tensor        # (B, H, D, D) wkv state, f32
    x_prev: torch.Tensor   # (B, d_model) last input (token shift)


def num_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // (cfg.ssm_heads or HEAD_SIZE) \
        if cfg.ssm_heads else cfg.d_model // HEAD_SIZE


def head_size(cfg: ModelConfig) -> int:
    return cfg.ssm_heads or HEAD_SIZE


def init(generator, cfg: ModelConfig, dtype=torch.float32, device=None):
    """The reference's keys and shapes, drawn from ``generator``."""
    d = cfg.d_model
    hs = head_size(cfg)
    h = d // hs
    kw = dict(dtype=dtype, device=device)

    def dense(shape, scale=None):
        return layers._dense_init(generator, shape, scale=scale, **kw)

    def full(value):
        return torch.full((d,), value, **kw)

    p = {"wr": dense((d, d)), "wk": dense((d, d)), "wv": dense((d, d)),
         "wg": dense((d, d)), "wo": dense((d, d)),
         # data-dependent decay LoRA: w_t = exp(-exp(w0 + tanh(x A) B))
         "decay_w0": full(-4.0),
         "decay_a": dense((d, LORA_RANK)),
         "decay_b": dense((LORA_RANK, d), scale=0.01)}
    u = torch.randn((h, hs), generator=generator, device=generator.device)
    p["bonus_u"] = (u * 0.1).to(**kw)
    # token-shift interpolation weights
    for mu in ("mu_r", "mu_k", "mu_v", "mu_w"):
        p[mu] = full(0.5)
    return p


def _shift(x, x_prev):
    """Token shift: the x_{t-1} sequence (x_prev prepended, last dropped)."""
    return torch.cat([x_prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _mix(params, x, xs):
    def lerp(mu):
        return x * params[mu] + xs * (1.0 - params[mu])
    r = lerp("mu_r") @ params["wr"]
    k = lerp("mu_k") @ params["wk"]
    v = lerp("mu_v") @ params["wv"]
    # on a mesh (port-only): the LoRA's rank-64 hidden whole on every rank
    # before its second product (torch 2.11's DTensor plans that product
    # on a sharded rank dim through a redistribution it cannot run)
    hidden = pspec.constrain(torch.tanh(lerp("mu_w") @ params["decay_a"]),
                             "batch", None, None)
    lw = params["decay_w0"] + hidden @ params["decay_b"]
    # clamp the per-step log-decay to [-MAX_LOG_DECAY, 0), in f32
    w = torch.exp(-torch.clamp(torch.exp(lw.float()), 1e-6, MAX_LOG_DECAY))
    g = F.silu(x @ params["wg"])
    return r, k, v, w, g


def _heads(x, h, hs):
    return x.reshape(*x.shape[:-1], h, hs)


def scan_reference(r, k, v, w, u, s0=None):
    """Sequential wkv recurrence in f32. r/k/v/w: (B, S, H, D); u: (H, D).
    Returns (y (B, S, H, D), s_final (B, H, D, D))."""
    b, seq, h, d = r.shape
    s = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device) \
        if s0 is None else s0.float()
    r32, k32, v32, w32 = r.float(), k.float(), v.float(), w.float()
    u32 = u.float()[None, :, :, None]
    ys = []
    for t in range(seq):
        kv = k32[:, t, :, :, None] * v32[:, t, :, None, :]    # (B,H,D,D)
        ys.append(torch.einsum("bhd,bhde->bhe", r32[:, t], s + u32 * kv))
        s = w32[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def chunked(r, k, v, w, u, s0=None, chunk: int = CHUNK):
    """The chunkwise-parallel wkv, the same function as
    :func:`scan_reference`: kernel B10 on the card, its plain version on
    the CPU (:func:`repro_torch.kernels.ops.rwkv6_scan`)."""
    return ops.rwkv6_scan(r, k, v, w, u, chunk=chunk, s0=s0)


def _wkv(r, k, v, w, u, s0):
    """The wkv recurrence by the reference's rule: :func:`chunked` when
    the sequence is longer than one token and a multiple of ``CHUNK``,
    else :func:`scan_reference`."""
    seq = r.shape[1]
    if seq > 1 and seq % CHUNK == 0:
        return chunked(r, k, v, w, u, s0)
    return scan_reference(r, k, v, w, u, s0)


def forward(params, cfg: ModelConfig, x, state: RwkvState | None = None):
    """x: (B, S, d_model) -> (out, new_state)."""
    b, seq, d = x.shape
    h, hs = num_heads(cfg), head_size(cfg)
    x_prev = state.x_prev if state is not None \
        else torch.zeros((b, d), dtype=x.dtype, device=x.device)
    xs = _shift(x, x_prev)
    r, k, v, w, g = _mix(params, x, xs)
    rh, kh, vh = _heads(r, h, hs), _heads(k, h, hs), _heads(v, h, hs)
    wh = _heads(w, h, hs)
    u = params["bonus_u"].float()
    s0 = state.s if state is not None else None
    # on a mesh (port-only): the recurrence is independent per (batch row,
    # head), so each rank scans its own shards (u sliced to its heads, the
    # state placed alike), as attention attends them
    rh, kh, vh, wh = (pspec.constrain(t, "batch", None, "heads", None)
                      for t in (rh, kh, vh, wh))
    heads, state_dims = (0, None, 2, None), (0, 2, None, None)
    args = (rh, kh, vh, wh, u, s0)
    out = pspec.map_shards(_wkv, args, (heads,) * 4 + ((2, None),
                                                        state_dims),
                           (heads, state_dims))
    y, s_fin = _wkv(*args) if out is None else out
    y = y.reshape(b, seq, d).to(x.dtype) * g
    out = y @ params["wo"]
    return out, RwkvState(s=s_fin, x_prev=x[:, -1, :])


def init_state(cfg: ModelConfig, batch: int, device=None) -> RwkvState:
    h, hs = num_heads(cfg), head_size(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return RwkvState(s=torch.zeros((batch, h, hs, hs), **f32),
                     x_prev=torch.zeros((batch, cfg.d_model), **f32))


def decode_step(params, cfg: ModelConfig, x, state: RwkvState):
    """x: (B, 1, d). O(1) per token: the sub-quadratic decode path."""
    return forward(params, cfg, x, state)
