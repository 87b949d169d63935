"""Mamba2 (SSD) block for the zamba2 hybrid [arXiv:2411.15242], the
counterpart of the JAX package's ``repro.models.mamba``.

Selective state space:  h_t = exp(-A * dt_t) h_{t-1} + dt_t * x_t B_t^T
                        y_t = h_t C_t + D x_t
with a per-head scalar decay A (Mamba2 simplification), input-dependent
B_t, C_t, dt_t, a causal depthwise conv front-end and a SiLU gate.

``forward`` takes the reference's rule: the chunkwise-parallel form when
the sequence is longer than one token and a multiple of ``CHUNK``, else
the sequential ``scan_reference`` (decode: one token, O(1) state). Neither
is a kernel in the JAX package; both are plain tensor ops here. Where the
reference forms the cross-chunk states by an associative scan, ``chunked``
runs a loop over the chunk summaries, which changes the f32 summation
order only.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers

HEAD_SIZE = 64
CONV_K = 4
CHUNK = 16


class MambaState(NamedTuple):
    h: torch.Tensor         # (B, H, D, N) ssm state, f32
    conv: torch.Tensor      # (B, CONV_K-1, conv_dim) conv tail: f32 at
                            # init, then in the layer input's dtype


def dims(cfg: ModelConfig):
    d_inner = 2 * cfg.d_model
    nheads = d_inner // HEAD_SIZE
    n = cfg.ssm_state or 64
    return d_inner, nheads, n


def init(generator, cfg: ModelConfig, dtype=torch.float32, device=None):
    """The reference's keys and shapes, drawn from ``generator``."""
    d = cfg.d_model
    d_inner, nheads, n = dims(cfg)
    conv_dim = d_inner + 2 * n          # x, B, C all convolved
    dev = device or generator.device
    kw = dict(dtype=dtype, device=dev)
    conv_w = torch.randn((CONV_K, conv_dim), generator=generator,
                         device=generator.device)
    return {
        # fused in_proj -> [z (gate), x, B, C, dt]
        "w_in": layers._dense_init(
            generator, (d, 2 * d_inner + 2 * n + nheads), **kw),
        "conv_w": (conv_w * 0.1).to(**kw),
        "conv_b": torch.zeros((conv_dim,), **kw),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nheads)).to(**kw),
        "dt_bias": torch.zeros((nheads,), **kw),
        "d_skip": torch.ones((nheads,), **kw),
        "norm": layers.rmsnorm_init(d_inner, **kw),
        "w_out": layers._dense_init(generator, (d_inner, d), **kw),
    }


def _causal_conv(xbc, w, b, tail):
    """Depthwise causal conv, kernel CONV_K. xbc: (B,S,C); tail: (B,K-1,C).
    Returns (silu(conv + b), new tail in xbc's dtype)."""
    padded = torch.cat([tail.to(xbc.dtype), xbc], dim=1)
    out = sum(padded[:, i:i + xbc.shape[1], :] * w[i]
              for i in range(CONV_K))
    new_tail = padded[:, -(CONV_K - 1):, :] if CONV_K > 1 else tail
    return F.silu(out + b), new_tail


def _split_proj(params, cfg, x):
    d_inner, nheads, n = dims(cfg)
    proj = x @ params["w_in"]
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:2 * d_inner + 2 * n]
    dt = proj[..., 2 * d_inner + 2 * n:]
    return z, xbc, dt


def scan_reference(xh, bt, ct, dt, a, s0):
    """Sequential recurrence in f32. xh: (B,S,H,D); bt/ct: (B,S,N); dt:
    (B,S,H); a: (H,) positive decay. Returns y (B,S,H,D), s_final
    (B,H,D,N)."""
    x32, b32, c32, dt32 = xh.float(), bt.float(), ct.float(), dt.float()
    s = s0
    ys = []
    for t in range(xh.shape[1]):
        dt_ = dt32[:, t]
        decay = torch.exp(-a[None, :, None, None] * dt_[..., None, None])
        upd = dt_[..., None, None] * x32[:, t, ..., None] \
            * b32[:, t, None, None, :]
        s = decay * s + upd
        ys.append(torch.einsum("bhdn,bn->bhd", s, c32[:, t]))
    return torch.stack(ys, dim=1), s


def chunked(xh, bt, ct, dt, a, s0, chunk: int = CHUNK):
    """Chunkwise-parallel SSD (Mamba2): intra-chunk pairwise decays from
    cumulative-dt differences (every exponent <= 0), cross-chunk states by
    a loop over the chunk summaries, h_c = g_{c-1} h_{c-1} + u_{c-1}. The
    same function as :func:`scan_reference`.

    xh: (B,S,H,D); bt/ct: (B,S,N); dt: (B,S,H); a: (H,). Returns
    (y (B,S,H,D), s_final (B,H,D,N))."""
    b, seq, h, d = xh.shape
    n = bt.shape[-1]
    if seq % chunk:
        raise ValueError(f"sequence {seq} is not a multiple of the chunk "
                         f"{chunk}")
    nc = seq // chunk

    def rs(x, feat):
        return x.float().reshape(b, nc, chunk, *feat)

    xc = rs(xh, (h, d))
    bc, cc = rs(bt, (n,)), rs(ct, (n,))
    dtc = rs(dt, (h,))                                  # (b,nc,C,h)
    ell = torch.cumsum(dtc, dim=2) * a                  # (b,nc,C,h) positive

    # pairwise decay exp(-(ell_t - ell_i)) for i <= t (inclusive: i == t
    # contributes dt_t * x_t B_t . C_t with zero decay); (b,nc,t,i,h)
    diff = ell[:, :, :, None, :] - ell[:, :, None, :, :]
    dec = torch.exp(-torch.clamp_min(diff, 0.0))
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32,
                                 device=xh.device))
    bc_dot_ct = torch.einsum("bntm,bnim->bnti", cc, bc)
    scores = bc_dot_ct[..., None] * dec * mask[None, None, :, :, None]
    scores = scores * dtc[:, :, None, :, :]            # dt_i factor (i dim)
    y = torch.einsum("bntih,bnihd->bnthd", scores, xc)

    decay0 = torch.exp(-ell)                            # (b,nc,C,h)
    # per-chunk summaries; the reference's four-operand einsum as one
    # elementwise weight of x and one product over i (no (…, i, h, d, n)
    # intermediate)
    dec_end = torch.exp(-(ell[:, :, -1:, :] - ell))     # (b,nc,C,h) <= 1
    xw = (dtc * dec_end)[..., None] * xc                # (b,nc,C,h,d)
    u_c = torch.einsum("bnihd,bnim->bnhdm", xw, bc)     # (b,nc,h,d,n)
    g_c = torch.exp(-ell[:, :, -1])                     # (b,nc,h)

    starts = [s0.float()]
    for c in range(nc - 1):
        starts.append(g_c[:, c, :, None, None] * starts[-1] + u_c[:, c])
    h_start = torch.stack(starts, dim=1)                # (b,nc,h,d,n)
    # the reference's "bnth,bnhdm,bntm->bnthd": contract h_start with cc
    # over the state dim first, then scale by decay0 (a left-to-right
    # einsum would build a (b, nc, t, h, d, n) intermediate)
    y = y + decay0[..., None] * torch.einsum("bnhdm,bntm->bnthd",
                                             h_start, cc)
    s_fin = g_c[:, -1][..., None, None] * h_start[:, -1] + u_c[:, -1]
    return y.reshape(b, seq, h, d), s_fin


def forward(params, cfg: ModelConfig, x, state: MambaState | None = None,
            use_chunked: bool | None = None):
    """x: (B, S, d_model) -> (out, new_state)."""
    b, seq, d = x.shape
    d_inner, nheads, n = dims(cfg)
    if state is None:
        state = init_state(cfg, b, x.device)
    z, xbc, dt = _split_proj(params, cfg, x)
    xbc, conv_tail = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                  state.conv)
    xin = xbc[..., :d_inner]
    bt = xbc[..., d_inner:d_inner + n]
    ct = xbc[..., d_inner + n:]
    pre = dt.float() + params["dt_bias"].float()
    dt_h = torch.logaddexp(pre, torch.zeros_like(pre))  # jax.nn.softplus
    a = torch.exp(params["a_log"].float())
    xh = xin.reshape(b, seq, nheads, HEAD_SIZE)
    if use_chunked is None:
        use_chunked = seq > 1 and seq % CHUNK == 0
    if use_chunked:
        y, s_fin = chunked(xh, bt, ct, dt_h, a, state.h)
    else:
        y, s_fin = scan_reference(xh, bt, ct, dt_h, a, state.h)
    y = y + params["d_skip"].float()[None, None, :, None] * xh.float()
    y = y.reshape(b, seq, d_inner).to(x.dtype)
    y = layers.rmsnorm(params["norm"], y) * F.silu(z)
    out = y @ params["w_out"]
    return out, MambaState(h=s_fin, conv=conv_tail)


def init_state(cfg: ModelConfig, batch: int, device=None) -> MambaState:
    d_inner, nheads, n = dims(cfg)
    conv_dim = d_inner + 2 * n
    f32 = dict(dtype=torch.float32, device=device)
    return MambaState(
        h=torch.zeros((batch, nheads, HEAD_SIZE, n), **f32),
        conv=torch.zeros((batch, CONV_K - 1, conv_dim), **f32))


def decode_step(params, cfg: ModelConfig, x, state: MambaState):
    """x: (B, 1, d). O(1) per token: the sub-quadratic decode path."""
    return forward(params, cfg, x, state)
