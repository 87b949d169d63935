"""Adam on the flat parameter buffer, following the paper's eq. (8):

    m_{t+1} = b1 m_t + (1-b1) g
    v_{t+1} = b2 v_t + (1-b2) g^2
    W_{t+1} = W_t - lr * sqrt(1-b2^t)/(1-b1^t) * m_{t+1}/(sqrt(v_{t+1})+eps)

eps sits outside the square root and the two bias corrections are one
folded factor, so this is NOT ``torch.optim.Adam`` (which places eps on
the bias-corrected root). The update is elementwise over node-stacked
``(K, P)`` buffers; gradient clipping is per node (row).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class FlatAdamState(NamedTuple):
    """Adam moments as flat buffers matching the param buffer."""

    step: torch.Tensor       # int32 (K,) per-node step counters
    m: torch.Tensor          # f32 (K, P)
    v: torch.Tensor          # f32 (K, P)


class Optimizer(NamedTuple):
    init: Callable
    update: Callable         # (grads, state, params) -> (params, state)


def flat_adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-7, weight_decay: float = 0.0,
              grad_clip: float = 0.0) -> Optimizer:
    """Adam (paper eq. 8) on node-stacked ``(K, P)`` buffers.

    ``learning_rate``: a float or a callable of the int32 (K,) step."""

    def init(buf: torch.Tensor) -> FlatAdamState:
        return FlatAdamState(
            step=torch.zeros(buf.shape[:-1], dtype=torch.int32,
                             device=buf.device),
            m=torch.zeros_like(buf, dtype=torch.float32),
            v=torch.zeros_like(buf, dtype=torch.float32))

    def update(gbuf: torch.Tensor, state: FlatAdamState,
               buf: torch.Tensor):
        g = gbuf.to(torch.float32)
        if grad_clip > 0.0:
            gnorm = torch.sqrt(torch.sum(g * g, dim=-1, keepdim=True))
            g = g * torch.clamp_max(grad_clip / (gnorm + 1e-12), 1.0)
        t = state.step + 1
        tf = t.to(torch.float32)
        f32 = dict(dtype=torch.float32, device=buf.device)
        b1t = torch.pow(torch.tensor(b1, **f32), tf)
        b2t = torch.pow(torch.tensor(b2, **f32), tf)
        corr = torch.sqrt(1.0 - b2t) / (1.0 - b1t)       # paper eq. (8)
        lr = learning_rate(t) if callable(learning_rate) else learning_rate
        lr = torch.broadcast_to(torch.as_tensor(lr, **f32), t.shape)
        m_new = b1 * state.m + (1.0 - b1) * g
        v_new = b2 * state.v + (1.0 - b2) * (g * g)
        delta = (lr * corr)[..., None] * m_new / (torch.sqrt(v_new) + eps)
        if weight_decay:
            delta = delta + (lr * weight_decay)[..., None] * buf
        return buf - delta, FlatAdamState(step=t, m=m_new, v=v_new)

    return Optimizer(init=init, update=update)
