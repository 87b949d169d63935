"""Optimizers of the paper's eq. (8), on parameter trees and on the flat
parameter buffer:

    m_{t+1} = b1 m_t + (1-b1) g
    v_{t+1} = b2 v_t + (1-b2) g^2
    W_{t+1} = W_t - lr * sqrt(1-b2^t)/(1-b1^t) * m_{t+1}/(sqrt(v_{t+1})+eps)

eps sits outside the square root and the two bias corrections are one
folded factor, so this is NOT ``torch.optim.Adam`` (which places eps on
the bias-corrected root). :func:`adam` and :func:`sgd` update a tree of
dicts and lists of tensors (one node; the mesh train step runs them node
by node), with f32 moments and the params kept in their own dtype.
:func:`flat_adam` is elementwise over node-stacked ``(K, P)`` buffers,
with gradient clipping per node (row).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import flatten


class AdamState(NamedTuple):
    step: torch.Tensor       # int32 ()
    m: object                # tree like params, f32
    v: object


class FlatAdamState(NamedTuple):
    """Adam moments as flat buffers matching the param buffer."""

    step: torch.Tensor       # int32 (K,) per-node step counters
    m: torch.Tensor          # f32 (K, P)
    v: torch.Tensor          # f32 (K, P)


class Optimizer(NamedTuple):
    init: Callable
    update: Callable         # (grads, state, params) -> (params, state)


def _leaves(tree) -> list:
    return [leaf for _, leaf in flatten.leaves_with_paths(tree)]


def _like(tree, leaves):
    """``tree``'s dicts and lists holding ``leaves`` in its leaf order."""
    paths = [path for path, _ in flatten.leaves_with_paths(tree)]
    return flatten.build_tree(paths, leaves)


def _f32(value, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-7, weight_decay: float = 0.0,
         grad_clip: float = 0.0) -> Optimizer:
    """``learning_rate``: a float or a callable of the int32 step.

    ``update(grads, state, params, lr=None, *, inplace=False)``: ``lr``
    overrides the constructor's rate. With ``inplace`` the moments of
    ``state`` and the tensors of ``params`` are overwritten with the new
    ones (the returned trees hold the same tensors), leaf by leaf, so that
    the f32 temporaries cover one leaf at a time; the arithmetic is the
    same."""

    def init(params) -> AdamState:
        leaves = _leaves(params)
        m = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        v = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        dev = leaves[0].device
        return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                         m=_like(params, m), v=_like(params, v))

    def update(grads, state: AdamState, params, lr=None, *,
               inplace: bool = False):
        flat_g = _leaves(grads)
        dev = state.step.device
        scale = None
        if grad_clip > 0.0:
            gnorm = global_norm(flat_g)
            scale = torch.clamp_max(grad_clip / (gnorm + 1e-12), 1.0)
        t = state.step + 1
        tf = t.to(torch.float32)
        b1t = torch.pow(_f32(b1, dev), tf)
        b2t = torch.pow(_f32(b2, dev), tf)
        corr = torch.sqrt(1.0 - b2t) / (1.0 - b1t)       # paper eq. (8)
        if lr is None:
            lr = learning_rate(t) if callable(learning_rate) \
                else learning_rate
        lr = _f32(lr, dev)
        step_size = lr * corr
        decay = lr * weight_decay

        def upd(m, v, g, p):
            g32 = g.to(torch.float32)
            if scale is not None:
                g32 = g32 * scale
            if inplace:
                m_new = m.mul_(b1).add_(g32 * (1.0 - b1))
                v_new = v.mul_(b2).add_(torch.square(g32).mul_(1.0 - b2))
            else:
                m_new = b1 * m + (1.0 - b1) * g32
                v_new = b2 * v + (1.0 - b2) * torch.square(g32)
            del g32
            delta = torch.mul(m_new, step_size).div_(
                torch.sqrt(v_new).add_(eps))
            p32 = p.to(torch.float32, copy=True)
            if weight_decay:
                delta.add_(decay * p32)
            new = p32.sub_(delta)
            if inplace:
                p.copy_(new)
                return m_new, v_new, p
            return m_new, v_new, new.to(p.dtype)

        flat_m, flat_v = _leaves(state.m), _leaves(state.v)
        flat_p = _leaves(params)
        out = [upd(m, v, g, p)
               for m, v, g, p in zip(flat_m, flat_v, flat_g, flat_p)]
        new_m = _like(state.m, [o[0] for o in out])
        new_v = _like(state.v, [o[1] for o in out])
        new_p = _like(params, [o[2] for o in out])
        return new_p, AdamState(step=t, m=new_m, v=new_v)

    return Optimizer(init=init, update=update)


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


def sgd(learning_rate, momentum: float = 0.0) -> Optimizer:
    """SGD with heavy-ball momentum ``m = momentum*m + g``, f32 moments;
    the state is an :class:`AdamState` whose ``v`` is ``m``'s init."""

    def init(params):
        m = _like(params, [torch.zeros_like(p, dtype=torch.float32)
                           for p in _leaves(params)])
        dev = _leaves(params)[0].device
        return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                         m=m, v=m)

    def update(grads, state, params):
        t = state.step + 1
        lr = learning_rate(t) if callable(learning_rate) else learning_rate

        def upd(m, g, p):
            g32 = g.to(torch.float32)
            m_new = momentum * m + g32
            return m_new, (p.to(torch.float32) - lr * m_new).to(p.dtype)

        out = [upd(m, g, p) for m, g, p in
               zip(_leaves(state.m), _leaves(grads), _leaves(params))]
        return (_like(params, [o[1] for o in out]),
                AdamState(step=t, m=_like(state.m, [o[0] for o in out]),
                          v=state.v))

    return Optimizer(init=init, update=update)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in _leaves(tree)))
