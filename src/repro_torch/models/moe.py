"""Mixture-of-Experts layer: top-k router + grouped capacity dispatch, the
counterpart of the JAX package's ``repro.models.moe``.

Tokens are routed under a per-group capacity bound, so every shape is
static: a slot table of token indices per (expert, capacity slot) is built
by a scatter, the tokens are gathered into it, the experts run as batched
products over the expert axis, and each token gathers back its k expert
outputs. Overflow (token, choice) pairs beyond an expert's capacity are
dropped (Switch semantics). The expert products are plain ``torch.einsum``
calls, as the JAX package computes them outside any kernel.

Routing ties keep the lower expert index first, as ``jax.lax.top_k``
does: the top k of a stable descending sort (``torch.topk`` promises no
order among equal values). The order within k sets the capacity priority.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, pspec


def init(generator, cfg: ModelConfig, dtype=torch.float32, device=None):
    """Router (d, E) in f32 whatever ``dtype``; experts stacked on a
    leading E axis."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    dev = device or generator.device

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=generator.device)
        return (x * scale).to(device=dev, dtype=dtype)

    scale = d ** -0.5
    return {
        "router": layers._dense_init(generator, (d, e), dtype=torch.float32,
                                     device=dev),
        "w_gate": normal((e, d, f), scale),
        "w_up": normal((e, d, f), scale),
        "w_down": normal((e, f, d), f ** -0.5),
    }


def _capacity(group_size: int, num_experts: int, top_k: int,
              factor: float) -> int:
    cap = int(group_size * top_k * factor / num_experts)
    return max(cap, top_k)


def route(params, cfg: ModelConfig, tokens):
    """tokens (..., d) -> (probs (..., E) f32, gates (..., k) renormalized
    to sum 1, expert ids (..., k) int64, highest probability first; ties
    keep the lower id first)."""
    logits = tokens.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    gate_vals, idx = vals[..., :k], idx[..., :k]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    return probs, gate_vals, idx


def queue_positions(idx, num_experts: int):
    """idx (g, gs, k) -> (one-hot mask (g, gs, k, E) f32, position of each
    (token, choice) in its expert's queue (g, gs, k) int32). Priority:
    choice rank first, then token order (Switch-style); the positions come
    from an f32 cumsum of the one-hots, exact below 2**24 entries."""
    g, gs, k = idx.shape
    mask = F.one_hot(idx, num_experts).float()
    mask_r = mask.transpose(1, 2).reshape(g, k * gs, num_experts)
    pos = (torch.cumsum(mask_r, dim=1) - 1.0).reshape(
        g, k, gs, num_experts).transpose(1, 2)
    pos = (pos * mask).sum(dim=-1).to(torch.int32)
    return mask, pos


def forward(params, cfg: ModelConfig, x, group_size: int = 2048):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar f32).

    Gather-based dispatch into a static (E, C) slot table per group of
    ``group_size`` tokens; (token, choice) pairs past an expert's capacity
    C are dropped. Routing, dispatch and combine are per group: on a mesh
    (port-only) they run on this rank's own groups (``pspec.map_shards``)
    and only the expert products run on the DTensors."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    tokens = x.reshape(-1, d)
    t = tokens.shape[0]
    gs = min(group_size, t)
    if t % gs:
        raise ValueError(f"tokens {t} not divisible by group {gs}")
    g = t // gs
    xg = tokens.reshape(g, gs, d)
    cap = _capacity(gs, e, k, cfg.capacity_factor)

    xg = pspec.constrain(xg, "batch", None, None)   # groups follow batch
    groups = (0, None, None)                 # a (g, ...) tensor's layout
    args = (xg, params["router"])
    dispatch = pspec.map_shards(
        lambda xg, router: _dispatch(xg, router, cfg, cap), args,
        (groups, (None, None)),
        ((0, None, None, None), groups, groups, groups, groups, (0,)))
    if dispatch is None:
        dispatch = _dispatch(*args, cfg, cap)
    xin, gate_vals, idx, pos, keep, aux = dispatch
    xin = pspec.constrain(xin, "batch", None, None, None)
    # on a mesh (port-only): the experts whole but for their ffn shards (an
    # FSDP gather), so that each rank multiplies its own groups; DTensor
    # fails to place the products of FSDP-sharded experts on real tensors
    w_gate, w_up = (pspec.constrain(params[name], None, None, "ffn")
                    for name in ("w_gate", "w_up"))
    w_down = pspec.constrain(params["w_down"], None, "ffn", None)
    h = F.silu(torch.einsum("gecd,edf->gecf", xin, w_gate))
    h = h * torch.einsum("gecd,edf->gecf", xin, w_up)
    h = pspec.constrain(h, "batch", None, None, "ffn")
    expert_out = torch.einsum("gecf,efd->gecd", h, w_down)
    expert_out = pspec.constrain(expert_out, "batch", None, None, None)

    args = (expert_out, gate_vals, keep, idx, pos)
    out = pspec.map_shards(
        lambda *a: _combine(*a, x.dtype), args,
        ((0, None, None, None),) + (groups,) * 4, (groups,))
    if out is None:
        out = _combine(*args, x.dtype)
    out = pspec.constrain(out, "batch", None, None)
    return out.reshape(b, s, d), aux.mean()


def _dispatch(xg, router, cfg: ModelConfig, cap: int):
    """Route the groups xg (g, gs, d) and gather each expert's tokens:
    (xin (g, E, C, d), gates (g, gs, k), expert ids (g, gs, k), queue
    positions (g, gs, k), kept pairs (g, gs, k), the load-balance loss of
    each group (g,)). Group by group: a rank runs it on its own groups."""
    g, gs, d = xg.shape
    e = cfg.num_experts
    k = cfg.experts_per_token
    probs, gate_vals, idx = route({"router": router}, cfg, xg)
    mask, pos = queue_positions(idx, e)
    keep = pos < cap

    # slot table: token index per (expert, capacity slot); sentinel gs
    # points at a zero pad row. Every overflowing (token, choice) writes
    # slot C of its expert, the column that is sliced off, so duplicate
    # writes land only there.
    slot = torch.where(keep, pos, cap)
    lin = (idx * (cap + 1) + slot).reshape(g, gs * k)
    tok_ids = torch.arange(gs, device=xg.device).repeat_interleave(k)
    table = torch.full((g, e * (cap + 1)), gs, dtype=torch.int64,
                       device=xg.device)
    table.scatter_(1, lin, tok_ids.expand(g, gs * k))
    table = table.reshape(g, e, cap + 1)[..., :cap]          # (g, E, C)

    xpad = torch.cat([xg, xg.new_zeros((g, 1, d))], dim=1)
    g_idx = torch.arange(g, device=xg.device)[:, None, None]
    xin = xpad[g_idx, table]                                  # (g, E, C, d)

    # Switch load-balance auxiliary loss: E * sum_e f_e * P_e a group
    frac_dispatched = mask.sum(dim=2).mean(dim=1)             # (g, E)
    mean_prob = probs.mean(dim=1)                             # (g, E)
    aux = e * (frac_dispatched * mean_prob).sum(dim=-1)       # (g,)
    return xin, gate_vals, idx, pos, keep, aux


def _combine(expert_out, gate_vals, keep, idx, pos, dtype):
    """Gather each token's k expert outputs from expert_out (g, E, C, d),
    gate-weight them and sum: (g, gs, d). Group by group."""
    g, e, cap, d = expert_out.shape
    eo = expert_out.reshape(g, e * cap, d)
    lin2 = torch.clamp_max(idx * cap + pos, e * cap - 1)     # (g, gs, k)
    g_idx = torch.arange(g, device=expert_out.device)[:, None, None]
    gathered = eo[g_idx, lin2]                                # (g, gs, k, d)
    w = (gate_vals * keep).to(dtype)
    return torch.einsum("gsk,gskd->gsd", w, gathered)


def _per_expert(tokens, w):
    """tokens (T, d) through each expert's w (E, d, f) -> (T, E, f), as a
    GEMM batched over E, which reads w in place. (``einsum("td,edf->tef")``
    folds (E, f) into one GEMM dim: on one device that copies w into a
    (d, E*f) layout, and on a DTensor with f sharded DTensor refuses the
    fold.)"""
    return torch.matmul(tokens, w).transpose(0, 1)


def decode_forward(params, cfg: ModelConfig, x):
    """Decode path: few tokens (B, 1, d) — every expert runs on them and
    each token's k are weight-combined; no capacity, nothing dropped."""
    b, s, d = x.shape
    e = cfg.num_experts
    tokens = x.reshape(-1, d)
    _, gate_vals, idx = route(params, cfg, tokens)            # (T, k)
    sel = F.one_hot(idx, e).float()                           # (T, k, E)
    w = (sel * gate_vals[..., None]).sum(dim=1)               # (T, E)
    h = F.silu(_per_expert(tokens, params["w_gate"]))
    h = h * _per_expert(tokens, params["w_up"])
    eo = torch.einsum("tef,efd->ted", h, params["w_down"])
    out = torch.einsum("te,ted->td", w.to(x.dtype), eo)
    return out.reshape(b, s, d), torch.zeros((), dtype=torch.float32,
                                             device=x.device)
