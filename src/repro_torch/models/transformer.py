"""Decoder-only model assembled from a ModelConfig: the homogeneous stacks
of the JAX package's ``repro.models.transformer``, the dense family
(llama/qwen-style attention) and the ssm family (rwkv6 blocks).

Layer params are stacked along a leading L axis, as the JAX package stacks
them for its ``lax.scan``; a Python loop over the layers takes the scan's
place. MoE, hybrid (zamba2) and the vision and audio modalities are not
ported yet: every entry point refuses them with the ROADMAP item that
ports them (:data:`repro_torch.registry.MODEL_NOT_PORTED`).

API:
  init_params(cfg, generator, device, dtype) -> params dict
  forward(params, cfg, batch, ...)            -> (logits, aux_loss)
  loss_fn(params, cfg, batch)                 -> scalar
  node_losses(params, cfg, batch)             -> (K,) over node-stacked params
  init_decode(cfg, batch, max_len, ...)       -> DecodeState
  decode_step(params, cfg, state, tokens)     -> (logits, DecodeState)
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention, layers, rwkv
from repro_torch.registry import check_model_ported


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _layer(tree, i: int):
    """Layer ``i`` of a params subtree stacked along a leading L axis."""
    if isinstance(tree, dict):
        return {name: _layer(sub, i) for name, sub in tree.items()}
    return tree[i]


def _empty_stack(tree, n: int):
    """Uninitialised tensors of ``tree``'s leaves with a leading axis of
    ``n``."""
    if isinstance(tree, dict):
        return {name: _empty_stack(sub, n) for name, sub in tree.items()}
    return tree.new_empty((n,) + tuple(tree.shape))


def _put(stacked, i: int, tree) -> None:
    """Write ``tree``'s leaves into slot ``i`` of ``stacked``."""
    if isinstance(tree, dict):
        for name, sub in tree.items():
            _put(stacked[name], i, sub)
    else:
        stacked[i] = tree


# --------------------------------------------------------------------------
# Block init / apply
# --------------------------------------------------------------------------

def _kind(cfg: ModelConfig) -> str:
    """The block kind of a homogeneous stack: ``attn`` or ``rwkv``."""
    return cfg.blocks()[0]


def _block_init(generator, cfg: ModelConfig, dtype, device):
    norm_init, _ = layers.make_norm(cfg.norm)
    mlp_init, _ = layers.make_mlp(cfg.act)
    mix = rwkv if _kind(cfg) == "rwkv" else attention
    return {"norm1": norm_init(cfg.d_model, dtype, device),
            "norm2": norm_init(cfg.d_model, dtype, device),
            "mix": mix.init(generator, cfg, dtype, device),
            "ffn": mlp_init(generator, cfg.d_model, cfg.d_ff, dtype, device)}


def _apply_block(p, cfg: ModelConfig, x, *, state=None, decode: bool = False,
                 window_override=None):
    """Returns (x, new_state)."""
    _, norm_fn = layers.make_norm(cfg.norm)
    _, mlp_fn = layers.make_mlp(cfg.act)
    h = norm_fn(p["norm1"], x)
    if _kind(cfg) == "rwkv":
        mix_out, new_state = rwkv.forward(p["mix"], cfg, h, state)
    elif decode:
        mix_out, new_state = attention.decode_step(p["mix"], cfg, h, state,
                                                   window_override)
    else:
        mix_out = attention.forward(p["mix"], cfg, h,
                                    window_override=window_override)
        new_state = state
    x = x + mix_out
    h = norm_fn(p["norm2"], x)
    return x + mlp_fn(p["ffn"], h), new_state


# --------------------------------------------------------------------------
# Params
# --------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None, dtype=None):
    """Random params of ``cfg``, drawn from ``generator`` (a CPU generator
    seeded with 0 when None) on the generator's device and moved to
    ``device`` (None means ``"cuda"``) in ``dtype`` (None: the config's)."""
    check_model_ported(cfg)
    dev = resolve_device(device)
    dtype = dtype or _dtype(cfg)
    gen = generator if generator is not None \
        else torch.Generator().manual_seed(0)
    norm_init, _ = layers.make_norm(cfg.norm)
    params = {
        "embed": layers.embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                       dtype, dev),
        "final_norm": norm_init(cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {
            "table": layers._dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                        scale=0.02, dtype=dtype, device=dev)}
    # drawn layer by layer into the stacked tensors: one copy of the
    # weights at a time (rwkv6-7b in f32 is 35.5 GB)
    first = _block_init(gen, cfg, dtype, dev)
    params["layers"] = _empty_stack(first, cfg.num_layers)
    _put(params["layers"], 0, first)
    del first
    for i in range(1, cfg.num_layers):
        _put(params["layers"], i, _block_init(gen, cfg, dtype, dev))
    return params


# --------------------------------------------------------------------------
# Forward (train / prefill)
# --------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, batch: dict, *, window_override=None,
            last_only: bool = False):
    """batch: {"tokens": (B, S) int}. Returns (logits (B, S_out, V) f32,
    aux scalar). last_only: unembed only the final position (prefill
    serving — avoids the (B,S,V) logits). Differentiable: on the card the
    attention and wkv kernels run the forward and the backward
    differentiates their plain versions
    (:func:`repro_torch.kernels.ops.flash_attention`,
    :func:`repro_torch.kernels.ops.rwkv6_scan`)."""
    check_model_ported(cfg)
    tokens = batch["tokens"]
    x = layers.embed(params["embed"], tokens).to(_dtype(cfg))
    for i in range(cfg.num_layers):
        x, _ = _apply_block(_layer(params["layers"], i), cfg, x,
                            window_override=window_override)
    _, norm_fn = layers.make_norm(cfg.norm)
    x = norm_fn(params["final_norm"], x)
    if last_only:
        x = x[:, -1:, :]
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = layers.unembed(head, x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params, cfg: ModelConfig, batch: dict, **kw):
    """Next-token cross entropy (labels provided by the data pipeline), the
    training loss: logsumexp minus the label's logit, masked mean."""
    logits, aux = forward(params, cfg, batch, **kw)
    labels = batch["labels"].long()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = lse - picked
    mask = batch.get("mask")
    if mask is not None:
        mask = mask.float()
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    else:
        loss = nll.mean()
    return loss + cfg.router_aux_coef * aux


def node_losses(params, cfg: ModelConfig, batch: dict):
    """:func:`loss_fn` of each of K nodes, stacked: ``params`` leaves
    ``(K, ...)`` (node-stacked views of the flat buffer), ``batch`` leaves
    ``(K, B, T)`` -> ``(K,)``. A loop over the nodes takes the place of the
    JAX package's ``vmap``: the kernels are launched through ctypes, which
    ``torch.func.vmap`` cannot batch."""
    k = next(iter(batch.values())).shape[0]
    return torch.stack([
        loss_fn(_layer(params, i), cfg,
                {name: v[i] for name, v in batch.items()})
        for i in range(k)])


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------

class DecodeState(NamedTuple):
    # per-layer mix states stacked along L: KV caches (attn) or wkv
    # states (rwkv)
    states: attention.KVCache | rwkv.RwkvState
    pos: torch.Tensor


def init_decode(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                window_override=None, device=None) -> DecodeState:
    """Empty per-layer states for ``batch`` sequences of up to ``max_len``
    tokens: KV caches (a ring buffer of the window's size when a window
    applies) or zero rwkv states (``max_len`` unused: O(1) in length)."""
    check_model_ported(cfg)
    dev = resolve_device(device)
    dtype = dtype or _dtype(cfg)
    window = window_override if window_override is not None \
        else cfg.sliding_window
    if _kind(cfg) == "rwkv":
        one = rwkv.init_state(cfg, batch, dev)
    else:
        one = attention.init_cache(cfg, batch, max_len, dtype, window, dev)
    states = type(one)(
        *(t.expand((cfg.num_layers,) + t.shape).clone() for t in one))
    return DecodeState(states=states,
                       pos=torch.zeros((), dtype=torch.int32, device=dev))


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, state: DecodeState,
                tokens: torch.Tensor, *, window_override=None):
    """tokens: (B,) int — one new token per sequence.
    Returns (logits (B, V) f32, new DecodeState). KV caches of ``state``
    are updated in place (see :func:`attention.decode_step`); rwkv states
    are not: the new state holds new tensors, as in the JAX package."""
    check_model_ported(cfg)
    x = layers.embed(params["embed"], tokens[:, None]).to(_dtype(cfg))
    kind = type(state.states)
    news = []
    for i in range(cfg.num_layers):
        x, new = _apply_block(_layer(params["layers"], i), cfg, x,
                              state=kind(*(t[i] for t in state.states)),
                              decode=True, window_override=window_override)
        news.append(new)
    _, norm_fn = layers.make_norm(cfg.norm)
    x = norm_fn(params["final_norm"], x)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = layers.unembed(head, x)[:, 0, :]
    if kind is rwkv.RwkvState:
        states = rwkv.RwkvState(*(torch.stack(t) for t in zip(*news)))
    else:
        states = attention.KVCache(state.states.k, state.states.v,
                                   torch.stack([n.length for n in news]))
    return logits, DecodeState(states=states, pos=state.pos + 1)
