"""Decoder-only model assembled from a ModelConfig, the counterpart of the
JAX package's ``repro.models.transformer``: dense (llama/qwen-style), MoE
(mixtral/dbrx), SSM (rwkv6), hybrid (zamba2: mamba blocks and one shared
attention block), and the vision (a prefix of patch embeddings) and audio
(layernorm/GELU over codec tokens) backbones.

Homogeneous stacks keep their layer params stacked along a leading L axis,
as the JAX package stacks them for its ``lax.scan``; a Python loop over
the layers takes the scan's place. Heterogeneous stacks (zamba2) keep a
list of per-layer params under ``"layers_list"`` and one ``"shared_attn"``
param set that every ``shared_attn`` layer uses. On the card every
attention layer's prefill and training forward runs kernel B9
(:func:`repro_torch.kernels.ops.flash_attention`).

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
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention, layers, mamba, moe, pspec, rwkv
from repro_torch.registry import check_model_ported


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _is_homogeneous(cfg: ModelConfig) -> bool:
    return len(set(cfg.blocks())) == 1


def _layer(tree, i: int):
    """Slot ``i`` along the leading axis of every leaf of a params subtree
    (dicts and lists)."""
    if isinstance(tree, dict):
        return {name: _layer(sub, i) for name, sub in tree.items()}
    if isinstance(tree, list):
        return [_layer(sub, i) for sub in tree]
    return tree[i]


def _unbind(tree, n: int) -> list:
    """The ``n`` slots along the leading axis of every leaf of a params
    subtree of dicts, as ``n`` trees of views: one ``unbind`` a leaf, whose
    backward stacks the slots' gradients in one write (a select a slot
    would add a full-size zero gradient of the leaf for each slot)."""
    if isinstance(tree, dict):
        subs = {name: _unbind(sub, n) for name, sub in tree.items()}
        return [{name: sub[i] for name, sub in subs.items()}
                for i in range(n)]
    return list(pspec.gather_dim(tree, 0).unbind(0))


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

_MIX = {"attn": attention, "rwkv": rwkv, "mamba": mamba}


def _block_init(generator, cfg: ModelConfig, kind: str, dtype,
                with_mix: bool = True, device=None):
    """One block's params; a ``shared_attn`` block has no ``"mix"`` (it
    uses the model's ``"shared_attn"`` set)."""
    norm_init, _ = layers.make_norm(cfg.norm)
    p = {"norm1": norm_init(cfg.d_model, dtype, device),
         "norm2": norm_init(cfg.d_model, dtype, device)}
    if with_mix and kind in _MIX:
        p["mix"] = _MIX[kind].init(generator, cfg, dtype, device)
    if cfg.num_experts:
        p["ffn"] = moe.init(generator, cfg, dtype, device)
    else:
        mlp_init, _ = layers.make_mlp(cfg.act)
        p["ffn"] = mlp_init(generator, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def _apply_ffn(p, cfg: ModelConfig, x, decode: bool, group_size: int):
    if cfg.num_experts:
        if decode:
            return moe.decode_forward(p["ffn"], cfg, x)
        return moe.forward(p["ffn"], cfg, x, group_size)
    _, mlp_fn = layers.make_mlp(cfg.act)
    return mlp_fn(p["ffn"], x), torch.zeros((), dtype=torch.float32,
                                            device=x.device)


def _apply_block(p, cfg: ModelConfig, kind: str, x, *, shared=None,
                 state=None, decode: bool = False,
                 window_override=None, group_size: int = 2048):
    """Returns (x, aux, new_state)."""
    _, norm_fn = layers.make_norm(cfg.norm)
    mix_params = shared if shared is not None else p["mix"]
    x = pspec.constrain(x, "batch", None, None)
    h = pspec.constrain(norm_fn(p["norm1"], x), "batch", None, None)
    if kind in ("attn", "shared_attn"):
        if decode:
            mix_out, new_state = attention.decode_step(
                mix_params, cfg, h, state, window_override)
        else:
            mix_out = attention.forward(mix_params, cfg, h,
                                        window_override=window_override)
            new_state = state
    elif kind == "rwkv":
        mix_out, new_state = rwkv.forward(mix_params, cfg, h, state)
    elif kind == "mamba":
        mix_out, new_state = mamba.forward(mix_params, cfg, h, state)
    else:
        raise ValueError(kind)
    x = x + pspec.constrain(mix_out, "batch", None, None)
    h = pspec.constrain(norm_fn(p["norm2"], x), "batch", None, None)
    ffn_out, aux = _apply_ffn(p, cfg, h, decode, group_size)
    x = x + pspec.constrain(ffn_out, "batch", None, None)
    return x, aux, new_state


# --------------------------------------------------------------------------
# Params
# --------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None, dtype=None):
    """Random params of ``cfg``, drawn from ``generator`` (a CPU generator
    seeded with 0 when None) on the generator's device and moved to
    ``device`` (None means ``"cuda"``) in ``dtype`` (None: the config's).
    The reference's keys: ``"layers"`` stacked along L for a homogeneous
    stack; ``"layers_list"`` and ``"shared_attn"`` for a heterogeneous
    one."""
    check_model_ported(cfg)
    dev = resolve_device(device)
    dtype = dtype or _dtype(cfg)
    gen = generator if generator is not None \
        else torch.Generator().manual_seed(0)
    kinds = cfg.blocks()
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
    if _is_homogeneous(cfg):
        # drawn layer by layer into the stacked tensors: one copy of the
        # weights at a time (rwkv6-7b in f32 is 35.5 GB)
        first = _block_init(gen, cfg, kinds[0], dtype, device=dev)
        params["layers"] = _empty_stack(first, cfg.num_layers)
        _put(params["layers"], 0, first)
        del first
        for i in range(1, cfg.num_layers):
            _put(params["layers"], i,
                 _block_init(gen, cfg, kinds[0], dtype, device=dev))
    else:
        params["layers_list"] = [
            _block_init(gen, cfg, kind, dtype,
                        with_mix=kind != "shared_attn", device=dev)
            for kind in kinds]
        if "shared_attn" in kinds:
            params["shared_attn"] = attention.init(gen, cfg, dtype, dev)
    return params


# --------------------------------------------------------------------------
# Forward (train / prefill)
# --------------------------------------------------------------------------

def _blocks(params, cfg: ModelConfig):
    """(kind, block params, shared mix params or None) of each layer."""
    kinds = cfg.blocks()
    if _is_homogeneous(cfg):
        return [(kinds[0], p, None)
                for p in _unbind(params["layers"], cfg.num_layers)]
    return [(kind, params["layers_list"][i],
             params.get("shared_attn") if kind == "shared_attn" else None)
            for i, kind in enumerate(kinds)]


def forward(params, cfg: ModelConfig, batch: dict, *, window_override=None,
            group_size: int = 2048, remat: bool = False,
            last_only: bool = False):
    """batch: {"tokens": (B, S) int} (+ "embeds": (B, P, d) for a vision
    model, a prefix before the text). Returns (logits (B, S_out, V) f32
    over the text positions, aux scalar: the MoE load-balance loss summed
    over layers). ``group_size``: tokens per MoE routing group.
    ``remat``: recompute each block in the backward
    (``torch.utils.checkpoint``). last_only: unembed only the final
    position (prefill serving — avoids the (B,S,V) logits).
    Differentiable: on the card the attention and wkv kernels run the
    forward and the backward differentiates their plain versions
    (:func:`repro_torch.kernels.ops.flash_attention`,
    :func:`repro_torch.kernels.ops.rwkv6_scan`)."""
    check_model_ported(cfg)
    tokens = batch["tokens"]
    x = layers.embed(params["embed"], tokens).to(_dtype(cfg))
    x = pspec.constrain(x, "batch", None, None)
    n_text = tokens.shape[1]
    vision = cfg.modality == "vision" and "embeds" in batch
    if vision:
        x = torch.cat([batch["embeds"].to(x.dtype), x], dim=1)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, p, shared in _blocks(params, cfg):
        def blk(p, h, sh, kind=kind):
            out, a, _ = _apply_block(p, cfg, kind, h, shared=sh,
                                     window_override=window_override,
                                     group_size=group_size)
            return out, a

        if remat:
            x, a = checkpoint(blk, p, x, shared, use_reentrant=False)
        else:
            x, a = blk(p, x, shared)
        aux = aux + a
    _, norm_fn = layers.make_norm(cfg.norm)
    x = norm_fn(params["final_norm"], x)
    if vision:
        x = x[:, -n_text:, :]                      # loss on text positions
    if last_only:
        x = x[:, -1:, :]
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = layers.unembed(head, x)
    logits = pspec.constrain(logits, "batch", None, "vocab")
    return logits, aux


def loss_fn(params, cfg: ModelConfig, batch: dict, **kw):
    """Next-token cross entropy (labels provided by the data pipeline), the
    training loss: logsumexp minus the label's logit, masked mean, plus
    ``router_aux_coef`` times the MoE load-balance loss."""
    logits, aux = forward(params, cfg, batch, **kw)
    labels = batch["labels"].long()
    # the label's logit is subtracted before the last dim is dropped: a
    # DTensor reduces the partial result of a gather over vocab shards at
    # the (..., 1) shape the gather made
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    picked = torch.gather(logits, -1, labels[..., None])
    nll = (lse - picked)[..., 0]
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
    # per-layer mix states: stacked along L for a homogeneous stack (KV
    # caches, rwkv or mamba states), a list for a heterogeneous one
    states: object
    pos: torch.Tensor


def _layer_state(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 dtype, window, device=None):
    if kind in ("attn", "shared_attn"):
        return attention.init_cache(cfg, batch, max_len, dtype, window,
                                    device)
    if kind == "rwkv":
        return rwkv.init_state(cfg, batch, device)
    if kind == "mamba":
        return mamba.init_state(cfg, batch, device)
    raise ValueError(kind)


def init_decode(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                window_override=None, device=None) -> DecodeState:
    """Empty per-layer states for ``batch`` sequences of up to ``max_len``
    tokens: KV caches (a ring buffer of the window's size when a window
    applies), zero rwkv or mamba states (``max_len`` unused: O(1) in
    length)."""
    check_model_ported(cfg)
    dev = resolve_device(device)
    dtype = dtype or _dtype(cfg)
    window = window_override if window_override is not None \
        else cfg.sliding_window
    kinds = cfg.blocks()
    if _is_homogeneous(cfg):
        one = _layer_state(cfg, kinds[0], batch, max_len, dtype, window, dev)
        states = type(one)(
            *(t.expand((cfg.num_layers,) + t.shape).clone() for t in one))
    else:
        states = [_layer_state(cfg, kind, batch, max_len, dtype, window, dev)
                  for kind in kinds]
    return DecodeState(states=states,
                       pos=torch.zeros((), dtype=torch.int32, device=dev))


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, state: DecodeState,
                tokens: torch.Tensor, *, window_override=None):
    """tokens: (B,) int — one new token per sequence.
    Returns (logits (B, V) f32, new DecodeState). KV caches of ``state``
    are updated in place (see :func:`attention.decode_step`); rwkv and
    mamba states are not: the new state holds new tensors, as in the JAX
    package."""
    check_model_ported(cfg)
    x = layers.embed(params["embed"], tokens[:, None]).to(_dtype(cfg))
    homogeneous = _is_homogeneous(cfg)
    kind_of = type(state.states) if homogeneous else None
    news = []
    for i, (kind, p, shared) in enumerate(_blocks(params, cfg)):
        st = kind_of(*(t[i] for t in state.states)) if homogeneous \
            else state.states[i]
        x, _, new = _apply_block(p, cfg, kind, x, shared=shared, state=st,
                                 decode=True,
                                 window_override=window_override)
        news.append(new)
    _, norm_fn = layers.make_norm(cfg.norm)
    x = norm_fn(params["final_norm"], x)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = layers.unembed(head, x)[:, 0, :]
    if not homogeneous:
        states = news
    elif kind_of is attention.KVCache:
        states = attention.KVCache(state.states.k, state.states.v,
                                   torch.stack([n.length for n in news]))
    else:
        states = kind_of(*(torch.stack(t) for t in zip(*news)))
    return logits, DecodeState(states=states, pos=state.pos + 1)
