"""Step functions, the counterpart of the JAX package's
``repro.launch.steps``: the federated train step (one C-DFL round over
node-stacked state), the serving steps (prefill a batch of prompts, decode
one token against the per-layer states) for every model family (dense,
MoE, ssm, hybrid, vision, audio), and the abstract inputs of each (shapes
and dtypes on the ``meta`` device, never allocated).

Consensus on one card: node params carry a leading F dim, and the ring
neighbor exchange of :func:`ring_consensus_roll` reads node k-1 and k+1
along it. The reference's sharding rules over its ``("fed", "dp", "tp")``
mesh have no meaning on one device and wait for the mesh code (ROADMAP
queue A item 24).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import (FedConfig, ModelConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.core import flatten
from repro_torch.models import transformer
from repro_torch.optim.adam import AdamState, adam


class MeshFedState(NamedTuple):
    params: object          # leaves (F, ...), the config's dtype
    opt: object             # AdamState: step (F,) int32, m/v leaves (F, ...) f32
    ratios: torch.Tensor    # (F,) CND distinct ratios


@torch.no_grad()
def ring_consensus_roll(params, ratios: torch.Tensor, gamma: float):
    """Paper eq. (5) on the ring, over the node dim:
    phi_k = W_k + gamma*(eta_prev*(W_{k-1}-W_k) + eta_next*(W_{k+1}-W_k)),
    eta from the CND ratios per eq. (6), in f32; each leaf mixes in its own
    dtype, node by node (the temporaries cover one node's leaf)."""
    r_prev = torch.roll(ratios, 1)
    r_next = torch.roll(ratios, -1)
    denom = torch.clamp_min(r_prev + r_next, 1e-12)
    eta_prev = (r_prev / denom).to(torch.float32)
    eta_next = (r_next / denom).to(torch.float32)

    def mix(leaf):
        f = leaf.shape[0]
        ep = eta_prev.to(leaf.dtype)
        en = eta_next.to(leaf.dtype)
        g = torch.tensor(gamma, dtype=leaf.dtype, device=leaf.device)
        out = torch.empty_like(leaf)
        for k in range(f):
            w, w_prev, w_next = leaf[k], leaf[(k - 1) % f], leaf[(k + 1) % f]
            torch.add(w, g * (ep[k] * (w_prev - w) + en[k] * (w_next - w)),
                      out=out[k])
        return out

    return flatten.tree_map(mix, params)


def make_fed_train_step(cfg: ModelConfig, fed: FedConfig,
                        train: TrainConfig):
    """One C-DFL round (consensus + one local Adam step per node) over
    node-stacked state: ``train_step(state, batch) -> (new_state, mean
    loss)``, ``batch`` leaves ``(F, B, ...)``.

    A loop over the nodes takes the place of the reference's ``vmap``:
    the kernels are launched through ctypes, which ``torch.func.vmap``
    cannot batch. Node k's loss (``transformer.loss_fn``, the MoE aux term
    included; on the card every attention layer's forward through kernel
    B9 and every rwkv wkv scan through B10) is differentiated with respect
    to detached copies of its own slices of phi, so autograd writes each
    gradient once at its own size. Its Adam step (clipping over its own
    leaves, a scheduled rate at its own step) follows at once, leaf by
    leaf, and writes the new params over phi's slice and the new moments
    over ``state.opt``'s: the step owns its input state (the reference's
    jitted step donates it), which must not be used again."""
    opt = adam(train.learning_rate, train.beta1, train.beta2, train.eps,
               train.weight_decay, train.grad_clip)
    remat = train.remat == "full"

    def node_loss(params, batch):
        return transformer.loss_fn(params, cfg, batch, remat=remat)

    def train_step(state: MeshFedState, batch) -> tuple:
        # Alg. 2: receive neighbors' (w, bitmaps) -> consensus -> ModelUpdate
        phi = ring_consensus_roll(state.params, state.ratios, fed.gamma)
        pairs = flatten.leaves_with_paths(phi)
        paths = [path for path, _ in pairs]
        leaves = [leaf for _, leaf in pairs]
        moments = [[leaf for _, leaf in flatten.leaves_with_paths(tree)]
                   for tree in (state.opt.m, state.opt.v)]
        losses, steps = [], []
        for k in range(leaves[0].shape[0]):
            own = [leaf[k].detach().requires_grad_() for leaf in leaves]
            loss = node_loss(flatten.build_tree(paths, own),
                             {name: v[k] for name, v in batch.items()})
            grads = torch.autograd.grad(loss, own, materialize_grads=True)
            del own
            node = AdamState(step=state.opt.step[k],
                             m=[m[k] for m in moments[0]],
                             v=[v[k] for v in moments[1]])
            _, node = opt.update(list(grads), node,
                                 [leaf[k] for leaf in leaves], inplace=True)
            del grads
            losses.append(loss.detach())
            steps.append(node.step)
        opt_state = AdamState(step=torch.stack(steps), m=state.opt.m,
                              v=state.opt.v)
        new_state = MeshFedState(phi, opt_state, state.ratios)
        return new_state, torch.stack(losses).mean()

    return train_step


def make_prefill_step(cfg: ModelConfig, window_override=None):
    """``prefill_step(params, batch) -> (B,) int32``: the whole prompt in
    one forward (on the card, every attention layer — dense, MoE, the
    hybrid's shared blocks, vision, audio — through kernel B9; the rwkv
    wkv scan through kernel B10 when the prompt is a multiple of 16
    tokens), logits of the last position only. ``batch`` is passed whole:
    a vision model's ``"embeds"`` prefix goes in with the tokens."""

    def prefill_step(params, batch):
        with torch.no_grad():
            logits, _ = transformer.forward(
                params, cfg, batch, window_override=window_override,
                last_only=True)
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
    return prefill_step


def make_serve_step(cfg: ModelConfig, window_override=None):
    """Single-token decode against a KV cache of seq_len tokens, or an
    rwkv or mamba state (the per-token recurrence, no kernel); MoE layers
    run every expert on the decode tokens:
    ``serve_step(params, decode_state, tokens) -> ((B,) int32,
    new_state)``."""

    def serve_step(params, decode_state, tokens):
        with torch.no_grad():
            logits, new_state = transformer.decode_step(
                params, cfg, decode_state, tokens,
                window_override=window_override)
        return torch.argmax(logits, dim=-1).to(torch.int32), new_state
    return serve_step


# --------------------------------------------------------------------------
# Abstract inputs: tensors on the meta device (shape and dtype, no storage),
# the counterpart of the reference's ShapeDtypeStructs.
# --------------------------------------------------------------------------

def _sds(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _meta(tree):
    """Every tensor of a tree of dicts, lists and NamedTuples as a meta
    tensor of its shape and dtype."""
    if isinstance(tree, dict):
        return {name: _meta(sub) for name, sub in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_meta(sub) for sub in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_meta(sub) for sub in tree)
    return _sds(tree.shape, tree.dtype)


def _abstract(fn):
    """What ``fn()`` returns, as meta tensors: run under a fake-tensor mode,
    so that nothing is drawn or allocated (internvl2-26b's init would draw
    about 80 GB of f32 on the host)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        out = fn()
    return _meta(out)


def fed_state_struct(cfg: ModelConfig, fed_nodes: int,
                     train: TrainConfig):
    """Abstract MeshFedState for arch cfg with F nodes: params in the
    config's dtype, the Adam step ``(F,)`` and its moments in f32."""
    params0 = serve_params_struct(cfg)

    def stack(dtype=None):
        return lambda leaf: _sds((fed_nodes,) + tuple(leaf.shape),
                                 dtype or leaf.dtype)

    params = flatten.tree_map(stack(), params0)
    opt = AdamState(step=_sds((fed_nodes,), torch.int32),
                    m=flatten.tree_map(stack(torch.float32), params0),
                    v=flatten.tree_map(stack(torch.float32), params0))
    ratios = _sds((fed_nodes,), torch.float32)
    return MeshFedState(params=params, opt=opt, ratios=ratios)


def serve_params_struct(cfg: ModelConfig):
    return _abstract(lambda: transformer.init_params(cfg, device="cpu"))


def input_specs(cfg: ModelConfig, shape: ShapeConfig, fed_nodes: int = 0,
                window_override=None):
    """Abstract model inputs for (arch x input-shape).

    train:   {"tokens": (F, B/F, S), "labels": ...} [+ "embeds" for VLM]
    prefill: {"tokens": (B, S)} [+ "embeds"]
    decode:  tokens (B,) — the DecodeState comes from decode_state_struct.
    """
    if shape.mode == "train":
        assert fed_nodes > 0 and shape.global_batch % fed_nodes == 0
        b = shape.global_batch // fed_nodes
        lead = (fed_nodes, b)
    else:
        lead = (shape.global_batch,)

    if shape.mode == "decode":
        return {"tokens": _sds(lead, torch.int32)}

    batch = {}
    s = shape.seq_len
    if cfg.modality == "vision":
        p = cfg.num_patches
        batch["embeds"] = _sds(lead + (p, cfg.d_model),
                               getattr(torch, cfg.dtype))
        s = s - p
    batch["tokens"] = _sds(lead + (s,), torch.int32)
    if shape.mode == "train":
        batch["labels"] = _sds(lead + (s,), torch.int32)
    return batch


def decode_state_struct(cfg: ModelConfig, shape: ShapeConfig,
                        window_override=None):
    return _abstract(lambda: transformer.init_decode(
        cfg, shape.global_batch, shape.seq_len,
        window_override=window_override, device="cpu"))
