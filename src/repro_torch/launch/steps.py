"""Step functions, the counterpart of the JAX package's
``repro.launch.steps``: the federated train step (one C-DFL round over
node-stacked state), the serving steps (prefill a batch of prompts, decode
one token against the per-layer states) for every model family (dense,
MoE, ssm, hybrid, vision, audio), and the abstract inputs of each (shapes
and dtypes on the ``meta`` device, never allocated).

Consensus: node params carry a leading F dim, and the ring neighbor
exchange of :func:`ring_consensus_roll` reads node k-1 and k+1 along it.
Each step installs the reference's logical sharding rules
(``pspec.TRAIN_RULES``, ``SERVE_RULES`` or ``SERVE_RULES_MULTIPOD``),
which only act on DTensors.

Mesh mode: when the state's leaves are DTensors (placed by
:mod:`repro_torch.launch.sharding`), a step runs what this rank holds —
the counterpart of GSPMD running the reference's ``vmap`` shard by
shard. The train step's leaves are sharded over the fed axes, so a rank
holds a contiguous run of nodes (pod major); it sends its last nodes
forward and its first nodes back over the fed group (the permutes of
:func:`repro_torch.core.consensus.ring_neighbors`, one node each way) and
mixes with the arithmetic of :func:`ring_consensus_roll`, so a ring of
one rank gives the plain step's bits. Each node's loss, gradient and
in-place Adam then run on its ``("dp", "tp")`` sub-mesh: on local
tensors when the sub-mesh is one device (the kernels launch as in the
plain step), on DTensors otherwise — which only the CPU and the meta
device run: the kernels take whole tensors, so a CUDA sub-mesh of more
than one device raises ``NotImplementedError``. The serving steps
follow the same rule over the production mesh.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import (FedConfig, ModelConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.core import flatten
from repro_torch.models import pspec, transformer
from repro_torch.optim.adam import AdamState, adam


class MeshFedState(NamedTuple):
    params: object          # leaves (F, ...), the config's dtype
    opt: object             # AdamState: step (F,) int32, m/v leaves (F, ...) f32
    ratios: torch.Tensor    # (F,) CND distinct ratios


def _ring_eta(r_prev, r_next):
    """Eq. (6) on the ring: each node's weights for its two neighbors."""
    denom = torch.clamp_min(r_prev + r_next, 1e-12)
    return (r_prev / denom).to(torch.float32), \
        (r_next / denom).to(torch.float32)


def _mix_leaf(leaf, eta_prev, eta_next, gamma, halo_prev=None,
              halo_next=None):
    """Eq. (5) over the node dim of one leaf, node by node in the leaf's
    dtype. Node 0's previous and the last node's next neighbor are the
    halos when given (the nodes of the neighboring ranks), else the ring
    wraps around the leaf."""
    f = leaf.shape[0]
    ep = eta_prev.to(leaf.dtype)
    en = eta_next.to(leaf.dtype)
    g = torch.tensor(gamma, dtype=leaf.dtype, device=leaf.device)
    out = torch.empty_like(leaf)
    for k in range(f):
        w = leaf[k]
        w_prev = halo_prev if k == 0 and halo_prev is not None \
            else leaf[(k - 1) % f]
        w_next = halo_next if k == f - 1 and halo_next is not None \
            else leaf[(k + 1) % f]
        torch.add(w, g * (ep[k] * (w_prev - w) + en[k] * (w_next - w)),
                  out=out[k])
    return out


@torch.no_grad()
def ring_consensus_roll(params, ratios: torch.Tensor, gamma: float):
    """Paper eq. (5) on the ring, over the node dim:
    phi_k = W_k + gamma*(eta_prev*(W_{k-1}-W_k) + eta_next*(W_{k+1}-W_k)),
    eta from the CND ratios per eq. (6), in f32; each leaf mixes in its own
    dtype, node by node (the temporaries cover one node's leaf)."""
    eta_prev, eta_next = _ring_eta(torch.roll(ratios, 1),
                                   torch.roll(ratios, -1))
    return flatten.tree_map(
        lambda leaf: _mix_leaf(leaf, eta_prev, eta_next, gamma), params)


def _is_dtensor(t) -> bool:
    if type(t) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _edges(tensors, axes, mesh):
    """``(last node of the previous rank, first node of the next rank)``
    of each ``(F_local, ...)`` tensor, from the ring over the mesh
    dimensions ``axes``: per dtype, one buffer of the last nodes goes
    forward and one of the first nodes back (the same buffer when the
    rank holds one node), one node's bytes each way."""
    from repro_torch.core.consensus import _ring_pass
    out = [None] * len(tensors)
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    for members in groups.values():
        lasts = torch.cat([tensors[i][-1].reshape(-1) for i in members])
        firsts = lasts if tensors[members[0]].shape[0] == 1 else \
            torch.cat([tensors[i][0].reshape(-1) for i in members])
        prev_last, next_first = _ring_pass(lasts, firsts, axes, mesh=mesh)
        del lasts, firsts
        off = 0
        for i in members:
            shape = tensors[i].shape[1:]
            size = shape.numel()
            out[i] = (prev_last[off:off + size].view(shape),
                      next_first[off:off + size].view(shape))
            off += size
    return out


def _node_placements(placements, axes, names):
    """A fed-mesh leaf's placements on the node's sub-mesh: the fed axes
    (which shard dim 0, the node dim) dropped and every other shard moved
    down one dim."""
    from torch.distributed.tensor import Shard
    out = []
    for name, pl in zip(names, placements):
        if name in axes:
            continue
        out.append(Shard(pl.dim - 1) if isinstance(pl, Shard) else pl)
    return out


def _one_device(mesh) -> bool:
    return mesh.size() == 1


def _sub_mesh_guard(mesh, device_type: str) -> None:
    if device_type == "cuda" and not _one_device(mesh):
        raise NotImplementedError(
            f"a step on a CUDA mesh of {mesh.size()} devices: the kernels "
            f"take whole tensors, not shards")


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
    jitted step donates it), which must not be used again.

    With DTensor leaves (mesh mode, see the module's note) the same runs
    on this rank's nodes; the loss returned is the mean over every node
    of the ring."""
    opt = adam(train.learning_rate, train.beta1, train.beta2, train.eps,
               train.weight_decay, train.grad_clip)
    remat = train.remat == "full"

    def node_loss(params, batch):
        return transformer.loss_fn(params, cfg, batch, remat=remat)

    def node_steps(paths, leaves, moments, step, batch, on_node=None):
        """Loss, gradient and in-place Adam of each node along dim 0 of
        ``leaves``. ``on_node(local, key)`` gives a node's slice as a
        DTensor on its sub-mesh (sharing the slice's storage, so Adam's
        in-place writes land in ``leaves`` and ``moments``); None keeps
        the slices."""
        place = on_node or (lambda local, key: local)
        losses, steps = [], []
        for k in range(leaves[0].shape[0]):
            own = [place(leaf[k], i).detach().requires_grad_()
                   for i, leaf in enumerate(leaves)]
            loss = node_loss(flatten.build_tree(paths, own),
                             {name: place(v[k], name)
                              for name, v in batch.items()})
            grads = torch.autograd.grad(loss, own, materialize_grads=True)
            if on_node is not None:
                grads = [g.redistribute(p.device_mesh, p.placements)
                         for g, p in zip(grads, own)]
                loss = loss.full_tensor()
            del own
            node = AdamState(step=step[k],
                             m=[place(m[k], i)
                                for i, m in enumerate(moments[0])],
                             v=[place(v[k], i)
                                for i, v in enumerate(moments[1])])
            _, node = opt.update(list(grads), node,
                                 [place(leaf[k], i)
                                  for i, leaf in enumerate(leaves)],
                                 inplace=True)
            del grads
            losses.append(loss.detach())
            steps.append(node.step)
        return torch.stack(losses), torch.stack(steps)

    def mesh_step(state: MeshFedState, batch) -> tuple:
        from torch.distributed.tensor import DTensor
        from repro_torch.launch import mesh as meshlib
        mesh = state.ratios.device_mesh
        names = mesh.mesh_dim_names
        axes = meshlib.fed_axes(mesh)
        node_mesh = mesh[tuple(n for n in names if n not in axes)]
        _sub_mesh_guard(node_mesh, mesh.device_type)
        pairs = flatten.leaves_with_paths(state.params)
        paths = [path for path, _ in pairs]
        dleaves = [leaf for _, leaf in pairs]
        leaves = [leaf.to_local() for leaf in dleaves]
        ratios = state.ratios.to_local()
        halos = _edges(leaves + [ratios], axes, mesh)
        r_halo = halos.pop()
        eta_prev, eta_next = _ring_eta(
            torch.cat([r_halo[0][None], ratios[:-1]]),
            torch.cat([ratios[1:], r_halo[1][None]]))
        with torch.no_grad():
            phi = [_mix_leaf(leaf, eta_prev, eta_next, fed.gamma, hp, hn)
                   for leaf, (hp, hn) in zip(leaves, halos)]
        del halos
        moments = [[leaf.to_local() for _, leaf in
                    flatten.leaves_with_paths(tree)]
                   for tree in (state.opt.m, state.opt.v)]
        step = state.opt.step.to_local()
        lbatch = {name: v.to_local() for name, v in batch.items()}
        if _one_device(node_mesh):
            losses, steps = node_steps(paths, phi, moments, step, lbatch)
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            like = dict(enumerate(dleaves))
            like.update(batch)
            with implicit_replication():
                losses, steps = node_steps(
                    paths, phi, moments, step, lbatch,
                    _on_node(node_mesh, like, axes, names))

        def wrap(local, like):
            return DTensor.from_local(local, mesh, like.placements,
                                      run_check=False, shape=like.shape,
                                      stride=like.stride())

        params = flatten.build_tree(
            paths, [wrap(p, d) for p, d in zip(phi, dleaves)])
        opt_state = AdamState(step=wrap(steps, state.opt.step),
                              m=state.opt.m, v=state.opt.v)
        new_state = MeshFedState(params, opt_state, state.ratios)
        loss = wrap(losses, state.ratios).mean()
        return new_state, loss.full_tensor()

    def train_step(state: MeshFedState, batch) -> tuple:
        # Alg. 2: receive neighbors' (w, bitmaps) -> consensus -> ModelUpdate
        with pspec.logical_rules(pspec.TRAIN_RULES):
            if _is_dtensor(state.ratios):
                return mesh_step(state, batch)
            phi = ring_consensus_roll(state.params, state.ratios, fed.gamma)
            pairs = flatten.leaves_with_paths(phi)
            paths = [path for path, _ in pairs]
            leaves = [leaf for _, leaf in pairs]
            moments = [[leaf for _, leaf in flatten.leaves_with_paths(tree)]
                       for tree in (state.opt.m, state.opt.v)]
            losses, steps = node_steps(paths, leaves, moments,
                                       state.opt.step, batch)
            opt_state = AdamState(step=steps, m=state.opt.m, v=state.opt.v)
            new_state = MeshFedState(phi, opt_state, state.ratios)
            return new_state, losses.mean()

    return train_step


def _on_node(node_mesh, like: dict, axes, names):
    """``(local, key) -> DTensor``: one node's local shard on
    ``node_mesh``, placed as the fed-mesh DTensor ``like[key]`` is with
    its node dim taken off."""
    from torch.distributed.tensor import DTensor

    def place(local, key):
        ref = like[key]
        shape = tuple(ref.shape[1:])
        return DTensor.from_local(
            local, node_mesh, _node_placements(ref.placements, axes, names),
            run_check=False, shape=shape,
            stride=torch.empty(shape, device="meta").stride())
    return place


def _on_mesh(fn, anchor, *trees):
    """``fn(*trees)``, by the mesh rule of the module's note when
    ``anchor`` is a DTensor: on local tensors when its mesh is one device
    (the outputs come back as replicated DTensors), on the DTensors
    otherwise (CPU and meta only)."""
    if not _is_dtensor(anchor):
        return fn(*trees)
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch.sharding import tree_map_with_path
    mesh = anchor.device_mesh
    _sub_mesh_guard(mesh, mesh.device_type)
    if not _one_device(mesh):
        with implicit_replication():
            return fn(*trees)
    out = fn(*(tree_map_with_path(lambda _, leaf: leaf.to_local(), tree)
               for tree in trees))
    return tree_map_with_path(
        lambda _, leaf: DTensor.from_local(
            leaf, mesh, [Replicate()] * mesh.ndim, run_check=False), out)


def _argmax(logits):
    """(B, V) -> (B,) int32. A DTensor's vocab shards are gathered first:
    DTensor's argmax over a sharded dim fails (torch 2.13)."""
    logits = pspec.constrain(logits, "batch", None)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_prefill_step(cfg: ModelConfig, window_override=None,
                      multi_pod: bool = False):
    """``prefill_step(params, batch) -> (B,) int32``: the whole prompt in
    one forward (on the card, every attention layer — dense, MoE, the
    hybrid's shared blocks, vision, audio — through kernel B9; the rwkv
    wkv scan through kernel B10 when the prompt is a multiple of 16
    tokens), logits of the last position only. ``batch`` is passed whole:
    a vision model's ``"embeds"`` prefix goes in with the tokens.
    ``multi_pod``: the two-pod mesh's rules (batch over ``("pod",
    "data")``)."""
    rules = pspec.SERVE_RULES_MULTIPOD if multi_pod else pspec.SERVE_RULES

    def run(params, batch):
        with torch.no_grad():
            logits, _ = transformer.forward(
                params, cfg, batch, window_override=window_override,
                last_only=True)
        return _argmax(logits[:, -1, :])

    def prefill_step(params, batch):
        with pspec.logical_rules(rules):
            return _on_mesh(run, batch["tokens"], params, batch)
    return prefill_step


def make_serve_step(cfg: ModelConfig, window_override=None,
                    multi_pod: bool = False):
    """Single-token decode against a KV cache of seq_len tokens, or an
    rwkv or mamba state (the per-token recurrence, no kernel); MoE layers
    run every expert on the decode tokens:
    ``serve_step(params, decode_state, tokens) -> ((B,) int32,
    new_state)``. ``multi_pod`` as in :func:`make_prefill_step`."""
    rules = pspec.SERVE_RULES_MULTIPOD if multi_pod else pspec.SERVE_RULES

    def run(params, decode_state, tokens):
        with torch.no_grad():
            logits, new_state = transformer.decode_step(
                params, cfg, decode_state, tokens,
                window_override=window_override)
        return _argmax(logits), new_state

    def serve_step(params, decode_state, tokens):
        with pspec.logical_rules(rules):
            return _on_mesh(run, tokens, params, decode_state, tokens)
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
