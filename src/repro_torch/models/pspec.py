"""Logical activation-sharding constraints.

Model code annotates activations with *logical* axis names
(``constrain(x, "batch", "seq", "heads", None)``); the launch layer
installs a mapping from logical names to mesh axes before it runs a step
(train: batch->'dp', heads/ffn/vocab->'tp'; serve: batch->'data',
->'model'). The JAX package's ``repro.models.pspec`` pins GSPMD's choices
with these; here a DTensor activation is redistributed to the mapped
placements on its own mesh. With no rules installed, or on a plain
tensor, a call returns its input: one test, no work, so one device runs
unchanged.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

_RULES: dict | None = None


@contextmanager
def logical_rules(rules: dict):
    """rules: logical name -> mesh axis (str/tuple) or None."""
    global _RULES
    prev = _RULES
    _RULES = rules
    try:
        yield
    finally:
        _RULES = prev


TRAIN_RULES = {"batch": "dp", "heads": "tp", "ffn": "tp", "vocab": "tp",
               "embed": None, "seq": None, "kv": None, "experts": None}
SERVE_RULES = {"batch": "data", "heads": "model", "ffn": "model",
               "vocab": "model", "embed": None, "seq": None, "kv": None,
               "experts": None}
SERVE_RULES_MULTIPOD = {**SERVE_RULES, "batch": ("pod", "data")}


def constrain(x: torch.Tensor, *logical):
    """Redistribute a DTensor to the placements of the mapped spec, if
    rules are installed, and its gradient to the same placements. An axis
    that is not on the tensor's mesh, has size <= 1 or does not divide the
    dim is dropped, as the reference drops it."""
    if _RULES is None or type(x) is torch.Tensor:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.launch.sharding import NamedSharding, P
    mesh = x.device_mesh
    axis_sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    clean = []
    for dim, name in zip(x.shape, logical):
        ax = None if name is None else _RULES.get(name)
        if ax is None:
            clean.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        size = 1
        ok = True
        for a in axes:
            if a not in axis_sizes:
                ok = False
                break
            size *= axis_sizes[a]
        if not ok or size <= 1 or dim % size or dim < size:
            clean.append(None)
            continue
        clean.append(ax)
    placements = NamedSharding(mesh, P(*clean)).placements
    y = x if tuple(x.placements) == placements \
        else x.redistribute(mesh, placements)
    # through the local tensor and back: the gradient that flows back
    # here is redistributed to the same placements, as a sharding
    # constraint's transpose constrains the cotangent
    return DTensor.from_local(y.to_local(), mesh, placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def local_shards(fn, tensors, dims):
    """``fn`` of this rank's local shards, placed as ``tensors[0]`` is:
    for a function that works row by row along ``dims`` (attention along
    batch and heads) and returns a tensor of ``tensors[0]``'s shape, when
    every tensor is a DTensor sharded only along those dims, all alike.
    None otherwise — a plain tensor included — and the caller runs on the
    tensors themselves (:func:`map_shards` with one layout for all)."""
    x = tensors[0]
    if type(x) is torch.Tensor:
        return None
    from torch.distributed.tensor import DTensor
    if not all(isinstance(t, DTensor) for t in tensors) or any(
            tuple(t.placements) != tuple(x.placements) for t in tensors):
        return None
    layout = tuple(d if d in dims else None for d in range(x.dim()))
    return map_shards(fn, tensors, (layout,) * len(tensors), (layout,))


def map_shards(fn, tensors, layouts, out_layouts):
    """``fn`` of this rank's shards, for a function that works row by row
    along some dims of ``tensors[0]`` (the MoE's token groups, the wkv
    scan's batch rows and heads) while its other inputs and its outputs
    hold those dims elsewhere, or not at all. ``layouts[i]`` gives, for
    each dim of ``tensors[i]``, the dim of ``tensors[0]`` it indexes alike,
    or None; ``out_layouts`` does so for each output of ``fn``.

    When ``tensors[0]`` is a DTensor sharded only along dims that its
    layout names, every other input is placed to match (a dim it lacks is
    whole on each rank, and its gradient is summed over those ranks),
    ``fn`` runs on the local tensors, and each output comes back as a
    DTensor placed alike, its named dims of ``tensors[0]``'s global
    sizes. A None input passes through. Returns None otherwise — a plain
    tensor included — and the caller runs ``fn`` on the tensors
    themselves."""
    x = tensors[0]
    if type(x) is torch.Tensor:
        return None
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(x, DTensor):
        return None
    mesh, ref = x.device_mesh, tuple(x.placements)
    if any(not (isinstance(p, Replicate) or type(p) is Shard
                and layouts[0][p.dim] == p.dim) for p in ref):
        return None

    def placements(layout, grad=False):
        out = []
        for p in ref:
            if isinstance(p, Shard) and p.dim in layout:
                out.append(Shard(layout.index(p.dim)))
            else:
                out.append(Partial() if grad and isinstance(p, Shard)
                           else Replicate())
        return tuple(out)

    local = []
    for t, layout in zip(tensors, layouts):
        if t is None:
            local.append(None)
            continue
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        want = placements(layout)
        if tuple(t.placements) != want:
            t = t.redistribute(mesh, want)
        local.append(t.to_local(grad_placements=placements(layout, True)))
    outs = fn(*local)
    single = isinstance(outs, torch.Tensor)
    placed = []
    for out, layout in zip((outs,) if single else outs, out_layouts):
        shape = tuple(s if d is None else x.shape[d]
                      for s, d in zip(out.shape, layout))
        # contiguous, as the global strides declared for it
        placed.append(DTensor.from_local(
            out.contiguous(), mesh, placements(layout), run_check=False,
            shape=shape, stride=torch.empty(shape, device="meta").stride()))
    return placed[0] if single else tuple(placed)


def gather_dim(x: torch.Tensor, dim: int):
    """``x`` with ``dim`` whole on every rank: a DTensor's shards along
    ``dim`` gathered, its other placements kept (a stack of layers
    sharded along L, before it is split into layers); a plain tensor
    itself."""
    if type(x) is torch.Tensor:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    placements = [Replicate() if isinstance(p, Shard) and p.dim == dim
                  else p for p in x.placements]
    if placements == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def splittable(x: torch.Tensor, dim: int, parts: int):
    """``x`` ready for ``dim`` to be split into ``parts`` and a rest (heads
    out of a projection's width): a DTensor whose shards along ``dim`` do
    not divide ``parts`` is gathered along it first, as DTensor cannot
    split such a dim; a plain tensor itself."""
    if type(x) is torch.Tensor:
        return x
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.dim()
    shards = 1
    for size, p in zip(x.device_mesh.shape, x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            shards *= size
    return x if parts % shards == 0 else gather_dim(x, dim)


def write_slot(x: torch.Tensor, dim: int, slot: torch.Tensor,
               src: torch.Tensor) -> torch.Tensor:
    """``x.index_copy_(dim, slot, src)`` for one slot (a decode step's
    KV write), in place; returns ``x``. On a DTensor the rank that holds
    the slot's shard writes it into its local tensor and every other rank
    rewrites one of its own slots with its current value: the slot's
    bytes, as on one device, and no branch on the slot's value, which a
    meta tensor does not have. (DTensor's own in-place ``index_copy_``
    along a sharded dim records a wrong placement.)"""
    if type(x) is torch.Tensor:
        return x.index_copy_(dim, slot.reshape(1), src)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = x.device_mesh
    # src's slot dim is 1 long: whole on every rank, else placed as x
    placements = [Replicate() if isinstance(p, Shard) and p.dim == dim
                  else p for p in x.placements]
    src = src.redistribute(mesh, placements).to_local()
    if isinstance(slot, DTensor):
        slot = slot.full_tensor()
    local = x.to_local()
    shape, offset = compute_local_shape_and_global_offset(
        x.shape, mesh, x.placements)
    if shape[dim] == 0:
        return x
    at = slot.reshape(1) - offset[dim]
    mine = (at >= 0) & (at < shape[dim])
    at = at.clamp(0, shape[dim] - 1)
    keep = local.index_select(dim, at)
    local.index_copy_(dim, at, torch.where(mine, src, keep))
    return x
