"""Sharding rules: map every param/activation leaf to a PartitionSpec.

Federated training layout (fed mesh, axes ("fed","dp","tp") [+ "pod"]):
  * every param leaf carries a leading node dim F  -> fed axes
  * last weight dim                                 -> 'tp'   (tensor par.)
  * largest remaining divisible dim                 -> 'dp'   (FSDP/ZeRO-3)
  * batch (F, B, ...)                               -> (fed axes, 'dp')

Serving layout (production mesh, axes ("data","model") [+ "pod"]):
  * last weight dim -> 'model'; largest remaining -> 'data' (+'pod') FSDP
  * batch dim -> ('pod','data') when divisible, else replicated
  * KV caches: kv-head dim over 'model' when divisible, else seq dim.

The rules are the JAX package's (``repro.launch.sharding``), shape-based,
so they cover every architecture's tree without per-arch tables. A
:class:`NamedSharding` turns a spec into DTensor placements on a
``DeviceMesh``: each mesh dim named in entry i shards tensor dim i, every
other mesh dim replicates, and a tuple entry such as ``("pod", "fed")``
shards one dim over several mesh dims in mesh order (major to minor), as
the reference's does. :func:`with_sharding` gives meta DTensors, the
counterpart of a ``ShapeDtypeStruct`` with a sharding: shapes, dtypes and
placements, no storage.
"""
from __future__ import annotations

import math

import torch

from repro_torch.launch.mesh import axis_sizes


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of names, or
    None (not sharded). A one-name tuple is kept as the name, as JAX's
    ``PartitionSpec`` keeps it."""

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple)
                                     and len(p) == 1 else p
                                     for p in parts))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding:
    """A spec on a mesh; :attr:`placements` are its DTensor placements."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    def __repr__(self):
        return f"NamedSharding({self.spec!r})"

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        names = tuple(axis_sizes(self.mesh))
        out = [Replicate()] * len(names)
        for i, entry in enumerate(self.spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            dims = [names.index(a) for a in axes]
            if dims != sorted(dims):
                raise ValueError(f"spec entry {entry} must name mesh axes "
                                 f"in mesh order {names}")
            for d in dims:
                out[d] = Shard(i)
        return tuple(out)


def _assign(shape, axes_sizes, skip_dims=()):
    """Greedy: assign ('tp', size) to the last divisible dim, then 'dp' to
    the largest remaining divisible dim. Returns list of axis-or-None."""
    spec = [None] * len(shape)
    used = set(skip_dims)
    for name, size in axes_sizes:
        if size <= 1:
            continue
        cands = [i for i in range(len(shape)) if i not in used]
        # largest divisible dim first (vocab > d_ff > d_model); tie -> later
        order = sorted(cands, key=lambda i: (-shape[i], -i))
        for i in order:
            if shape[i] % size == 0 and shape[i] >= size:
                spec[i] = name
                used.add(i)
                break
    return spec


# leaves smaller than this are replicated: sharding a (d,) norm scale or
# bias drags the activations it multiplies into d-sharding, and every
# following matmul all-gathers the residual.
SMALL_PARAM = 1 << 16

# Megatron-style tensor parallelism by param name:
#   column-parallel (tp on d_out, the default): wq/wk/wv, w_gate/w_up, ...
#   row-parallel    (tp on d_in = dim -2):      wo, w_down, w_out
# Row-parallel consumes the head-/ffn-sharded activation locally and
# all-reduces the (b,s,d_model) output. Embedding tables (V, d) are
# vocab-parallel (also dim -2). KV projections are row-parallel too: with
# kv_heads < tp a column-parallel wk/wv splits single heads across devices;
# row-parallel replicates the (small) KV heads on all tp devices — the
# standard GQA tensor-parallel layout.
ROW_PARALLEL = {"wo", "w_down", "w_out", "table", "wk", "wv"}


def _inner_spec(shape, name, tp_name, tp, fsdp_name, fsdp_size):
    """Sharding for the weight dims (no leading fed/F dim here)."""
    spec = [None] * len(shape)
    tp_dim = None
    if name in ROW_PARALLEL and len(shape) >= 2 \
            and shape[-2] % tp == 0 and shape[-2] >= tp:
        tp_dim = len(shape) - 2
    elif shape[-1] % tp == 0 and shape[-1] >= tp:
        tp_dim = len(shape) - 1
    else:
        # fallback: largest divisible dim
        for i in sorted(range(len(shape)), key=lambda i: (-shape[i], -i)):
            if shape[i] % tp == 0 and shape[i] >= tp:
                tp_dim = i
                break
    if tp_dim is not None and tp > 1:
        spec[tp_dim] = tp_name
    if fsdp_size and fsdp_size > 1:
        for i in sorted(range(len(shape)), key=lambda i: (-shape[i], -i)):
            if i != tp_dim and shape[i] % fsdp_size == 0 \
                    and shape[i] >= fsdp_size:
                spec[i] = fsdp_name
                break
    return spec


def fed_param_spec(shape, mesh, fsdp: bool = True,
                   name: str | None = None) -> P:
    """Param leaf with leading F node dim on a fed mesh.

    fsdp=False: params replicated over dp within a node (small models —
    avoids per-matmul weight all-gathers when the replica easily fits)."""
    sizes = axis_sizes(mesh)
    fed = ("pod", "fed") if "pod" in sizes else "fed"
    if math.prod(shape[1:]) < SMALL_PARAM:
        return P(fed, *([None] * (len(shape) - 1)))
    inner = _inner_spec(shape[1:], name, "tp", sizes["tp"],
                        "dp", sizes["dp"] if fsdp else 0)
    return P(fed, *inner)


def serve_param_spec(shape, mesh, fsdp: bool = True,
                     name: str | None = None) -> P:
    """Param leaf (no F dim) on the production mesh."""
    sizes = axis_sizes(mesh)
    if math.prod(shape) < SMALL_PARAM:
        return P(*([None] * len(shape)))
    inner = _inner_spec(shape, name, "model", sizes["model"],
                        "data", sizes["data"] if fsdp else 0)
    return P(*inner)


def _leaf_name(path) -> str | None:
    """The last string key of a tree path (a dict key or a NamedTuple
    field; list positions are ints)."""
    for key in reversed(path):
        if isinstance(key, str):
            return key
    return None


def tree_map_with_path(fn, tree, *rest, path: tuple = ()):
    """``fn(path, leaf, *rest_leaves)`` over a tree of dicts, lists, tuples
    and NamedTuples, keeping their types; ``rest`` are trees of the same
    structure. A path holds dict keys and NamedTuple fields as str, list
    and tuple positions as int."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(
            tree_map_with_path(fn, v, *(getattr(r, f) for r in rest),
                               path=path + (f,))
            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, *(r[i] for r in rest),
                                             path=path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def _tree_specs(tree, spec_fn, mesh, **kw):
    def leaf_spec(path, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return P()
        return spec_fn(shape, mesh, name=_leaf_name(path), **kw)
    return tree_map_with_path(leaf_spec, tree)


def fed_state_shardings(state_shapes, mesh, fsdp: bool = True):
    """NamedShardings for a MeshFedState-like tree of meta tensors."""
    specs = _tree_specs(state_shapes, fed_param_spec, mesh, fsdp=fsdp)
    return _named(specs, mesh)


def serve_state_shardings(tree_shapes, mesh, fsdp: bool = True):
    specs = _tree_specs(tree_shapes, serve_param_spec, mesh, fsdp=fsdp)
    return _named(specs, mesh)


def _named(specs, mesh):
    """Every spec of a tree (a PartitionSpec is itself a tuple, so it is
    taken as a leaf here) as a NamedSharding."""
    if isinstance(specs, PartitionSpec):
        return NamedSharding(mesh, specs)
    if isinstance(specs, dict):
        return {k: _named(v, mesh) for k, v in specs.items()}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(_named(v, mesh) for v in specs))
    return type(specs)(_named(v, mesh) for v in specs)


def fed_batch_spec(shape, mesh) -> P:
    """Batch leaf (F, B, ...) on a fed mesh."""
    sizes = axis_sizes(mesh)
    fed = ("pod", "fed") if "pod" in sizes else "fed"
    spec = [fed] + [None] * (len(shape) - 1)
    if len(shape) > 1 and shape[1] % sizes["dp"] == 0 \
            and shape[1] >= sizes["dp"]:
        spec[1] = "dp"
    return P(*spec)


def serve_batch_spec(shape, mesh) -> P:
    """Batch leaf (B, ...) on the production mesh."""
    sizes = axis_sizes(mesh)
    axes = [a for a in ("pod", "data") if a in sizes]
    total = math.prod(sizes[a] for a in axes)
    if shape and shape[0] % total == 0 and shape[0] >= total:
        return P(tuple(axes), *([None] * (len(shape) - 1)))
    # try data axis only
    if shape and "data" in sizes and shape[0] % sizes["data"] == 0 \
            and shape[0] >= sizes["data"]:
        return P("data", *([None] * (len(shape) - 1)))
    return P(*([None] * len(shape)))


def cache_spec(shape, mesh) -> P:
    """KV cache leaf (L, B, S, KV, D) or SSM state (L, B, H, D, N)."""
    sizes = axis_sizes(mesh)
    model = sizes["model"]
    spec = [None] * len(shape)
    # batch dim (index 1) over data when divisible
    if len(shape) > 1 and shape[1] % sizes["data"] == 0 \
            and shape[1] >= sizes["data"]:
        spec[1] = "data"
    # a head-ish dim over model: prefer dim -2 (kv heads / ssm heads)
    for i in (len(shape) - 2, len(shape) - 3, len(shape) - 1):
        if 1 < i < len(shape) and spec[i] is None \
                and shape[i] % model == 0 and shape[i] >= model:
            spec[i] = "model"
            break
    return P(*spec)


def abstract_dtensor(leaf: torch.Tensor, sharding: NamedSharding):
    """A meta DTensor of ``leaf``'s global shape and dtype placed by
    ``sharding``: its local tensor is this rank's shard, on the meta
    device. No collective is issued."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape = tuple(leaf.shape)
    placements = sharding.placements
    local, _ = compute_local_shape_and_global_offset(
        shape, sharding.mesh, placements)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(
        torch.empty(tuple(local), dtype=leaf.dtype, device="meta"),
        sharding.mesh, placements, run_check=False, shape=shape,
        stride=stride)


def place(tree, shardings):
    """Every leaf of ``tree`` as a meta DTensor by the NamedSharding at the
    same place in ``shardings``."""
    return tree_map_with_path(lambda _, leaf, sh: abstract_dtensor(leaf, sh),
                              tree, shardings)


def with_sharding(tree, mesh, spec_fn):
    """Meta DTensors of a tree of meta tensors, each leaf placed by
    ``spec_fn(shape, mesh)``."""
    def attach(_, leaf):
        spec = spec_fn(tuple(leaf.shape), mesh) if leaf.dim() else P()
        return abstract_dtensor(leaf, NamedSharding(mesh, spec))
    return tree_map_with_path(attach, tree)
