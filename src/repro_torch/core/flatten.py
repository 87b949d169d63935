"""Flat parameter buffer for the consensus exchange (paper eq. 5).

A node-stacked parameter tree (nested dicts and lists, every leaf
``(K, ...)``) is packed into ONE contiguous ``(K, P)`` float32 buffer, with
P padded once to a multiple of LANE = 128, so the whole exchange is one
``(K, K) @ (K, P)`` operation. Leaves are ordered as ``jax.tree.flatten``
orders them in the JAX package (dict keys sorted, lists in order, depth
first), so the two packages' buffers agree column by column.
:func:`unflatten` rebuilds the same tree from VIEWS of the buffer: the
trainer's forward and backward read the params in place, and the gradient
of the buffer is the flat gradient, with zeros in the padding.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops

LANE = 128                      # pad P once to a multiple of this


class FlatLayout(NamedTuple):
    """Static pack/unpack metadata for one node-stacked parameter tree."""

    names: tuple                # per-leaf key path joined by "/", in order
    paths: tuple                # per-leaf key path: str keys, int positions
    shapes: tuple               # per-leaf trailing shape (K stripped)
    dtypes: tuple               # per-leaf dtype (restored on unpack)
    offsets: tuple              # per-leaf start offset into the buffer
    sizes: tuple                # per-leaf element count (trailing dims)
    total: int                  # unpadded per-node element count
    padded: int                 # total rounded up to a LANE multiple
    num_nodes: int              # K


def leaves_with_paths(tree, prefix: tuple = ()) -> list:
    """``(path, leaf)`` pairs of a tree of dicts (str keys, visited sorted)
    and lists or tuples (visited in order), depth first: the order
    ``jax.tree.flatten`` gives the same tree."""
    if isinstance(tree, dict):
        if not all(isinstance(key, str) for key in tree):
            raise ValueError(f"parameter dict keys must be str, got "
                             f"{list(tree)}")
        return [pair for key in sorted(tree)
                for pair in leaves_with_paths(tree[key], prefix + (key,))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, sub in enumerate(tree)
                for pair in leaves_with_paths(sub, prefix + (i,))]
    return [(prefix, tree)]


def tree_map(fn, tree):
    """``fn`` applied to every leaf, the dicts and lists kept (tuples come
    back as lists)."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, sub) for key, sub in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, sub) for sub in tree]
    return fn(tree)


def build_tree(paths, leaves):
    """The tree whose leaves at ``paths`` are ``leaves``: a str key makes a
    dict level, an int position a list level."""
    root: dict = {}
    for path, leaf in zip(paths, leaves):
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        out = {key: lists(sub) for key, sub in node.items()}
        if all(isinstance(key, int) for key in out):
            return [out[i] for i in range(len(out))]
        return out

    return lists(root)


def make_layout(params) -> FlatLayout:
    """Layout of a node-stacked tree of tensors, every leaf ``(K, ...)``."""
    pairs = leaves_with_paths(params)
    if not pairs or not pairs[0][0]:
        raise ValueError("parameters must be a non-empty tree of dicts and "
                         "lists of tensors")
    k = pairs[0][1].shape[0]
    shapes, dtypes, offsets, sizes = [], [], [], []
    off = 0
    for path, leaf in pairs:
        name = "/".join(str(key) for key in path)
        if leaf.dim() < 1 or leaf.shape[0] != k:
            raise ValueError(
                f"leaf {name!r} {tuple(leaf.shape)} lacks the leading node "
                f"dim K={k}")
        size = 1
        for d in leaf.shape[1:]:
            size *= int(d)
        shapes.append(tuple(int(d) for d in leaf.shape[1:]))
        dtypes.append(leaf.dtype)
        offsets.append(off)
        sizes.append(size)
        off += size
    padded = -(-off // LANE) * LANE
    return FlatLayout(
        names=tuple("/".join(str(key) for key in path) for path, _ in pairs),
        paths=tuple(path for path, _ in pairs), shapes=tuple(shapes),
        dtypes=tuple(dtypes), offsets=tuple(offsets), sizes=tuple(sizes),
        total=off, padded=padded, num_nodes=k)


def flatten(params, layout: FlatLayout | None = None):
    """Pack a node-stacked tree into a ``(K, P)`` float32 buffer on the
    leaves' device. Returns ``(buf, layout)``; the tail padding is zero."""
    if layout is None:
        layout = make_layout(params)
    k = layout.num_nodes
    pieces = [leaf.reshape(k, -1).to(torch.float32)
              for _, leaf in leaves_with_paths(params)]
    pad = layout.padded - layout.total
    if pad:
        pieces.append(pieces[0].new_zeros((k, pad)))
    return torch.cat(pieces, dim=1).contiguous(), layout


def unflatten(buf: torch.Tensor, layout: FlatLayout):
    """The layout's tree of leaf views of the ``(K, P)`` buffer (no copy
    for f32 leaves; other dtypes are cast back, which copies). Any leading
    axes pass through: a ``(V, K, P)`` buffer gives ``(V, K, ...)`` leaves
    and a ``(V·K, P)`` one ``(V·K, ...)`` leaves."""
    lead = tuple(buf.shape[:-1])
    leaves = []
    for shape, dtype, off, size in zip(layout.shapes, layout.dtypes,
                                       layout.offsets, layout.sizes):
        leaf = buf[..., off:off + size].view(lead + shape)
        leaves.append(leaf if dtype == buf.dtype else leaf.to(dtype))
    return build_tree(layout.paths, leaves)


def make_layout_one(params) -> FlatLayout:
    """Layout of a SINGLE node's tree (no leading K dim): the shapes are
    the full leaf shapes and ``num_nodes`` is 1. Pack with
    :func:`flatten_one`, unpack with :func:`unflatten_one`. This is the
    mesh-mode layout: each fed rank holds one node's params, and the ring
    exchange moves its single ``(P,)`` vector — one collective, not one
    per leaf."""
    return make_layout(tree_map(lambda leaf: leaf[None], params))


def flatten_one(params, layout: FlatLayout | None = None):
    """Pack a single-node tree into a lane-padded ``(P,)`` f32 vector (tail
    padding zero). Returns ``(vec, layout)``; inverse:
    :func:`unflatten_one`."""
    buf, layout = flatten(tree_map(lambda leaf: leaf[None], params), layout)
    return buf[0], layout


def unflatten_one(vec: torch.Tensor, layout: FlatLayout, cast: bool = True):
    """Single-node unpack: ``(P,)`` -> the layout's tree with the trailing
    shapes (no K dim), each leaf restored to its recorded dtype
    (``cast=False`` keeps the vector's dtype). f32 leaves of an f32
    vector are views."""
    leaves = []
    for shape, dtype, off, size in zip(layout.shapes, layout.dtypes,
                                       layout.offsets, layout.sizes):
        leaf = vec[off:off + size].view(shape)
        leaves.append(leaf.to(dtype) if cast and dtype != vec.dtype
                      else leaf)
    return build_tree(layout.paths, leaves)


def column_shards(padded: int, shards: int) -> int:
    """Largest shard count <= ``shards`` that splits a ``padded``-wide
    buffer into equal LANE-aligned column chunks. The ring transport
    sends chunk j+1 while mixing chunk j; unshardable widths fall back to
    1 (one transfer, no overlap)."""
    shards = max(int(shards), 1)
    while shards > 1 and (padded % shards or (padded // shards) % LANE):
        shards -= 1
    return shards


def prefix_length(layout: FlatLayout, fraction: float) -> int:
    """Flat-buffer prefix covering the first ``fraction`` of leaves:
    C-DFA(M) mixes only the first ``max(1, round(f * n_leaves))`` leaves
    (paper Sec. 5.3), a contiguous column prefix here."""
    n_leaves = len(layout.sizes)
    n_mix = max(1, int(round(fraction * n_leaves)))
    if n_mix >= n_leaves:
        return layout.total
    return layout.offsets[n_mix]


def apply_matrix_flat(buf: torch.Tensor,
                      matrix: torch.Tensor) -> torch.Tensor:
    """``A @ BUF``: any (K, K) linear consensus operator applied to every
    parameter of every node in one call (kernel B2 on the card). A
    ``(V, K, P)`` buffer of V variants takes one (K, K) operator or V of
    them, in the same one call."""
    return ops.flat_consensus(matrix.to(buf.dtype).contiguous(), buf)


def mix_flat(buf: torch.Tensor, eta: torch.Tensor, gamma,
             self_weight: float = 1.0,
             wire: torch.Tensor | None = None) -> torch.Tensor:
    """Paper eq. (5) on the flat buffer, one fused call (kernel B1 on the
    card):

        phi_k = sw * W_k + gamma * sum_i eta_ki (W_i - W_k)

    The delta form (neighbor product minus the row-sum rescale) keeps the
    cancellation error at the f32 noise floor. ``wire`` is the buffer as
    it traveled the network (default ``buf``), e.g. its bf16 cast: only
    the difference terms see the wire precision, ``buf`` stays the f32
    master. A ``(V, K, P)`` buffer of V variants mixes in the same one
    call, with eta (K, K) or (V, K, K) and gamma (V,)."""
    w = buf if wire is None else wire
    out = ops.flat_mix(eta.to(buf.dtype).contiguous(), buf, w, gamma)
    if self_weight == 1.0:
        return out
    return out + (self_weight - 1.0) * buf


def sparse_mix_flat(buf: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                    gamma, wire: torch.Tensor | None = None) -> torch.Tensor:
    """Paper eq. (5) with top-D sparse weights, one fused call (kernel B5
    on the card):

        phi_k = W_k + gamma * (sum_d val_kd W_{idx_kd} - rowsum_k W_k)

    O(K·D·P) instead of the dense O(K²P). Same delta form and ``wire``
    convention as :func:`mix_flat`; all-zero rows are pure
    self-updates."""
    w = buf if wire is None else wire
    return ops.sparse_mix(idx, val.to(buf.dtype), buf, w, gamma)


def cluster_mix_flat(buf: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                     gamma_node: torch.Tensor,
                     wire: torch.Tensor | None = None,
                     wire_self: torch.Tensor | None = None, *,
                     plan=None) -> torch.Tensor:
    """Eq. (5) with a PER-NODE step size, the intra-cluster tier of
    hierarchical mixing (kernel B6 on the card):

        phi_k = W_k + g_k * (sum_d val_kd W_{idx_kd} - rowsum_k WS_k)

    The neighbor term reads ``wire`` (default ``buf``), the self rescale
    ``wire_self`` (default ``wire``); ``buf`` stays the f32 master.
    ``plan``: the table's receiver groups (port-only, see
    :func:`repro_torch.kernels.ops.cluster_mix`)."""
    w = buf if wire is None else wire
    ws = w if wire_self is None else wire_self
    return ops.cluster_mix(idx, val.to(buf.dtype), buf, ws, w,
                           gamma_node.to(buf.dtype), plan=plan)


def sparse_mix_variants(buf: torch.Tensor, idx: torch.Tensor,
                        val: torch.Tensor, gamma,
                        wire: torch.Tensor | None = None,
                        wire_self: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Eq. (5) with top-D sparse weights for V variants at once: ``buf``
    ``(V, K, P)``, tables ``(K, D)`` shared or ``(V, K, D)``, gamma
    ``(V,)``. The variants run as one ``(V·K, P)`` buffer through
    :func:`cluster_mix_flat` (kernel B6, no plan): variant v's indices are
    offset by ``v·K`` and its gamma repeated over its K rows. ``wire`` and
    ``wire_self`` as in :func:`cluster_mix_flat`, ``(V, K, P)``."""
    v, k, p = buf.shape
    d = idx.shape[-1]
    offset = torch.arange(v, dtype=torch.int32, device=idx.device) * k
    rows = (idx.to(torch.int32) + offset[:, None, None]).reshape(v * k, d)
    g = torch.as_tensor(gamma, dtype=buf.dtype, device=buf.device)
    g = g.reshape(v).repeat_interleave(k)
    w = buf if wire is None else wire
    ws = w if wire_self is None else wire_self
    out = cluster_mix_flat(buf.reshape(v * k, p), rows.contiguous(),
                           val.expand(v, k, d).reshape(v * k, d).contiguous(),
                           g, wire=w.reshape(v * k, p).contiguous(),
                           wire_self=ws.reshape(v * k, p).contiguous())
    return out.view(v, k, p)


def partial_mix_flat(buf: torch.Tensor, eta, gamma,
                     prefix: int) -> torch.Tensor:
    """Eq. (5) on the first ``prefix`` buffer columns only (C-DFA(M):
    federated optimization on Q <= N layers); the other columns pass
    through. ``eta`` is dense (K, K) (kernel B1) or a
    ``topology.SparseEta`` (kernel B5, duck-typed on ``.idx``). The column
    prefix of a (K, P) buffer is a strided view, so it is copied once
    (K x prefix) for the kernel, which takes contiguous rows of any
    width."""
    head = buf[:, :prefix].contiguous()
    if hasattr(eta, "idx"):
        head = sparse_mix_flat(head, eta.idx, eta.val, gamma)
    else:
        head = mix_flat(head, eta, gamma)
    return torch.cat([head, buf[:, prefix:]], dim=1)


def disagreement_flat(buf: torch.Tensor, total: int) -> torch.Tensor:
    """Mean squared node deviation from the node mean. ``total`` is the
    unpadded per-node element count (the zero padding adds nothing). A
    ``(V, K, P)`` buffer gives the (V,) values of its variants."""
    mu = buf.mean(dim=-2, keepdim=True)
    ss = torch.sum((buf - mu) ** 2, dim=(-2, -1))
    return ss / (buf.shape[-2] * total)
