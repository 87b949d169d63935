"""Checkpointing of a tree of tensors: npz arrays + a JSON manifest of the
tree's structure (the twin of the JAX package's ``repro.checkpointing``).

A tree is made of NamedTuples (fields in order), tuples and lists (in
order), dicts (sorted keys), tensors and Python numbers, the leaves that
are stored. A :class:`repro_torch.core.flatten.FlatLayout` is static: it is
recorded in the manifest, not stored as an array, and ``restore`` refuses
a target whose layouts differ. Per-node federated states (leading K dim)
round-trip unchanged; ``restore`` validates the leaf count and every shape
against the target and casts back to its dtypes and devices.
"""
from __future__ import annotations

import json
import os
import numpy as np
import torch

from repro_torch.core.flatten import FlatLayout


def _node(tree) -> tuple[str, list] | None:
    """(structure name, [(key, child)]) of an inner node, None for a
    leaf."""
    if isinstance(tree, FlatLayout):
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree).__name__, list(zip(tree._fields, tree))
    if isinstance(tree, (tuple, list)):
        return type(tree).__name__, list(enumerate(tree))
    if isinstance(tree, dict):
        return "dict", [(key, tree[key]) for key in sorted(tree)]
    return None


def _walk(tree, prefix: str, leaves: list, static: list) -> str:
    """Appends ``(path, leaf)`` of every array leaf to ``leaves`` and of
    every FlatLayout to ``static``; returns the structure's description."""
    node = _node(tree)
    if node is None:
        if isinstance(tree, FlatLayout):
            static.append((prefix, tree))
            return "<layout>"
        leaves.append((prefix, tree))
        return "*"
    name, children = node
    parts = []
    for key, child in children:
        sub = f"{prefix}/{key}" if prefix else str(key)
        parts.append(f"{key}={_walk(child, sub, leaves, static)}")
    return f"{name}({', '.join(parts)})"


def _flatten_with_paths(tree) -> tuple[list, list, str]:
    """``(path, leaf)`` of every array leaf and ``(path, layout)`` of every
    FlatLayout, key paths joined by "/", and the structure's
    description."""
    leaves: list = []
    static: list = []
    treedef = _walk(tree, "", leaves, static)
    return leaves, static, treedef


def _layout_record(layout: FlatLayout) -> dict:
    """A FlatLayout as JSON data (dtypes by name, paths as lists)."""
    return {"names": list(layout.names),
            "paths": [list(p) for p in layout.paths],
            "shapes": [list(s) for s in layout.shapes],
            "dtypes": [str(d) for d in layout.dtypes],
            "offsets": list(layout.offsets), "sizes": list(layout.sizes),
            "total": layout.total, "padded": layout.padded,
            "num_nodes": layout.num_nodes}


def _to_numpy(leaf) -> np.ndarray:
    """numpy has no bfloat16 — store as f32, restore() casts back via the
    target structure's dtype."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.to(torch.float32)
        return leaf.numpy()
    return np.asarray(leaf)


def _replace_into(tmp: str, dst: str) -> None:
    os.replace(tmp, dst)        # atomic on POSIX: readers see old XOR new


def save(path: str, tree, step: int | None = None) -> None:
    """Atomic checkpoint write: every file lands via temp + ``os.replace``,
    arrays first and the manifest last, so the manifest acts as the commit
    record — a crash mid-save leaves either the previous complete
    checkpoint or stray ``.tmp`` files, never a torn one."""
    os.makedirs(path, exist_ok=True)
    leaves, static, treedef = _flatten_with_paths(tree)
    np_leaves = [(k, _to_numpy(leaf)) for k, leaf in leaves]
    arrays = {f"a{i}": arr for i, (_, arr) in enumerate(np_leaves)}
    arrays_dst = os.path.join(path, "arrays.npz")
    tmp = arrays_dst + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    _replace_into(tmp, arrays_dst)
    manifest = {
        "step": step,
        "treedef": treedef,
        "keys": [k for k, _ in np_leaves],
        "shapes": [list(arr.shape) for _, arr in np_leaves],
        "dtypes": [str(getattr(leaf, "dtype", type(leaf).__name__))
                   for _, leaf in leaves],
        "layouts": {k: _layout_record(layout) for k, layout in static},
    }
    manifest_dst = os.path.join(path, "manifest.json")
    tmp = manifest_dst + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    _replace_into(tmp, manifest_dst)


def _rebuild(like, new_leaves: list):
    """``like``'s structure with its array leaves taken, in order, from
    ``new_leaves``; its static layouts kept."""
    node = _node(like)
    if node is None:
        return like if isinstance(like, FlatLayout) else new_leaves.pop(0)
    children = [_rebuild(child, new_leaves) for _, child in node[1]]
    if isinstance(like, dict):
        return dict(zip((key for key, _ in node[1]), children))
    if hasattr(like, "_fields"):
        return type(like)(*children)
    return type(like)(children)


def restore(path: str, like):
    """Restore into the structure of ``like`` (validates the leaf count,
    every leaf shape and the static layouts), each leaf cast to the dtype
    and device of ``like``'s."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_like, static, treedef = _flatten_with_paths(like)
    n = len(manifest["keys"])
    if len(leaves_like) != n:
        raise ValueError(
            f"checkpoint layout mismatch: checkpoint has {n} leaves, "
            f"target structure has {len(leaves_like)} "
            f"(checkpoint treedef: {manifest['treedef']}; target treedef: "
            f"{treedef}). The session's configs (algorithm, transport, "
            f"faults, model) must match the ones the checkpoint was "
            f"saved under.")
    new_leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, (_, ref) in enumerate(leaves_like):
            arr = data[f"a{i}"]
            shape = tuple(np.shape(ref))
            if tuple(arr.shape) != shape:
                raise ValueError(
                    f"leaf {manifest['keys'][i]}: checkpoint shape "
                    f"{arr.shape} != target {shape}")
            if isinstance(ref, torch.Tensor):
                new_leaves.append(torch.tensor(arr).to(device=ref.device,
                                                       dtype=ref.dtype))
            else:
                new_leaves.append(type(ref)(arr.item()))
    saved = manifest.get("layouts", {})
    for key, layout in static:
        if saved.get(key) != _layout_record(layout):
            raise ValueError(
                f"checkpoint layout mismatch: the flat buffer layout at "
                f"{key!r} differs (checkpoint: {saved.get(key)}; target: "
                f"{_layout_record(layout)}). The model's parameter tree "
                f"must match the one the checkpoint was saved under.")
    return _rebuild(like, new_leaves)


def latest_step(path: str) -> int | None:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            return json.load(f).get("step")
    except FileNotFoundError:
        return None
