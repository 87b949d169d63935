"""Carry weights and trainer state across from the JAX package.

The JAX package keeps node-stacked params as a dict pytree and its Adam
moments as lane-padded ``(K, P)`` buffers in the same column order as the
port (leaves by sorted key). These functions take those values as numpy
arrays (anything ``numpy.asarray`` accepts, bfloat16 included), so both
packages can compute from the same numbers. Nothing here imports the JAX
package: a state is read by its field names.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import flatten
from repro_torch.core.cdfl import FedState
from repro_torch.core.topology import SparseEta
from repro_torch.device import resolve_device
from repro_torch.hierarchy.mixing import HierEta
from repro_torch.ingest.sketches import SketchState
from repro_torch.launch.steps import MeshFedState
from repro_torch.models import attention, mamba, rwkv, transformer
from repro_torch.optim.adam import AdamState, FlatAdamState


def tensor_from_numpy(value, device) -> torch.Tensor:
    """One array -> a tensor of the same dtype on ``device``; numpy's
    ``bfloat16`` extension type (what a JAX bf16 array converts to) comes
    across bit for bit."""
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.tensor(arr, device=device)


def transformer_params_from_numpy(tree: dict, device=None) -> dict:
    """The JAX package's transformer params (a nested dict: layers stacked
    along a leading L axis under ``"layers"``, or a list of per-layer dicts
    under ``"layers_list"`` beside a ``"shared_attn"`` set) -> the same
    nested dicts and lists of tensors, key path for key path, each leaf in
    its own dtype."""
    dev = resolve_device(device)
    if not isinstance(tree, dict) or not tree:
        raise ValueError("params must be a non-empty nested dict of arrays")
    return _tree_from_numpy(tree, dev)


def _tree_from_numpy(tree, dev):
    if isinstance(tree, dict):
        return {name: _tree_from_numpy(sub, dev) for name, sub in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_from_numpy(sub, dev) for sub in tree]
    return tensor_from_numpy(tree, dev)


def _mix_state_from_numpy(st, dev):
    """One mix state (read by field name; any leading L axis): a KV cache
    (``k/v/length``), an rwkv state (``s/x_prev``) or a mamba state
    (``h/conv``)."""
    if hasattr(st, "x_prev"):
        return rwkv.RwkvState(s=tensor_from_numpy(st.s, dev),
                              x_prev=tensor_from_numpy(st.x_prev, dev))
    if hasattr(st, "conv"):
        return mamba.MambaState(h=tensor_from_numpy(st.h, dev),
                                conv=tensor_from_numpy(st.conv, dev))
    return attention.KVCache(
        k=tensor_from_numpy(st.k, dev), v=tensor_from_numpy(st.v, dev),
        length=torch.tensor(np.asarray(st.length), dtype=torch.int32,
                            device=dev))


def decode_state_from_numpy(state, device=None) -> transformer.DecodeState:
    """A JAX package ``DecodeState`` (read by field name: ``states``,
    stacked along L for a homogeneous stack — ``k/v/length`` of a dense
    stack, ``s/x_prev`` of an rwkv stack, ``h/conv`` of a mamba stack — or
    a list of per-layer states for a heterogeneous one; ``pos``) -> the
    port's, each array in its own dtype."""
    dev = resolve_device(device)
    st = state.states
    if isinstance(st, (list, tuple)) and not hasattr(st, "_fields"):
        states = [_mix_state_from_numpy(one, dev) for one in st]
    else:
        states = _mix_state_from_numpy(st, dev)
    return transformer.DecodeState(
        states=states, pos=torch.tensor(np.asarray(state.pos),
                                        dtype=torch.int32, device=dev))


def params_from_numpy(tree, device=None):
    """Node-stacked params (a tree of dicts and lists of ``(K, ...)``
    arrays, e.g. ``{"w1": ..., "b1": ...}`` or the VGG's ``{"stages":
    [{"conv1", "conv2"}, ...], "fc_w", "fc_b"}``) -> ``(buf, layout)``, the
    port's ``(K, P)`` f32 buffer in the JAX package's column order."""
    dev = resolve_device(device)
    if not isinstance(tree, (dict, list, tuple)) or not tree:
        raise ValueError("params must be a non-empty tree of arrays")
    return flatten.flatten(flatten.tree_map(
        lambda value: torch.tensor(np.asarray(value), device=dev), tree))


def state_from_numpy(state, device=None) -> FedState:
    """A JAX package ``FedState`` (read by field name: ``params``,
    ``opt.step/m/v``, ``ratios``, ``sizes``, ``round``, ``tstate``,
    ``fstate``, ``istate``) -> the port's
    :class:`repro_torch.core.cdfl.FedState`. ``tstate``, the stale gossip
    snapshots, comes across as an (s, K, P) tensor at the wire dtype;
    ``fstate``, the straggle replay buffer of a faulted run, as a (K, P)
    f32 buffer; ``istate``, the ingest sketches, as a
    :class:`repro_torch.ingest.sketches.SketchState` (each ``()`` when the
    run keeps none)."""
    dev = resolve_device(device)
    buf, layout = params_from_numpy(dict(state.params), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    opt = FlatAdamState(
        step=torch.tensor(np.asarray(state.opt.step), dtype=torch.int32,
                          device=dev),
        m=torch.tensor(np.asarray(state.opt.m), **f32),
        v=torch.tensor(np.asarray(state.opt.v), **f32))
    if opt.m.shape != buf.shape or opt.v.shape != buf.shape:
        raise ValueError(f"moments {tuple(opt.m.shape)} do not match the "
                         f"params buffer {tuple(buf.shape)}")
    tstate = getattr(state, "tstate", ())
    if not isinstance(tstate, tuple):
        tstate = tensor_from_numpy(tstate, dev)
        if tstate.dim() != 3 or tstate.shape[1] != buf.shape[0]:
            raise ValueError(f"gossip snapshots {tuple(tstate.shape)} are "
                             f"not (s, K={buf.shape[0]}, columns)")
    istate = getattr(state, "istate", ())
    if len(istate):
        istate = SketchState(
            cm=torch.tensor(np.asarray(istate.cm), **f32),
            hll=torch.tensor(np.asarray(istate.hll), dtype=torch.int32,
                             device=dev),
            seen=torch.tensor(np.asarray(istate.seen), **f32))
    fstate = getattr(state, "fstate", ())
    if not isinstance(fstate, tuple):
        fstate = torch.tensor(np.asarray(fstate), **f32)
        if fstate.shape != buf.shape:
            raise ValueError(f"straggle buffer {tuple(fstate.shape)} does "
                             f"not match the params buffer "
                             f"{tuple(buf.shape)}")
    ratios = torch.tensor(np.asarray(state.ratios), **f32)
    sizes = torch.tensor(np.asarray(state.sizes), **f32)
    return FedState(buf, layout, opt, ratios, sizes, int(state.round), tstate,
                    fstate, istate)


def mesh_state_from_numpy(state, device=None) -> MeshFedState:
    """A JAX package ``MeshFedState`` (read by field name: ``params``, a
    transformer params tree with a leading F axis on every leaf;
    ``opt.step`` (F,) and the f32 moment trees ``opt.m``/``opt.v``;
    ``ratios`` (F,)) -> the port's
    :class:`repro_torch.launch.steps.MeshFedState`, each array in its own
    dtype."""
    dev = resolve_device(device)
    params = transformer_params_from_numpy(state.params, dev)
    step = torch.tensor(np.asarray(state.opt.step), dtype=torch.int32,
                        device=dev)
    opt = AdamState(step=step,
                    m=transformer_params_from_numpy(state.opt.m, dev),
                    v=transformer_params_from_numpy(state.opt.v, dev))
    ratios = torch.tensor(np.asarray(state.ratios), dtype=torch.float32,
                          device=dev)
    f = tuple(step.shape)
    for name, tree in (("params", params), ("m", opt.m), ("v", opt.v)):
        lead = {leaf.shape[:1] for _, leaf in flatten.leaves_with_paths(tree)}
        if len(f) != 1 or lead != {f} or tuple(ratios.shape) != f:
            raise ValueError(f"{name} leaves lead with {sorted(lead)}, the "
                             f"ratios are {tuple(ratios.shape)} and the Adam "
                             f"step {f}: expected one F for all")
    return MeshFedState(params=params, opt=opt, ratios=ratios)


def sparse_eta_from_numpy(sp, device=None) -> SparseEta:
    """A JAX package ``SparseEta`` (read by field name ``idx``/``val``,
    any leading stack axes) -> the port's: int32 indices, f32 weights.
    ``run_rounds`` checks the indices when it takes the stack."""
    dev = resolve_device(device)
    return SparseEta(torch.tensor(np.asarray(sp.idx).astype(np.int32),
                                  device=dev),
                     torch.tensor(np.asarray(sp.val, np.float32),
                                  device=dev))


def hier_eta_from_numpy(h, device=None) -> HierEta:
    """A JAX package ``HierEta`` (read by field name) -> the port's: int64
    cluster ids, both tiers through :func:`sparse_eta_from_numpy`, and the
    re-merge flags kept on the host."""
    dev = resolve_device(device)
    return HierEta(
        cluster=torch.tensor(np.asarray(h.cluster).astype(np.int64),
                             device=dev),
        intra=sparse_eta_from_numpy(h.intra, dev),
        gamma_node=torch.tensor(np.asarray(h.gamma_node, np.float32),
                                device=dev),
        inter=sparse_eta_from_numpy(h.inter, dev),
        burst=torch.tensor(np.asarray(h.burst, np.float32)))
