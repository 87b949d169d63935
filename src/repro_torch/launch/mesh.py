"""Production meshes and the federated re-view, on
``torch.distributed.device_mesh.DeviceMesh``.

make_production_mesh: the (16,16)/("data","model") single-pod mesh (256
ranks) and the (2,16,16)/("pod","data","model") two-pod mesh (512), over
the default process group's ranks.

make_fed_mesh: the SAME ranks re-viewed as ("fed","dp","tp") — one
federated node (paper: base station) per fed index, internally data-
parallel (dp) and tensor-parallel (tp). Two pods: ("pod","fed","dp","tp"),
with the consensus ring spanning the (pod, fed) product so neighbor
exchange crosses pods exactly twice per round (the ring wrap).

The rules of :mod:`repro_torch.launch.sharding` read a mesh only through
:func:`axis_sizes`, so they take a DeviceMesh or any object with
``axis_names`` and a ``shape`` mapping (the reference tests' stand-in).

Functions, not module constants: importing this module starts no process
group.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve_device


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` in the mesh's axis order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {name: mesh.shape[name] for name in mesh.axis_names}


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} ranks, have {have} — build it without devices in a "
            f"fake process group of {n} ranks (see launch/dryrun.py)")
    ranks = torch.arange(n).reshape(shape)
    return DeviceMesh(resolve_device(device).type, ranks,
                      mesh_dim_names=axes)


def make_fed_mesh(mesh: DeviceMesh, fed: int) -> DeviceMesh:
    """Re-view a production mesh's ranks as a federated mesh.

    Single-pod (16,16):  ("fed","dp","tp") = (fed, 16//fed, 16)
    Multi-pod (2,16,16): ("pod","fed","dp","tp") = (2, fed//2, 32//fed, 16)
    — fed nodes are split across pods; the ring spans ('pod','fed').
    """
    ranks = mesh.mesh
    if ranks.ndim == 2:                    # single pod
        data, model = ranks.shape
        if data % fed:
            raise ValueError(f"fed={fed} must divide data axis {data}")
        shape = (fed, data // fed, model)
        axes = ("fed", "dp", "tp")
    else:                                  # multi pod
        pods, data, model = ranks.shape
        if fed % pods:
            raise ValueError(f"fed={fed} must be a multiple of pods={pods}")
        per_pod = fed // pods
        if data % per_pod:
            raise ValueError(f"fed/pod={per_pod} must divide data={data}")
        shape = (pods, per_pod, data // per_pod, model)
        axes = ("pod", "fed", "dp", "tp")
    return DeviceMesh(mesh.device_type, ranks.reshape(shape),
                      mesh_dim_names=axes)


def fed_axes(mesh) -> tuple:
    """The named axes the consensus ring spans."""
    return ("pod", "fed") if "pod" in axis_sizes(mesh) else ("fed",)


def fed_ring_perms(mesh) -> tuple[list, list]:
    """Forward/backward (src, dst) pairs for the consensus ring over the
    fed axes product, as positions along that product (pod major) —
    computed once per mesh, so that the ring helpers
    (consensus.ring_neighbors / transport.ring_exchange_shard) don't
    rebuild them on every call. The ring wraps across pods on the
    multi-pod mesh, crossing pods exactly twice per round."""
    n = fed_size(mesh)
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    return fwd, bwd


def dp_size(mesh) -> int:
    return axis_sizes(mesh)["dp"]


def tp_size(mesh) -> int:
    return axis_sizes(mesh)["tp"]


def fed_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    f = sizes["fed"]
    if "pod" in sizes:
        f *= sizes["pod"]
    return f
