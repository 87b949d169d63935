"""The port's sharding rules (``repro_torch.launch.sharding``) against the
JAX package's, with no device:

* every case of ``tests/test_sharding_rules.py`` on the port's rules;
* for every arch of the registry at full size, the spec of each leaf of
  the federated state (F=4), the serve params, the decode states' caches
  (decode_32k, and long_500k with a 4,096-token window) and the inputs of
  every input shape, on the FED, FED_POD, PROD and PROD_POD meshes:
  equal tuples, with FSDP on and off;
* the local shapes of the port's meta DTensors on a fake world of 512
  ranks (rank 0) equal the shard shapes the reference's specs imply;
* a ``NamedSharding``'s placements, tuple entries in mesh order.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro.configs import base as jbase
from repro.configs.registry import ARCHS as JARCHS
from repro.launch import sharding as jsharding
from repro.launch import steps as jsteps
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import sharding, steps
from repro_torch.launch.sharding import P

from test_torch_structs import _key, _port_paths


def _mesh(axes: dict):
    return SimpleNamespace(axis_names=tuple(axes), shape=dict(axes))


FED = _mesh({"fed": 4, "dp": 4, "tp": 16})
FED_POD = _mesh({"pod": 2, "fed": 2, "dp": 8, "tp": 16})
PROD = _mesh({"data": 16, "model": 16})
PROD_POD = _mesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"FED": FED, "FED_POD": FED_POD, "PROD": PROD,
          "PROD_POD": PROD_POD}
F = 4
WINDOW = 4096


# --- the reference's rule cases, on the port ---------------------------------

def test_big_2d_weight_gets_tp_and_dp():
    assert sharding.fed_param_spec((4, 4096, 14336), FED) == \
        P("fed", "dp", "tp")


def test_small_param_replicated():
    assert sharding.fed_param_spec((4, 4096), FED) == P("fed", None)


def test_fsdp_off_drops_dp():
    assert sharding.fed_param_spec((4, 4096, 14336), FED, fsdp=False) == \
        P("fed", None, "tp")


def test_vocab_table_row_parallel():
    spec = sharding.fed_param_spec((4, 151936, 2048), FED, name="table")
    assert spec[1] == "tp"


def test_row_parallel_names():
    assert sharding.fed_param_spec((4, 36, 4096, 4096), FED,
                                   name="wo")[2] == "tp"
    spec = sharding.fed_param_spec((4, 36, 14336, 4096), FED,
                                   name="w_down")
    assert spec[2] == "tp"


def test_col_parallel_default():
    spec = sharding.fed_param_spec((4, 36, 4096, 14336), FED, name="wq")
    assert spec[3] == "tp"


def test_odd_vocab_falls_back():
    spec = sharding.fed_param_spec((4, 49155, 4096), FED, name="table")
    assert spec == P("fed", None, "tp")


def test_multipod_fed_axes():
    spec = sharding.fed_param_spec((4, 4096, 4096), FED_POD)
    assert spec[0] == ("pod", "fed")


def test_serve_param_spec():
    assert sharding.serve_param_spec((4096, 14336), PROD) == \
        P("data", "model")
    assert sharding.serve_param_spec((4096,), PROD) == P(None)


def test_fed_batch_spec():
    assert sharding.fed_batch_spec((4, 64, 4096), FED) == \
        P("fed", "dp", None)
    assert sharding.fed_batch_spec((4, 3, 4096), FED) == \
        P("fed", None, None)


def test_serve_batch_spec():
    assert sharding.serve_batch_spec((128,), PROD) == P(("data",))
    assert sharding.serve_batch_spec((1,), PROD) == P(None)


def test_cache_spec_kv_heads_over_model():
    spec = sharding.cache_spec((32, 128, 32768, 32, 128), PROD)
    assert spec[1] == "data" and spec[3] == "model"


def test_cache_spec_seq_fallback():
    spec = sharding.cache_spec((36, 128, 32768, 8, 128), PROD)
    assert spec[3] is None and spec[2] == "model"


# --- every leaf of every arch, against the reference's rules ----------------

def _structs(jax_side: bool, arch: str) -> dict:
    """name -> (tree, spec rule, meshes) of each struct of ``arch``."""
    st, base, cfg = (jsteps, jbase, JARCHS[arch]) if jax_side \
        else (steps, tbase, ARCHS[arch])
    train = base.TrainConfig(remat="full")
    shapes = base.INPUT_SHAPES
    fed, serve = ("FED", "FED_POD"), ("PROD", "PROD_POD")
    out = {"fed_state": (st.fed_state_struct(cfg, F, train), "fed_param",
                         fed),
           "serve_params": (st.serve_params_struct(cfg), "serve_param",
                            serve),
           "decode_32k": (st.decode_state_struct(
               cfg, shapes["decode_32k"]), "cache", serve),
           "long_500k": (st.decode_state_struct(
               cfg, shapes["long_500k"], window_override=WINDOW), "cache",
               serve)}
    for name, shape in shapes.items():
        if shape.mode == "train":
            out["in_" + name] = (st.input_specs(cfg, shape, F),
                                 "fed_batch", fed)
        else:
            out["in_" + name] = (st.input_specs(cfg, shape), "serve_batch",
                                 serve)
    return out


@pytest.fixture(scope="module")
def structs():
    return {arch: (_structs(True, arch), _structs(False, arch))
            for arch in sorted(ARCHS)}


def _spec_leaves(mod, tree, rule, mesh, fsdp, jax_side):
    """(path, shape, spec tuple) of every leaf, in tree order."""
    if rule in ("fed_param", "serve_param"):
        specs = mod._tree_specs(tree, getattr(mod, rule + "_spec"), mesh,
                                fsdp=fsdp)
    else:
        fn = getattr(mod, rule + "_spec" if rule != "cache"
                     else "cache_spec")
        specs = jax.tree.map(lambda l: fn(tuple(l.shape), mesh)
                             if l.shape else JP(), tree) if jax_side \
            else sharding.tree_map_with_path(
                lambda _, l: fn(tuple(l.shape), mesh) if l.dim() else P(),
                tree)
    if jax_side:
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        spec_l = jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, JP))
        return [(tuple(_key(e) for e in path), tuple(leaf.shape), tuple(s))
                for (path, leaf), s in zip(leaves, spec_l)]
    paths = _port_paths(tree)
    spec_l = [tuple(s) for s in _sorted_leaves(specs)]
    return [(path, shape, s) for (path, shape, _), s in zip(paths, spec_l)]


def _sorted_leaves(tree):
    """Leaves in ``_port_paths``'s order (dict keys sorted); a
    PartitionSpec, itself a tuple, is a leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [x for sub in tree for x in _sorted_leaves(sub)]
    return [tree]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_leaf_spec_matches_reference(arch, structs):
    jstructs, tstructs = structs[arch]
    checked = 0
    for name, (jtree, rule, meshes) in jstructs.items():
        ttree = tstructs[name][0]
        for mesh_name in meshes:
            for fsdp in (True, False):
                if fsdp is False and rule not in ("fed_param",
                                                  "serve_param"):
                    continue
                mesh = MESHES[mesh_name]
                want = _spec_leaves(jsharding, jtree, rule, mesh, fsdp, True)
                got = _spec_leaves(sharding, ttree, rule, mesh, fsdp, False)
                assert len(got) == len(want) > 0, (name, mesh_name)
                for (tp, ts, tspec), (jp, js, jspec) in zip(got, want):
                    assert (tp, ts) == (jp, js), (name, tp, jp)
                    assert tspec == jspec, (name, mesh_name, fsdp, tp,
                                            tspec, jspec)
                    checked += 1
    assert checked > 100


# --- local shapes of the port's meta DTensors on a fake world ---------------

@pytest.fixture(scope="module")
def device_meshes():
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        yield {name: DeviceMesh("cpu", torch.arange(
            int(np.prod(list(m.shape.values())))).reshape(
                tuple(m.shape.values())), mesh_dim_names=m.axis_names)
            for name, m in MESHES.items()}
    finally:
        dist.destroy_process_group()


def _implied_local(shape, spec, mesh):
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if entry is None else \
            (entry,) if isinstance(entry, str) else entry
        n = int(np.prod([mesh.shape[a] for a in axes]))
        out.append(-(-dim // n))
    return tuple(out)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_meta_dtensor_local_shapes_match_reference_specs(arch, structs,
                                                         device_meshes):
    jstructs, tstructs = structs[arch]
    for name, (jtree, rule, meshes) in jstructs.items():
        ttree = tstructs[name][0]
        for mesh_name in meshes:
            mesh, dmesh = MESHES[mesh_name], device_meshes[mesh_name]
            want = _spec_leaves(jsharding, jtree, rule, mesh, True, True)
            if rule == "fed_param":
                placed = sharding.place(
                    ttree, sharding.fed_state_shardings(ttree, dmesh))
            elif rule == "serve_param":
                placed = sharding.place(
                    ttree, sharding.serve_state_shardings(ttree, dmesh))
            else:
                placed = sharding.with_sharding(
                    ttree, dmesh, getattr(sharding, rule + "_spec"
                                          if rule != "cache"
                                          else "cache_spec"))
            leaves = _sorted_leaves(placed)
            assert len(leaves) == len(want)
            for leaf, (path, shape, spec) in zip(leaves, want):
                assert tuple(leaf.shape) == shape
                assert leaf._local_tensor.device.type == "meta"
                assert tuple(leaf._local_tensor.shape) == \
                    _implied_local(shape, spec, mesh), (name, mesh_name,
                                                        path, spec)


def test_named_sharding_placements(device_meshes):
    from torch.distributed.tensor import Replicate, Shard
    pod = device_meshes["FED_POD"]
    ns = sharding.NamedSharding(pod, P(("pod", "fed"), "dp", None, "tp"))
    assert ns.placements == (Shard(0), Shard(0), Shard(1), Shard(3))
    ns = sharding.NamedSharding(device_meshes["PROD"], P(None, "model"))
    assert ns.placements == (Replicate(), Shard(1))
    with pytest.raises(ValueError, match="mesh order"):
        sharding.NamedSharding(pod, P(("fed", "pod"))).placements
    # (pod, fed) shards pod major: rank 128 is (pod 0, fed 1), node 1
    leaf = torch.empty((4, 8, 32), device="meta")
    placed = sharding.abstract_dtensor(
        leaf, sharding.NamedSharding(pod, P(("pod", "fed"), None, None)))
    assert tuple(placed._local_tensor.shape) == (1, 8, 32)
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset
    for rank, node in ((0, 0), (128, 1), (256, 2), (384, 3)):
        coord = [int(c) for c in np.argwhere(pod.mesh.numpy() == rank)[0]]
        _, offset = _compute_local_shape_and_global_offset(
            (4, 8, 32), tuple(pod.shape), coord, placed.placements)
        assert offset[0] == node
