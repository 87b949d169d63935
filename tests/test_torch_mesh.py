"""The port's meshes (``repro_torch.launch.mesh``), its single-node
layout and column shards (``core/flatten.py``), its logical constraints
(``models/pspec.py``) and the steps' plain path under the installed rules,
against the JAX package:

* ``fed_ring_perms``, ``fed_axes``, ``dp_size``, ``tp_size`` and
  ``fed_size`` on the reference tests' stand-in meshes;
* ``make_production_mesh`` on a fake world of 512 ranks, its refusal in a
  smaller world, ``make_fed_mesh``'s re-views and the reference's errors;
* ``column_shards`` over a grid; ``flatten_one``/``unflatten_one`` on a
  ragged mixed-dtype tree, bit for bit;
* ``constrain``: its input itself on a plain tensor, with and without
  rules; on DTensors the mapped placements, and the reference's drop rule
  (axis missing, of size 1, or not dividing the dim);
* the steps install the reference's rules and give the same bits as with
  none installed.
"""
import contextlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import flatten as jflatten
from repro.launch import mesh as jmesh
from repro_torch.configs.base import FedConfig, TrainConfig
from repro_torch.configs.registry import get_smoke_arch
from repro_torch.core import flatten
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import steps
from repro_torch.models import pspec, transformer


def _ns(axes: dict):
    return SimpleNamespace(axis_names=tuple(axes), shape=dict(axes))


FED = _ns({"fed": 4, "dp": 4, "tp": 16})
FED_POD = _ns({"pod": 2, "fed": 2, "dp": 8, "tp": 16})
FED_8 = _ns({"pod": 2, "fed": 4, "dp": 4, "tp": 16})


@pytest.mark.parametrize("mesh", [FED, FED_POD, FED_8],
                         ids=["fed", "fed_pod", "fed_pod_8"])
def test_fed_helpers_match_reference(mesh):
    assert meshlib.fed_ring_perms(mesh) == jmesh.fed_ring_perms(mesh)
    assert meshlib.fed_axes(mesh) == jmesh.fed_axes(mesh)
    assert meshlib.fed_size(mesh) == jmesh.fed_size(mesh)
    assert meshlib.dp_size(mesh) == jmesh.dp_size(mesh)
    assert meshlib.tp_size(mesh) == jmesh.tp_size(mesh)


@pytest.fixture(scope="module")
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_production_mesh_needs_its_ranks():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="need 256 ranks, have 0"):
        meshlib.make_production_mesh(device="cpu")


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_and_fed_meshes(fake_world, multi_pod):
    pmesh = meshlib.make_production_mesh(multi_pod=multi_pod, device="cpu")
    want = {"pod": 2, "data": 16, "model": 16} if multi_pod \
        else {"data": 16, "model": 16}
    assert meshlib.axis_sizes(pmesh) == want
    assert pmesh.device_type == "cpu"
    for fed in (2, 4, 8):
        fmesh = meshlib.make_fed_mesh(pmesh, fed)
        assert torch.equal(fmesh.mesh.reshape(-1), torch.arange(pmesh.size()))
        sizes = meshlib.axis_sizes(fmesh)
        if multi_pod:
            assert sizes == {"pod": 2, "fed": fed // 2, "dp": 32 // fed,
                             "tp": 16}
        else:
            assert sizes == {"fed": fed, "dp": 16 // fed, "tp": 16}
        assert meshlib.fed_size(fmesh) == fed
        assert meshlib.fed_ring_perms(fmesh)[0][-1] == (fed - 1, 0)
    # the fed re-view keeps the rank layout: fed index f holds ranks
    # [f * dp * tp, (f + 1) * dp * tp) on one pod
    fmesh = meshlib.make_fed_mesh(pmesh, 4)
    if not multi_pod:
        assert int(fmesh.mesh[1, 0, 0]) == 64


@pytest.mark.parametrize("multi_pod,fed", [(False, 3), (False, 32),
                                           (True, 3), (True, 6)])
def test_fed_mesh_errors_match_reference(fake_world, multi_pod, fed):
    pmesh = meshlib.make_production_mesh(multi_pod=multi_pod, device="cpu")
    ref = SimpleNamespace(devices=np.empty(tuple(pmesh.shape)))
    with pytest.raises(ValueError) as want:
        jmesh.make_fed_mesh(ref, fed)
    with pytest.raises(ValueError) as got:
        meshlib.make_fed_mesh(pmesh, fed)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("padded", [128, 256, 640, 1024, 1280, 3072, 23936,
                                    100, 0])
def test_column_shards_grid(padded):
    for shards in range(0, 9):
        assert flatten.column_shards(padded, shards) == \
            jflatten.column_shards(padded, shards), (padded, shards)


def _ragged():
    rng = np.random.default_rng(3)
    return {"w": rng.normal(size=(7, 3)).astype(np.float32),
            "gain": rng.normal(size=()).astype(np.float32),
            "blocks": [{"a": rng.normal(size=(5,)).astype(np.float32)},
                       {"a": rng.normal(size=(2, 2, 2)).astype(np.float32)}],
            "half": rng.normal(size=(33,)).astype(np.float32)}


def test_flatten_one_round_trip_bit_for_bit():
    tree = _ragged()
    jtree = jax.tree.map(jnp.asarray, tree)
    jtree["half"] = jtree["half"].astype(jnp.bfloat16)
    ttree = flatten.tree_map(torch.from_numpy, tree)
    ttree["half"] = ttree["half"].to(torch.bfloat16)
    jvec, jlayout = jflatten.flatten_one(jtree)
    tvec, tlayout = flatten.flatten_one(ttree)
    assert tlayout.padded == jlayout.padded == 128
    assert tlayout.total == jlayout.total
    assert tlayout.offsets == jlayout.offsets
    assert tvec.dtype == torch.float32
    np.testing.assert_array_equal(tvec.numpy(), np.asarray(jvec))
    assert flatten.make_layout_one(ttree) == tlayout
    back = flatten.unflatten_one(tvec * 3, tlayout)
    jback = jflatten.unflatten_one(jvec * 3, jlayout)
    for (path, leaf), jleaf in zip(flatten.leaves_with_paths(back),
                                   jax.tree.leaves(jback)):
        assert tuple(leaf.shape) == jleaf.shape, path
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      np.asarray(jleaf, np.float32))
    assert back["half"].dtype == torch.bfloat16
    kept = flatten.unflatten_one(tvec, tlayout, cast=False)
    assert kept["half"].dtype == torch.float32
    # f32 leaves are views of the vector
    assert kept["w"].untyped_storage().data_ptr() == \
        tvec.untyped_storage().data_ptr()


# --- constrain ---------------------------------------------------------------

def test_constrain_is_identity_on_plain_tensors():
    x = torch.randn(4, 8, 16)
    assert pspec.constrain(x, "batch", None, "heads") is x
    with pspec.logical_rules(pspec.TRAIN_RULES):
        assert pspec.constrain(x, "batch", None, "heads") is x
        with pspec.logical_rules(pspec.SERVE_RULES):
            assert pspec._RULES is pspec.SERVE_RULES
        assert pspec._RULES is pspec.TRAIN_RULES
    assert pspec._RULES is None


def test_rule_tables_match_reference():
    from repro.models import pspec as jpspec
    for name in ("TRAIN_RULES", "SERVE_RULES", "SERVE_RULES_MULTIPOD"):
        assert getattr(pspec, name) == getattr(jpspec, name)


@pytest.mark.parametrize("case", ["serve", "drop_indivisible", "pod_tuple",
                                  "missing_axis", "train_sub_mesh"])
def test_constrain_places_dtensors_with_the_drop_rule(fake_world, case):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    prod = DeviceMesh("cpu", torch.arange(256).reshape(16, 16),
                      mesh_dim_names=("data", "model"))
    pod = DeviceMesh("cpu", torch.arange(512).reshape(2, 16, 16),
                     mesh_dim_names=("pod", "data", "model"))
    node = DeviceMesh("cpu", torch.arange(64).reshape(4, 16),
                      mesh_dim_names=("dp", "tp"))
    rules, mesh, shape, logical, want = {
        "serve": (pspec.SERVE_RULES, prod, (32, 8, 64),
                  ("batch", None, "vocab"), (Shard(0), Shard(2))),
        # 24 does not divide over 16 model devices: the vocab entry drops
        "drop_indivisible": (pspec.SERVE_RULES, prod, (32, 8, 24),
                             ("batch", None, "vocab"),
                             (Shard(0), Replicate())),
        "pod_tuple": (pspec.SERVE_RULES_MULTIPOD, pod, (64, 8),
                      ("batch", None), (Shard(0), Shard(0), Replicate())),
        # "dp" is not an axis of the production mesh
        "missing_axis": (pspec.TRAIN_RULES, prod, (32, 64),
                         ("batch", "heads"), (Replicate(), Replicate())),
        "train_sub_mesh": (pspec.TRAIN_RULES, node, (8, 5, 32),
                           ("batch", None, "heads"), (Shard(0), Shard(2))),
    }[case]
    local = torch.empty(shape, device="meta")
    x = DTensor.from_local(local, mesh, [Replicate()] * mesh.ndim,
                           run_check=False)
    assert pspec.constrain(x, *logical) is x          # no rules installed
    with pspec.logical_rules(rules):
        y = pspec.constrain(x, *logical)
    assert tuple(y.placements) == want
    assert tuple(y.shape) == shape


@pytest.fixture
def one_thread():
    """Tiny tensors: one intra-op thread, so that a loaded machine's
    spinning worker threads do not dominate the test's time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# --- the steps under the installed rules ------------------------------------

@pytest.mark.parametrize("kind", ["prefill", "prefill_multi_pod", "serve",
                                  "train"])
def test_steps_install_the_rules_and_keep_their_bits(kind, monkeypatch, one_thread):
    cfg = get_smoke_arch("qwen3-1.7b")
    gen = torch.Generator().manual_seed(0)
    params = transformer.init_params(cfg, gen, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    seen = []
    real = pspec.constrain

    def spy(x, *logical):
        seen.append(pspec._RULES)
        out = real(x, *logical)
        assert out is x
        return out

    def run(rules_on: bool):
        if not rules_on:
            monkeypatch.setattr(pspec, "logical_rules",
                                lambda rules: contextlib.nullcontext())
        if kind.startswith("prefill"):
            step = steps.make_prefill_step(
                cfg, multi_pod=kind.endswith("multi_pod"))
            return [step(params, {"tokens": tokens})]
        if kind == "serve":
            state = transformer.init_decode(cfg, 2, 24, device="cpu")
            step = steps.make_serve_step(cfg)
            out = []
            for t in range(3):
                tok, state = step(params, state, tokens[:, t])
                out.append(tok)
            return out
        fed = FedConfig(num_nodes=2)
        train = TrainConfig(learning_rate=1e-3)
        stacked = flatten.tree_map(
            lambda leaf: torch.stack([leaf, leaf * 1.01]), params)
        state = steps.MeshFedState(
            params=stacked,
            opt=steps.AdamState(
                step=torch.zeros(2, dtype=torch.int32),
                m=flatten.tree_map(torch.zeros_like, stacked),
                v=flatten.tree_map(torch.zeros_like, stacked)),
            ratios=torch.tensor([0.4, 0.7]))
        batch = {"tokens": torch.stack([tokens, tokens.flip(0)]),
                 "labels": torch.stack([tokens.roll(1, 1), tokens])}
        new, loss = steps.make_fed_train_step(cfg, fed, train)(state, batch)
        return [loss] + [leaf for _, leaf in
                         flatten.leaves_with_paths(new.params)]

    monkeypatch.setattr(pspec, "constrain", spy)
    with_rules = run(True)
    want_rules = {"prefill": pspec.SERVE_RULES,
                  "prefill_multi_pod": pspec.SERVE_RULES_MULTIPOD,
                  "serve": pspec.SERVE_RULES, "train": pspec.TRAIN_RULES}
    assert seen and all(r is want_rules[kind] for r in seen)
    seen.clear()
    without = run(False)
    assert seen and all(r is None for r in seen)
    for a, b in zip(with_rules, without):
        assert torch.equal(a, b)


def test_gather_dim_and_local_shards(fake_world):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    node = DeviceMesh("cpu", torch.arange(64).reshape(4, 16),
                      mesh_dim_names=("dp", "tp"))
    plain = torch.ones(4, 8)
    assert pspec.gather_dim(plain, 0) is plain
    assert pspec.local_shards(lambda t: t, (plain,), dims=(0,)) is None
    x = DTensor.from_local(torch.empty((2, 8, 1, 32), device="meta"), node,
                           [Shard(0), Shard(2)], run_check=False)
    assert tuple(pspec.gather_dim(x, 0).placements) == \
        (Replicate(), Shard(2))
    assert pspec.gather_dim(x, 1) is x
    # attention-like: row by row along batch (0) and heads (2)
    y = pspec.local_shards(lambda a, b: a * 2 + b, (x, x), dims=(0, 2))
    assert tuple(y.placements) == (Shard(0), Shard(2))
    assert tuple(y.shape) == tuple(x.shape)
    assert tuple(y._local_tensor.shape) == (2, 8, 1, 32)
    assert pspec.local_shards(lambda a: a, (x,), dims=(0,)) is None


def test_map_shards_places_inputs_and_outputs_by_layout(fake_world):
    """The wkv scan's layouts: r (B, S, H, D) over batch and 24 heads on
    16 ranks (uneven), u (H, D) sliced to the rank's heads, a state (B, H,
    D, D) placed over its last dim but one redistributed over heads; the
    outputs' global shapes from r's; None passes through; a plain tensor
    or a shard along a dim the layout does not name is refused."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    node = DeviceMesh("cpu", torch.arange(64).reshape(4, 16),
                      mesh_dim_names=("dp", "tp"))

    def meta(shape, placements):
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        local, _ = compute_local_shape_and_global_offset(shape, node,
                                                         placements)
        return DTensor.from_local(torch.empty(local, device="meta"), node,
                                  placements, run_check=False, shape=shape,
                                  stride=torch.empty(shape,
                                                     device="meta").stride())

    r = meta((8, 16, 24, 64), [Shard(0), Shard(2)])
    u = meta((24, 64), [Replicate(), Replicate()])
    s0 = meta((8, 24, 64, 64), [Shard(0), Shard(2)])
    seen = {}

    def fn(r, u, s0, none):
        seen.update(r=tuple(r.shape), u=tuple(u.shape), s0=tuple(s0.shape),
                    none=none)
        return r * 2, s0 + 1

    heads, state = (0, None, 2, None), (0, 2, None, None)
    y, s = pspec.map_shards(fn, (r, u, s0, None),
                            (heads, (2, None), state, None), (heads, state))
    # rank 0 holds 2 of the 8 rows and 2 of the 24 heads (chunks of 2)
    assert seen == {"r": (2, 16, 2, 64), "u": (2, 64),
                    "s0": (2, 2, 64, 64), "none": None}
    assert tuple(y.shape) == (8, 16, 24, 64)
    assert tuple(y.placements) == (Shard(0), Shard(2))
    assert tuple(s.shape) == (8, 24, 64, 64)
    assert tuple(s.placements) == (Shard(0), Shard(1))
    assert pspec.map_shards(fn, (torch.ones(2),), ((0,),), ((0,),)) is None
    assert pspec.map_shards(fn, (r, u, s0, None), ((0, None, None, None),
                                                   (None, None), state, None),
                            (heads, state)) is None


def test_a_cuda_mesh_of_several_devices_is_refused():
    several = SimpleNamespace(size=lambda: 4)
    one = SimpleNamespace(size=lambda: 1)
    with pytest.raises(NotImplementedError, match="4 devices"):
        steps._sub_mesh_guard(several, "cuda")
    steps._sub_mesh_guard(one, "cuda")
    steps._sub_mesh_guard(several, "cpu")
    steps._sub_mesh_guard(several, "meta")
