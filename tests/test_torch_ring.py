"""The port's mesh-mode ring helpers over a real process group, against the
JAX package's named-axis forms:

* ``consensus.ring_neighbors``, ``ring_sketch_exchange`` and
  ``ring_consensus_shard`` and ``transport.ring_exchange_shard`` in one
  spawn of 4 gloo processes (a ``file://`` store in ``tmp_path``), one
  node a rank, on a ``("fed",)`` ring of 4 and on a ``("pod", "fed")``
  mesh of 2 x 2, whose ring runs pod major; each against the reference's
  ``jax.vmap(..., axis_name="fed")`` form on the same numpy inputs (a
  ring of 4 in the pod-major order of the 2 x 2 mesh's ranks): f32
  within the reference's atol 1e-5 and the bf16 wire, ``shards`` 1, 2
  and 4;
* in the same spawn, the steps in mesh mode with their shards and halos
  on other ranks, against the plain steps on the full tensors: the smoke
  qwen3 train step (F=4, distinct ratios and node params) on a
  ``("fed", "dp", "tp")`` mesh of 4 x 1 x 1 (bit for bit) and of
  2 x 2 x 1 (two nodes a rank on a 2-rank dp sub-mesh), and the prefill
  and 3 decode steps on a 2 x 2 ``("data", "model")`` mesh, with the KV
  cache sharded over its heads and, with one KV head, over its slots;
* the helpers refuse to run without a mesh or a process group;
* the mesh train step and the serving prefill on a one-rank gloo world
  with DTensor state (a ring one rank wide, a one-device node mesh) give
  the plain steps' bits.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import consensus, flatten, transport

K = 4
GAMMA = 0.4
RATIOS = np.array([0.3, 0.8, 0.6, 0.9], np.float32)
CASES = [("fed", "f32", 1), ("fed", "f32", 2), ("fed", "f32", 4),
         ("fed", "bf16", 1), ("fed", "bf16", 2), ("fed", "bf16", 4),
         ("pod_fed", "f32", 2), ("pod_fed", "bf16", 4)]


def _params():
    rng = np.random.default_rng(9)
    return {"w1": rng.normal(size=(K, 61, 30)).astype(np.float32),
            "b1": rng.normal(size=(K, 30)).astype(np.float32),
            "w2": rng.normal(size=(K, 30, 10)).astype(np.float32),
            "b2": rng.normal(size=(K, 10)).astype(np.float32)}


def _worker(rank: int, store: str, out_dir: str) -> None:
    from torch.distributed.device_mesh import DeviceMesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=K)
    try:
        meshes = {
            "fed": (DeviceMesh("cpu", torch.arange(K),
                               mesh_dim_names=("fed",)), "fed"),
            "pod_fed": (DeviceMesh("cpu", torch.arange(K).reshape(2, 2),
                                   mesh_dim_names=("pod", "fed")),
                        ("pod", "fed"))}
        params = {name: torch.from_numpy(v[rank])
                  for name, v in _params().items()}
        out = {}
        for mesh_name, (mesh, axis) in meshes.items():
            ratio = torch.tensor(RATIOS[rank:rank + 1])
            prv, nxt = consensus.ring_neighbors(ratio, axis, mesh=mesh)
            out[f"{mesh_name}/prev"] = prv.numpy()
            out[f"{mesh_name}/next"] = nxt.numpy()
            ep, en = consensus.ring_sketch_exchange(ratio, axis, mesh=mesh)
            out[f"{mesh_name}/ep"] = ep.numpy()
            out[f"{mesh_name}/en"] = en.numpy()
            for name, wire, shards in CASES:
                if name != mesh_name:
                    continue
                mixed = consensus.ring_consensus_shard(
                    params, ep[0], en[0], GAMMA, axis, wire_dtype=wire,
                    shards=shards, mesh=mesh)
                for leaf_name, leaf in mixed.items():
                    out[f"{name}/{wire}/{shards}/{leaf_name}"] = \
                        leaf.numpy()
                vec, _ = flatten.flatten_one(params)
                perms = ([(i, (i + 1) % K) for i in range(K)],
                         [(i, (i - 1) % K) for i in range(K)])
                out[f"{name}/{wire}/{shards}/vec"] = \
                    transport.ring_exchange_shard(
                        vec, ep[0], en[0], GAMMA, axis, wire_dtype=wire,
                        shards=shards, perms=perms, mesh=mesh).numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        steps_out = _mesh_steps()
        if rank == 0:
            np.savez(os.path.join(out_dir, "steps.npz"), **steps_out)
    finally:
        dist.destroy_process_group()


# -- the steps in mesh mode on 4 ranks, against the plain steps -------------

# (name, mesh shape): a ring of 4 ranks of one node each, and a ring of 2
# ranks of 2 nodes each whose nodes run on a 2-rank dp sub-mesh (FSDP
# params, batch rows over dp); then a 2 x 2 (data, model) serving mesh
TRAIN_MESHES = [("fed4", (4, 1, 1)), ("fed2_dp2", (2, 2, 1))]
# serving: the smoke qwen3 (its 4 KV heads over model) and the same with
# one KV head, whose cache shards its positions over model instead; a
# 4-slot cache, so the 3 decode steps (slots 0-2) write on both shards
SERVE_KV = (4, 1)
SERVE_SLOTS = 4


def _train_setup():
    """The smoke qwen3 on K nodes, each from its own seed, K distinct
    ratios (eta_prev != eta_next on every node), and the step."""
    from repro_torch.configs.base import FedConfig, TrainConfig
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    cfg = get_smoke_arch("qwen3-1.7b")
    nodes = [flatten.leaves_with_paths(transformer.init_params(
        cfg, torch.Generator().manual_seed(20 + k), device="cpu"))
        for k in range(K)]
    paths = [path for path, _ in nodes[0]]
    stacked = flatten.build_tree(paths, [
        torch.stack([node[i][1] for node in nodes])
        for i in range(len(paths))])
    tokens = torch.randint(0, cfg.vocab_size, (K, 2, 16),
                           generator=torch.Generator().manual_seed(3))
    batch = {"tokens": tokens, "labels": tokens.roll(1, -1)}
    state = steps.MeshFedState(
        params=stacked,
        opt=steps.AdamState(
            step=torch.zeros(K, dtype=torch.int32),
            m=flatten.tree_map(torch.zeros_like, stacked),
            v=flatten.tree_map(torch.zeros_like, stacked)),
        ratios=torch.tensor(RATIOS))
    step = steps.make_fed_train_step(cfg, FedConfig(num_nodes=K),
                                     TrainConfig(learning_rate=1e-3))
    return state, batch, step


def _serve_setup(kv: int):
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.models import transformer
    import dataclasses
    cfg = dataclasses.replace(get_smoke_arch("qwen3-1.7b"), num_kv_heads=kv)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(5),
                                     device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 5),
                           generator=torch.Generator().manual_seed(6))
    return cfg, params, tokens


def _serve_run(cfg, params, tokens, to_mesh=None):
    """The prefill's tokens of a 2-token prompt, then 3 decode steps' tokens
    and the caches after them: ``{key: array}``; ``to_mesh(tree, spec_fn)``
    places a tree on the serving mesh (None: plain tensors)."""
    from repro_torch.launch import sharding, steps
    from repro_torch.models import transformer
    place = to_mesh or (lambda tree, spec_fn: tree)

    def batch_spec(shape, mesh, name):
        return sharding.serve_batch_spec(shape, mesh)

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    params = place(params, sharding.serve_param_spec)
    out = {"prefill": whole(steps.make_prefill_step(cfg, multi_pod=False)(
        params, place({"tokens": tokens[:, :2]}, batch_spec)))}
    state = place(transformer.init_decode(cfg, 2, SERVE_SLOTS, device="cpu"),
                  lambda s, m, name: sharding.cache_spec(s, m))
    serve = steps.make_serve_step(cfg)
    for t in range(2, 5):
        tok, state = serve(params, state, place(tokens[:, t], batch_spec))
        out[f"decode{t}"] = whole(tok)
    for path, leaf in flatten.leaves_with_paths(state):
        out["cache/" + "/".join(map(str, path))] = whole(leaf)
    return {key: v.numpy() for key, v in out.items()}


def _mesh_steps() -> dict:
    """Two mesh train steps on each of TRAIN_MESHES and the serving steps
    on a 2 x 2 (data, model) mesh, from the full tensors that every rank
    builds alike; each result gathered whole (rank 0 keeps them)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch import sharding

    def to_mesh(mesh, tree, spec_fn):
        def place(path, leaf):
            spec = spec_fn(tuple(leaf.shape), mesh,
                           name=sharding._leaf_name(path)) \
                if leaf.dim() else sharding.P()
            return distribute_tensor(
                leaf, mesh, sharding.NamedSharding(mesh, spec).placements,
                src_data_rank=None)
        return sharding.tree_map_with_path(place, tree)

    out = {}
    for name, shape in TRAIN_MESHES:
        mesh = DeviceMesh("cpu", torch.arange(K).reshape(shape),
                          mesh_dim_names=("fed", "dp", "tp"))
        state, batch, step = _train_setup()
        state = to_mesh(mesh, state, sharding.fed_param_spec)
        batch = to_mesh(mesh, batch, lambda s, m, name:
                        sharding.fed_batch_spec(s, m))
        for _ in range(2):
            state, loss = step(state, batch)
        out[f"{name}/loss"] = loss.numpy()
        for i, (_, leaf) in enumerate(flatten.leaves_with_paths(state)):
            out[f"{name}/{i}"] = leaf.full_tensor().numpy()
    mesh = DeviceMesh("cpu", torch.arange(K).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    for kv in SERVE_KV:
        got = _serve_run(*_serve_setup(kv), lambda tree, spec_fn:
                         to_mesh(mesh, tree, spec_fn))
        out.update({f"serve_kv{kv}/{key}": v for key, v in got.items()})
    return out


def _reference():
    """The reference's named-axis results, (K, ...) stacked by node."""
    import jax
    import jax.numpy as jnp
    from repro.core import consensus as jconsensus
    from repro.core import flatten as jflatten
    from repro.core import transport as jtransport
    params = jax.tree.map(jnp.asarray, _params())
    ratios = jnp.asarray(RATIOS)
    out = {}

    def on(mesh_name, fn, *args):
        """fn under vmap over one named axis of K: the (pod, fed) ring is
        that ring too, its positions pod major (rank = 2 * pod + fed)."""
        return jax.vmap(lambda *a: fn("fed", *a), axis_name="fed")(*args)

    for mesh_name in ("fed", "pod_fed"):
        prv, nxt = on(mesh_name, lambda ax, r: jconsensus.ring_neighbors(
            r, ax), ratios)
        out[f"{mesh_name}/prev"], out[f"{mesh_name}/next"] = prv, nxt
        ep, en = on(mesh_name, lambda ax, r:
                    jconsensus.ring_sketch_exchange(r, ax), ratios)
        out[f"{mesh_name}/ep"], out[f"{mesh_name}/en"] = ep, en
        for name, wire, shards in CASES:
            if name != mesh_name:
                continue
            mixed = on(name, lambda ax, p, a, b, w=wire, s=shards:
                       jconsensus.ring_consensus_shard(
                           p, a, b, GAMMA, ax, wire_dtype=w, shards=s),
                       params, ep, en)
            for leaf_name, leaf in mixed.items():
                out[f"{name}/{wire}/{shards}/{leaf_name}"] = leaf
            vec = jax.vmap(lambda p: jflatten.flatten_one(p)[0])(params)
            out[f"{name}/{wire}/{shards}/vec"] = on(
                name, lambda ax, v, a, b, w=wire, s=shards:
                jtransport.ring_exchange_shard(v, a, b, GAMMA, ax,
                                               wire_dtype=w, shards=s),
                vec, ep, en)
    return {key: np.asarray(v, np.float32) for key, v in out.items()}


@pytest.fixture(scope="module")
def ring_run(tmp_path_factory):
    """One spawn of K gloo ranks for the module: ``(per-rank results,
    the directory of steps.npz)``."""
    import torch.multiprocessing as mp
    tmp_path = tmp_path_factory.mktemp("ring")
    mp.start_processes(_worker, args=(str(tmp_path / "store"),
                                      str(tmp_path)),
                       nprocs=K, start_method="spawn")
    return ([dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(K)],
            tmp_path)


def test_ring_helpers_over_gloo_match_the_named_axis_reference(ring_run):
    got, _ = ring_run
    want = _reference()
    assert set(got[0]) == set(want)
    for key, value in want.items():
        stacked = np.stack([g[key] for g in got]).reshape(value.shape)
        np.testing.assert_allclose(stacked, value, rtol=0, atol=1e-5,
                                   err_msg=key)
    # the ring is node k-1 -> k: rank k holds ratio k-1 from "prev"; on the
    # (pod, fed) mesh the product runs pod major
    for mesh_name in ("fed", "pod_fed"):
        prev = np.stack([g[f"{mesh_name}/prev"] for g in got]).ravel()
        np.testing.assert_array_equal(prev, np.roll(RATIOS, 1))
    # the bf16 wire differs from the f32 one (the cast is real)
    assert not np.array_equal(got[0]["fed/bf16/1/vec"],
                              got[0]["fed/f32/1/vec"])


def test_mesh_steps_on_four_ranks_equal_the_plain_steps(ring_run,
                                                         one_thread):
    """The train step with its halos from other ranks, against the plain
    step on the full tensors: on the ring of 4 ranks (one node a rank, on
    local tensors) bit for bit; with 2 nodes a rank on 2-rank dp
    sub-meshes, whose batch rows and FSDP shards sum in another order,
    the loss and Adam's moments within f32 rounding and the params within
    1% of one Adam step (lr 1e-3: Adam divides by sqrt(v), so on a
    gradient near 0 the rounding of the dp sum moves m/sqrt(v) by up to
    ~1e-2). A neighbor taken from the wrong side moves a param by ~1e-3.
    Then the prefill and 3 decode steps on a 2 x 2 (data, model) mesh:
    tokens equal, the caches (k and v of unit scale, after the k norm
    and the row-parallel projections' sums over model) within 1e-5; a
    slot written in the wrong place differs by ~1."""
    _, tmp_path = ring_run
    got = dict(np.load(tmp_path / "steps.npz"))
    state, batch, step = _train_setup()
    for _ in range(2):
        state, loss = step(state, batch)
    pairs = flatten.leaves_with_paths(state)
    for name, _ in TRAIN_MESHES:
        np.testing.assert_allclose(got[f"{name}/loss"], loss.numpy(),
                                   rtol=0 if name == "fed4" else 1e-6,
                                   err_msg=name)
        for i, (path, leaf) in enumerate(pairs):
            if name == "fed4":
                np.testing.assert_array_equal(got[f"{name}/{i}"],
                                              leaf.numpy(), err_msg=path)
                continue
            params = path[0] == 0
            np.testing.assert_allclose(
                got[f"{name}/{i}"], leaf.numpy(), rtol=0 if params else 1e-5,
                atol=1e-5 if params else 1e-6, err_msg=f"{name} {path}")
    for kv in SERVE_KV:
        for key, value in _serve_run(*_serve_setup(kv)).items():
            if value.dtype.kind in "iu":
                np.testing.assert_array_equal(got[f"serve_kv{kv}/{key}"],
                                              value, err_msg=key)
            else:
                np.testing.assert_allclose(got[f"serve_kv{kv}/{key}"], value,
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=f"kv={kv} {key}")


def test_ring_helpers_refuse_without_a_mesh_or_a_group():
    x = torch.ones(3)
    with pytest.raises(ValueError, match="needs the DeviceMesh"):
        consensus.ring_neighbors(x, "fed")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs a process group"):
        consensus.ring_sketch_exchange(x, "fed", mesh=object())
    with pytest.raises((KeyError, ValueError), match="f64"):
        transport.ring_exchange_shard(x, x[0], x[0], 0.4, "fed",
                                      wire_dtype="f64")


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


@pytest.fixture
def one_rank(tmp_path):
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/one",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _to_mesh(tree, mesh, spec_fn):
    """Real DTensors of a tree of CPU tensors, placed by spec_fn."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch import sharding

    def place(path, leaf):
        spec = spec_fn(tuple(leaf.shape), mesh, name=sharding._leaf_name(
            path)) if leaf.dim() else sharding.P()
        return DTensor.from_local(
            leaf, mesh, sharding.NamedSharding(mesh, spec).placements,
            run_check=False)
    return sharding.tree_map_with_path(place, tree)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-7b"])
def test_one_rank_mesh_train_step_equals_the_plain_step(arch, one_rank, one_thread):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor
    from repro_torch.configs.base import FedConfig, TrainConfig
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.launch import sharding, steps
    from repro_torch.models import transformer
    cfg = get_smoke_arch(arch)
    gen = torch.Generator().manual_seed(1)
    f = 2
    stacked = flatten.tree_map(
        lambda leaf: torch.stack([leaf, leaf * 1.01]),
        transformer.init_params(cfg, gen, device="cpu"))
    tokens = torch.randint(0, cfg.vocab_size, (f, 2, 16), generator=gen)
    batch = {"tokens": tokens, "labels": tokens.roll(1, -1)}

    def state():
        return steps.MeshFedState(
            params=flatten.tree_map(torch.clone, stacked),
            opt=steps.AdamState(
                step=torch.zeros(f, dtype=torch.int32),
                m=flatten.tree_map(lambda l: torch.zeros_like(
                    l, dtype=torch.float32), stacked),
                v=flatten.tree_map(lambda l: torch.zeros_like(
                    l, dtype=torch.float32), stacked)),
            ratios=torch.tensor([0.4, 0.7]))

    step = steps.make_fed_train_step(cfg, FedConfig(num_nodes=f),
                                     TrainConfig(learning_rate=1e-3))
    plain, plain_loss = step(state(), batch)
    plain, plain_loss = step(plain, batch)
    mesh = DeviceMesh("cpu", torch.zeros((1, 1, 1), dtype=torch.int64),
                      mesh_dim_names=("fed", "dp", "tp"))
    dstate = _to_mesh(state(), mesh, sharding.fed_param_spec)
    dbatch = {k: DTensor.from_local(
        v, mesh, sharding.NamedSharding(
            mesh, sharding.fed_batch_spec(tuple(v.shape), mesh)).placements,
        run_check=False) for k, v in batch.items()}
    meshed, loss = step(dstate, dbatch)
    meshed, loss = step(meshed, dbatch)
    assert isinstance(meshed.params["embed"]["table"], DTensor)
    assert torch.equal(loss, plain_loss)
    for tree_p, tree_m in ((plain.params, meshed.params),
                           (plain.opt.m, meshed.opt.m),
                           (plain.opt.v, meshed.opt.v)):
        for (path, a), (_, b) in zip(flatten.leaves_with_paths(tree_p),
                                     flatten.leaves_with_paths(tree_m)):
            assert torch.equal(a, b.to_local()), path
    assert torch.equal(meshed.opt.step.to_local(), plain.opt.step)


def test_one_device_prefill_and_decode_equal_the_plain_steps(one_rank, one_thread):
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.launch import sharding, steps
    from repro_torch.models import transformer
    cfg = get_smoke_arch("qwen3-1.7b")
    gen = torch.Generator().manual_seed(2)
    params = transformer.init_params(cfg, gen, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    mesh = DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.int64),
                      mesh_dim_names=("data", "model"))
    dparams = _to_mesh(params, mesh, sharding.serve_param_spec)
    prefill = steps.make_prefill_step(cfg, multi_pod=False)
    batch = {"tokens": tokens}
    want = prefill(params, batch)
    got = prefill(dparams, _to_mesh(batch, mesh,
                                    lambda s, m, name: sharding
                                    .serve_batch_spec(s, m)))
    assert torch.equal(got.to_local(), want)
    serve = steps.make_serve_step(cfg)
    state = transformer.init_decode(cfg, 2, 20, device="cpu")
    dstate = _to_mesh(transformer.init_decode(cfg, 2, 20, device="cpu"),
                      mesh, lambda s, m, name: sharding.cache_spec(s, m))
    for t in range(3):
        tok = tokens[:, t]
        want, state = serve(params, state, tok)
        got, dstate = serve(dparams, dstate, _to_mesh(
            tok, mesh, lambda s, m, name: sharding.serve_batch_spec(s, m)))
        assert torch.equal(got.to_local(), want)
