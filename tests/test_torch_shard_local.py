"""The model code's shard-local paths on real DTensors over 4 gloo ranks,
against the same calls on plain tensors:

* ``moe.forward`` (routing, dispatch and combine on each rank's own token
  groups, ``pspec.map_shards``): the outputs, the load-balance loss (a
  mean over every rank's groups), the kept (token, choice) pairs at
  capacity 1.25, where some are dropped, and the gradients of the router
  and the experts;
* ``rwkv.forward`` (the wkv scan on each rank's batch rows and heads,
  ``u`` sliced to its heads, the state placed alike): y and the final
  state, through the chunked scan (16 tokens), the sequential scan (5
  tokens) and a one-token decode from a given state placed over its last
  dims, and the gradients of the block's params;
* musicgen's decode step at batch 1 with 3 heads on 2 ``model`` ranks (as
  24 heads on 16), 3 tokens: logits and KV caches;

each on a 2 x 2 ``("data", "model")`` mesh under the serving rules and on
a 1 x 2 x 2 ``("fed", "dp", "tp")`` mesh under ``TRAIN_RULES``, at smoke
width in f32, within rtol 1e-5 / atol 1e-6, but for the rwkv block's y
and state, which pass through row-parallel products that sum over the
ranks in another f32 order: their atol is 1e-6 times the tensor's max
|value| when that passes 1 (the wkv scan on the shards alone,
``rwkv._wkv`` through ``map_shards``, is held to the fixed 1e-6); a
gradient, whose sum over the ranks' rows runs in another order, within
1e-5 of its leaf's max |value|, as the port's gradient checks hold
them. Params are placed by the
sharding rules' tensor-parallel and FSDP choice (``_inner_spec``) at every
size, so that the smoke widths are sharded as the full ones are. One spawn
of 4 processes with a ``file://`` store, as ``tests/test_torch_ring.py``
starts its own.
"""
import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

RANKS = 4
RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-5               # of a gradient leaf's max |value|
# name -> (mesh shape, axis names, batch axis, tensor-parallel axis)
MESHES = {"serve": ((2, 2), ("data", "model"), "data", "model"),
          "train": ((1, 2, 2), ("fed", "dp", "tp"), "dp", "tp")}
MOE_GROUPS = (8, 16)          # group sizes: 4 groups (2 a rank) and 2 (1)
RWKV_SEQS = (16, 5)           # the chunked and the sequential scan
DECODE_STEPS = 3
DECODE_SLOTS = 8


def _rules(name):
    from repro_torch.models import pspec
    return pspec.SERVE_RULES if name == "serve" else pspec.TRAIN_RULES


def _moe_setup():
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_smoke_arch("mixtral-8x7b"),
                              capacity_factor=1.25)
    params = moe.init(torch.Generator().manual_seed(11), cfg)
    x = torch.randn((4, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(12))
    return cfg, params, x


def _rwkv_setup():
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.models import rwkv
    cfg = get_smoke_arch("rwkv6-7b")
    params = rwkv.init(torch.Generator().manual_seed(13), cfg)
    gen = torch.Generator().manual_seed(14)
    xs = {seq: torch.randn((2, seq, cfg.d_model), generator=gen)
          for seq in RWKV_SEQS + (1,)}
    h, hs = rwkv.num_heads(cfg), rwkv.head_size(cfg)
    s0 = 0.1 * torch.randn((2, h, hs, hs), generator=gen)
    return cfg, params, xs, s0


def _musicgen_setup():
    """musicgen at smoke width with 3 heads of 64 (d_model 192)."""
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.models import transformer
    cfg = dataclasses.replace(get_smoke_arch("musicgen-medium"),
                              d_model=192, num_heads=3, num_kv_heads=3)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(15),
                                     device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (DECODE_STEPS, 1),
                           generator=torch.Generator().manual_seed(16))
    return cfg, params, tokens


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _grads(params):
    return {key: _whole(leaf.grad) for key, leaf in params.items()
            if leaf.grad is not None}


def _moe_run(cfg, params, x, place=lambda t, kind, name=None: t):
    """{key: tensor}: moe.forward's outputs, aux and the router's and
    experts' gradients for each group size, and the dispatch's kept
    pairs."""
    from repro_torch.models import moe, pspec
    out = {}
    for gs in MOE_GROUPS:
        p = {k: place(v.clone().requires_grad_(), "param", k)
             for k, v in params.items()}
        y, aux = moe.forward(p, cfg, place(x, "batch"), group_size=gs)
        (y.sum() + aux).backward()
        out[f"gs{gs}/out"] = _whole(y)
        out[f"gs{gs}/aux"] = _whole(aux)
        for key, g in _grads(p).items():
            out[f"gs{gs}/grad/{key}"] = g
        with torch.no_grad():
            g = x.shape[0] * x.shape[1] // gs
            cap = moe._capacity(gs, cfg.num_experts, cfg.experts_per_token,
                                cfg.capacity_factor)
            xg = pspec.constrain(place(x, "batch").reshape(g, gs, -1),
                                 "batch", None, None)
            groups = (0, None, None)
            args = (xg, p["router"])
            res = pspec.map_shards(
                lambda xg, router: moe._dispatch(xg, router, cfg, cap), args,
                (groups, (None, None)),
                ((0, None, None, None), groups, groups, groups, groups,
                 (0,))) or moe._dispatch(*args, cfg, cap)
            out[f"gs{gs}/keep"] = _whole(res[4])
    return out


def _rwkv_run(cfg, params, xs, s0, place=lambda t, kind, name=None: t):
    """{key: tensor}: rwkv.forward's y and final state for each sequence
    length from no state, a decode step from the 16-token state and one
    from ``s0``, and the block params' gradients."""
    from repro_torch.models import rwkv
    out = {}
    p = {k: place(v.clone().requires_grad_(), "param", k)
         for k, v in params.items()}
    loss = 0.0
    state = None
    for seq in RWKV_SEQS:
        y, st = rwkv.forward(p, cfg, place(xs[seq], "batch"))
        loss = loss + y.sum() + st.s.sum()
        out[f"s{seq}/y"], out[f"s{seq}/state"] = _whole(y), _whole(st.s)
        state = st if seq == RWKV_SEQS[0] else state
    loss.backward()
    for key, g in _grads(p).items():
        out[f"grad/{key}"] = g
    with torch.no_grad():
        out.update(_wkv_run(cfg, params, xs[16], s0, place))
        x1 = place(xs[1], "batch")
        y, st = rwkv.decode_step(p, cfg, x1, state)
        out["decode/y"], out["decode/state"] = _whole(y), _whole(st.s)
        given = rwkv.RwkvState(s=place(s0, "state"),
                               x_prev=place(xs[1][:, 0], "batch"))
        y, st = rwkv.decode_step(p, cfg, x1, given)
        out["given/y"], out["given/state"] = _whole(y), _whole(st.s)
    return out


def _wkv_run(cfg, params, x, s0, place):
    """The wkv scan alone on the block's r/k/v/w of ``x`` (computed on
    plain tensors, then placed over batch and heads) from ``s0`` (placed
    over its batch and its last dim but one): on the shards as
    ``rwkv.forward`` runs it."""
    from repro_torch.models import pspec, rwkv
    h, hs = rwkv.num_heads(cfg), rwkv.head_size(cfg)
    b, seq, d = x.shape
    r, k, v, w, _ = rwkv._mix(params, x, rwkv._shift(x, x.new_zeros((b, d))))
    args = tuple(place(rwkv._heads(t, h, hs), "heads") for t in (r, k, v, w)) \
        + (place(params["bonus_u"].float(), "param", "bonus_u"),
           place(s0, "state"))
    layout, state = (0, None, 2, None), (0, 2, None, None)
    y, s = pspec.map_shards(rwkv._wkv, args, (layout,) * 4 + (
        (2, None), state), (layout, state)) or rwkv._wkv(*args)
    return {"wkv/y": _whole(y), "wkv/state": _whole(s)}


def _musicgen_run(cfg, params, tokens, place=lambda t, kind, name=None: t):
    """{key: tensor}: logits of DECODE_STEPS batch-1 decode steps from an
    empty cache, then the caches."""
    from repro_torch.core import flatten
    from repro_torch.launch import sharding
    from repro_torch.models import transformer
    p = sharding.tree_map_with_path(
        lambda path, leaf: place(leaf, "param", sharding._leaf_name(path)),
        params)
    state = transformer.init_decode(cfg, 1, DECODE_SLOTS, device="cpu")
    state = sharding.tree_map_with_path(
        lambda _, leaf: place(leaf, "cache"), state)
    out = {}
    with torch.no_grad():
        for t in range(DECODE_STEPS):
            logits, state = transformer.decode_step(p, cfg, state,
                                                    place(tokens[t], "batch"))
            out[f"logits{t}"] = _whole(logits)
    for path, leaf in flatten.leaves_with_paths(state):
        out["cache/" + "/".join(map(str, path))] = _whole(leaf)
    return out


def _placer(mesh, batch_ax, tp_ax):
    """``place(tensor, kind, name)``: a real DTensor of a tensor every rank
    holds whole. Params by the rules' tensor-parallel and FSDP choice at
    any size (1-D leaves whole), a batch over ``batch_ax`` when it
    divides, a decode cache by ``cache_spec``, an rwkv state (B, H, D, D)
    over its batch and its last dim but one, as ``cache_spec`` places the
    state stack, and heads (B, S, H, D) over batch and heads."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch import sharding
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))

    def spec(t, kind, name):
        shape = tuple(t.shape)
        if not shape:
            return []
        if kind == "param":
            return sharding._inner_spec(shape, name, tp_ax, sizes[tp_ax],
                                        batch_ax, sizes[batch_ax]) \
                if len(shape) >= 2 else [None]
        if kind == "cache":
            stand = SimpleNamespace(
                axis_names=("data", "model"),
                shape={"data": sizes[batch_ax], "model": sizes[tp_ax]})
            rename = {"data": batch_ax, "model": tp_ax}
            return [rename.get(e, e) for e in sharding.cache_spec(shape,
                                                                  stand)]
        out = [None] * len(shape)
        if shape[0] % sizes[batch_ax] == 0:
            out[0] = batch_ax
        if kind == "state":
            out[2] = tp_ax
        if kind == "heads" and shape[2] % sizes[tp_ax] == 0:
            out[2] = tp_ax
        return out

    def place(t, kind, name=None):
        placements = sharding.NamedSharding(
            mesh, sharding.P(*spec(t, kind, name))).placements
        d = distribute_tensor(t.detach(), mesh, placements,
                              src_data_rank=None)
        return d.requires_grad_(t.requires_grad)
    return place


def _worker(rank: int, store: str, out_dir: str) -> None:
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import pspec
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=RANKS)
    try:
        out = {}
        for name, (shape, names, batch_ax, tp_ax) in MESHES.items():
            mesh = DeviceMesh("cpu", torch.arange(RANKS).reshape(shape),
                              mesh_dim_names=names)
            place = _placer(mesh, batch_ax, tp_ax)
            with pspec.logical_rules(_rules(name)), implicit_replication():
                for part, run, setup in (("moe", _moe_run, _moe_setup),
                                         ("rwkv", _rwkv_run, _rwkv_setup),
                                         ("musicgen", _musicgen_run,
                                          _musicgen_setup)):
                    got = run(*setup(), place=place)
                    out.update({f"{name}/{part}/{key}": v.detach().numpy()
                                for key, v in got.items()})
        if rank == 0:
            np.savez(os.path.join(out_dir, "shards.npz"), **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def shard_run(tmp_path_factory):
    """One spawn of 4 gloo ranks for the module: rank 0's results."""
    import torch.multiprocessing as mp
    tmp_path = tmp_path_factory.mktemp("shards")
    mp.start_processes(_worker, args=(str(tmp_path / "store"),
                                      str(tmp_path)),
                       nprocs=RANKS, start_method="spawn")
    return dict(np.load(tmp_path / "shards.npz"))


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _check(got: dict, prefix: str, want: dict, scaled=()) -> None:
    """``got``'s ``prefix`` keys against ``want``: integers equal,
    gradients within GRAD_TOL of their leaf's max |value|, the rest within
    RTOL / ATOL, the keys that start with one of ``scaled`` within ATOL
    times their max |value| once that passes 1."""
    keys = {k[len(prefix):] for k in got if k.startswith(prefix)}
    assert keys == set(want), sorted(keys ^ set(want))
    for key, value in want.items():
        value = value.detach().numpy()
        if value.dtype.kind in "biu":
            np.testing.assert_array_equal(got[prefix + key], value,
                                          err_msg=prefix + key)
        elif key.startswith("grad/") or "/grad/" in key:
            # a gradient sums over every rank's rows: another f32 order
            np.testing.assert_allclose(
                got[prefix + key], value, rtol=0,
                atol=GRAD_TOL * np.abs(value).max(), err_msg=prefix + key)
        else:
            atol = ATOL * max(1.0, float(np.abs(value).max())) \
                if key.startswith(scaled) else ATOL
            np.testing.assert_allclose(got[prefix + key], value, rtol=RTOL,
                                       atol=atol, err_msg=prefix + key)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_moe_on_each_ranks_groups_equals_plain(shard_run, mesh, one_thread):
    want = _moe_run(*_moe_setup())
    for gs in MOE_GROUPS:
        # capacity 1.25 drops some (token, choice) pairs, not all
        keep = want[f"gs{gs}/keep"]
        assert 0 < int((~keep).sum()) < keep.numel()
    assert {k.split("/")[-1] for k in want if "/grad/" in k} == \
        {"router", "w_gate", "w_up", "w_down"}
    _check(shard_run, f"{mesh}/moe/", want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_rwkv_on_each_ranks_rows_and_heads_equals_plain(shard_run, mesh,
                                                        one_thread):
    want = _rwkv_run(*_rwkv_setup())
    assert "grad/bonus_u" in want and "grad/decay_b" in want
    # the block's y and state pass through row-parallel products (y @ wo,
    # the token-shift and decay LoRAs' second products), which sum over
    # the ranks in another f32 order: y reaches |31| here and moves by
    # 1.3e-5, the state |12.8| and 2.6e-6; the scan alone (wkv/) is held
    # to the fixed bound
    _check(shard_run, f"{mesh}/rwkv/", want,
           scaled=("s16/", "s5/", "decode/", "given/"))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_musicgen_batch1_decode_with_uneven_heads_equals_plain(
        shard_run, mesh, one_thread):
    cfg, params, tokens = _musicgen_setup()
    assert cfg.num_heads % 2 and cfg.num_kv_heads % 2     # 3 over 2 ranks
    _check(shard_run, f"{mesh}/musicgen/", _musicgen_run(cfg, params,
                                                         tokens))
