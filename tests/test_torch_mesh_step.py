"""The port's federated mesh train step (``launch/steps.py``:
``ring_consensus_roll``, ``make_fed_train_step``) against the JAX
package's, on the CPU in f32, for the smoke qwen3-1.7b: F=2 nodes, and F=3
with a cosine learning rate read at each node's own step (the nodes start
at steps 0, 1 and 3) and ``grad_clip`` with one node's gradient far above
the clip and the others' below it, so that only a per-node norm gives the
reference's result.

Same params (drawn by the port's ``init_params``, one generator a node,
and carried to the reference as numpy arrays), the same token batches, 2
steps; the port's state comes from the reference's through
``convert.mesh_state_from_numpy``. The reference's step runs jitted under
a one-device ``("fed", "dp", "tp")`` mesh, where every sharding constraint
drops out. Tolerances: losses 1e-5 relative; params, m and v within 1e-5
of the max |value| of their tree (an element where Adam's eps meets a
near-zero gradient amplifies f32 summation noise, ROADMAP C); the step
counters equal. ``ring_consensus_roll`` alone: f32 within 1e-6, bf16
within 2 bf16 ulps. The other families are in
``test_torch_mesh_step_families.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs.registry import get_arch as jget_arch
from repro.launch import steps as jsteps
from repro.optim import AdamState as JAdamState
from repro.optim import schedules as jschedules
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import get_arch
from repro_torch.core import flatten
from repro_torch.launch import steps
from repro_torch.models import transformer
from repro_torch.optim import global_norm
from repro_torch.optim import schedules as tschedules

B, S, STEPS, LR = 2, 16, 2, 3e-4
TOL = 1e-5


def smoke_cfgs(arch: str, pattern=None):
    """The reference's and the port's reduced f32 config of ``arch``
    (d_model 128, d_ff 256, vocab 256, 2 layers), with ``pattern`` as the
    block pattern where given."""
    out = []
    for get, red in ((jget_arch, jbase.reduced), (get_arch, tbase.reduced)):
        cfg = red(get(arch), d_model=128, d_ff=256, vocab=256)
        if pattern is not None:
            cfg = dataclasses.replace(cfg, block_pattern=pattern)
        out.append(cfg)
    return out


def node_params(tcfg, f: int) -> dict:
    """F nodes' params as numpy arrays stacked on a leading F axis (the
    port's init, generator seeded with the node's index)."""
    nodes = [flatten.leaves_with_paths(transformer.init_params(
        tcfg, torch.Generator().manual_seed(k), device="cpu"))
        for k in range(f)]
    return flatten.build_tree(
        [path for path, _ in nodes[0]],
        [np.stack([node[j][1].numpy() for node in nodes])
         for j in range(len(nodes[0]))])


def batches(cfg, f: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        b = {name: rng.integers(0, cfg.vocab_size, (f, B, S)).astype(np.int32)
             for name in ("tokens", "labels")}
        if cfg.modality == "vision":
            b["embeds"] = (0.02 * rng.normal(
                size=(f, B, cfg.num_patches, cfg.d_model))).astype(np.float32)
        out.append(b)
    return out


def run_reference(jcfg, params, ratios, step0, data, train: dict):
    """The reference's state at the start, and after STEPS steps with the
    loss of each."""
    jparams = jax.tree.map(jnp.asarray, params)
    zeros = jax.tree.map(lambda l: jnp.zeros(l.shape, jnp.float32), jparams)
    start = jsteps.MeshFedState(
        jparams, JAdamState(jnp.asarray(step0, jnp.int32), zeros, zeros),
        jnp.asarray(ratios, jnp.float32))
    fed = jbase.FedConfig(num_nodes=len(ratios))
    step = jax.jit(jsteps.make_fed_train_step(jcfg, fed,
                                              jbase.TrainConfig(**train)))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                             ("fed", "dp", "tp"))
    state, losses = start, []
    with mesh:
        for b in data:
            state, loss = step(state, {k: jnp.asarray(v)
                                       for k, v in b.items()})
            losses.append(float(loss))
    return start, state, losses


def run_port(tcfg, start, data, train: dict):
    state = convert.mesh_state_from_numpy(start, "cpu")
    fed = tbase.FedConfig(num_nodes=int(state.ratios.shape[0]))
    step = steps.make_fed_train_step(tcfg, fed, tbase.TrainConfig(**train))
    losses = []
    for b in data:
        state, loss = step(state, {k: torch.tensor(v) for k, v in b.items()})
        assert loss.dtype == torch.float32 and loss.dim() == 0
        losses.append(loss.item())
    return state, losses


def assert_state_matches(got, want, got_losses, want_losses):
    np.testing.assert_allclose(got_losses, want_losses, rtol=TOL)
    np.testing.assert_array_equal(got.opt.step.numpy(),
                                  np.asarray(want.opt.step))
    np.testing.assert_array_equal(got.ratios.numpy(), np.asarray(want.ratios))
    for what, g_tree, w_tree in (("params", got.params, want.params),
                                 ("m", got.opt.m, want.opt.m),
                                 ("v", got.opt.v, want.opt.v)):
        g_pairs = flatten.leaves_with_paths(g_tree)
        w_pairs = flatten.leaves_with_paths(
            jax.tree.map(np.asarray, w_tree))
        assert [p for p, _ in g_pairs] == [p for p, _ in w_pairs]
        scale = max(np.abs(w).max() for _, w in w_pairs)
        for (path, g), (_, w) in zip(g_pairs, w_pairs):
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
            err = np.abs(g.numpy() - w).max()
            assert err <= TOL * scale, (what, path, err, scale)


# --- qwen3: F=2, and F=3 with per-node clipping and a scheduled rate --------

CLIP = 8.0
HUGE_NODE = 1
SCHEDULE = (LR, 1, 6)        # cosine(peak, warmup, total)


def _case(name: str) -> dict:
    jcfg, tcfg = smoke_cfgs("qwen3-1.7b")
    if name == "F=2":
        f, ratios, step0 = 2, [0.4, 0.8], [0, 0]
        jtrain = ttrain = dict(learning_rate=LR, remat="none")
        params = node_params(tcfg, f)
    else:
        # node 1's final norm scaled 300x; its neighbors' eta toward it
        # (r_1 / (r_1 + r_other)) is about 1e-6, so only its own phi, and
        # so its own gradient, is huge
        f, ratios, step0 = 3, [0.5, 1e-6, 0.5], [0, 1, 3]
        params = node_params(tcfg, f)
        params["final_norm"]["scale"][HUGE_NODE] *= 300.0
        common = dict(grad_clip=CLIP, remat="full")
        jtrain = dict(common, learning_rate=jschedules.cosine(*SCHEDULE))
        ttrain = dict(common, learning_rate=tschedules.cosine(*SCHEDULE))
    data = batches(jcfg, f)
    start, want, want_losses = run_reference(jcfg, params, ratios, step0,
                                             data, jtrain)
    return dict(tcfg=tcfg, start=start, want=want, want_losses=want_losses,
                data=data, ttrain=ttrain)


@pytest.fixture(scope="module")
def cases() -> dict:
    """The reference's runs, each made once for the module."""
    return {}


def _get(cases: dict, name: str) -> dict:
    if name not in cases:
        cases[name] = _case(name)
    return cases[name]


@pytest.mark.parametrize("name", ["F=2", "F=3 clip+cosine"])
def test_fed_train_step_matches_reference(cases, name):
    c = _get(cases, name)
    got, losses = run_port(c["tcfg"], c["start"], c["data"], c["ttrain"])
    assert_state_matches(got, c["want"], losses, c["want_losses"])


def test_clip_case_has_one_node_above_the_clip(cases):
    """The clip case means something: at the first step's phi only node 1's
    gradient norm exceeds ``CLIP``, so a norm over the stack would clip
    every node and a missing clip would move node 1's moments."""
    c = _get(cases, "F=3 clip+cosine")
    state = convert.mesh_state_from_numpy(c["start"], "cpu")
    phi = steps.ring_consensus_roll(state.params, state.ratios, 0.5)
    pairs = flatten.leaves_with_paths(phi)
    norms = []
    for k in range(state.ratios.shape[0]):
        own = [leaf[k].detach().requires_grad_() for _, leaf in pairs]
        loss = transformer.loss_fn(
            flatten.build_tree([p for p, _ in pairs], own), c["tcfg"],
            {n: torch.tensor(v[k]) for n, v in c["data"][0].items()})
        norms.append(global_norm(list(torch.autograd.grad(loss, own))).item())
    assert norms[HUGE_NODE] > 10 * CLIP, norms
    assert all(n < CLIP for k, n in enumerate(norms) if k != HUGE_NODE), norms


# --- ring_consensus_roll alone ------------------------------------------------

def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("f", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_consensus_roll_matches_reference(f, dtype):
    rng = np.random.default_rng(f)
    tree = {"a": rng.normal(size=(f, 7, 5)),
            "b": [rng.normal(size=(f, 33)), rng.normal(size=(f, 2, 3, 4))]}
    ratios = rng.uniform(0.05, 1.0, f).astype(np.float32)
    jtree = jax.tree.map(lambda x: jnp.asarray(x, getattr(jnp, dtype)), tree)
    want = jax.tree.map(np.asarray, jax.jit(
        jsteps.ring_consensus_roll, static_argnums=2)(
            jtree, jnp.asarray(ratios), 0.5))
    ttree = convert.transformer_params_from_numpy(
        jax.tree.map(np.asarray, jtree), "cpu")
    got = steps.ring_consensus_roll(ttree, torch.tensor(ratios), 0.5)
    for (path, g), (_, w) in zip(flatten.leaves_with_paths(got),
                                 flatten.leaves_with_paths(want)):
        assert g.dtype == getattr(torch, dtype) and tuple(g.shape) == w.shape
        g32, w32 = g.float().numpy(), np.asarray(w, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(g32, w32, rtol=1e-6, atol=1e-6)
        else:
            assert (np.abs(g32 - w32) <= 2 * _bf16_ulp(w32)).all(), path


def test_ring_consensus_roll_keeps_identical_nodes():
    """Equal nodes are a fixed point of eq. 5 for any ratios."""
    leaf = torch.randn(4, 5).expand(3, 4, 5).clone()
    out = steps.ring_consensus_roll({"w": leaf}, torch.tensor([0.1, 0.5, 1.0]),
                                    0.5)
    torch.testing.assert_close(out["w"], leaf, rtol=0, atol=0)
