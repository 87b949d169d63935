"""The port's C-DFL slice against the JAX package: build_trainer -> init ->
run_rounds for 10 rounds x 10 local steps at K=4 on the paper MLP, from
the same initial params and the same batch indices, for every ported
algorithm, plus a bf16-wire case. Both sides run on the CPU; the port
through its plain kernel versions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig, TrainConfig
from repro.configs.paper_models import MLP_CONFIG
from repro.core.cdfl import build_trainer
from repro.data import pipeline, redundancy, synthetic
from repro.models import simple
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs.paper_models import MLP_CONFIG as T_MLP_CONFIG
from repro_torch.core import cdfl as tcdfl
from repro_torch.core import flatten as tflat
from repro_torch.models import simple as tsimple


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The port's tensors here are a few nodes' small MLPs: one intra-op
    thread, so that the spinning threads of a machine loaded by several
    pytest-xdist workers do not dominate (an op on such a tensor took
    milliseconds there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


K, S, B = 4, 10, 32
# Params and moments after 100 Adam steps agree to this bound, the one
# tests/test_cdfl.py holds between the JAX package's own lowerings
# (measured: 1.8e-6 at most over the four f32 cases).
TOL = 1e-5
# A bf16 wire turns f32 summation-order noise (1e-7) into whole bf16
# rounding steps wherever a value sits next to a rounding boundary, so
# the two packages drift apart one bf16 ulp at a time: measured max
# |param diff| 3.4e-6 after 1 round, 1.5e-5 after 2, 1.2e-4 after 3 and
# 2.4e-4 (on 0.7% of the values) after 10, while the losses agree to
# 1e-6 throughout. The bf16 case therefore runs 2 rounds at 1e-4.
TOL_BF16 = 1e-4


def _nodes():
    return [redundancy.inject_duplicates(
        synthetic.synthetic_mnist(seed=i, n=320, noise=2.0), ratio, seed=i)
        for i, ratio in enumerate([0.1, 0.3, 0.5, 0.8])]


@pytest.fixture(scope="module")
def paper_data():
    nodes = _nodes()
    data = {"x": np.stack([d.x for d in nodes]),
            "y": np.stack([d.y for d in nodes])}
    items = pipeline.FederatedBatcher(nodes, B, S, seed=0).node_items()
    return data, items


def _jax_run(fed_kw, data, items, R):
    fed = FedConfig(num_nodes=K, topology="ring", gamma=0.5, local_steps=S,
                    **fed_kw)
    train = TrainConfig(learning_rate=1e-3, batch_size=B)
    loss = simple.make_mlp_loss(MLP_CONFIG)
    tr = build_trainer(lambda p, b: loss(p, b), fed, train)
    state = tr.init(jax.random.PRNGKey(0),
                    lambda r: simple.mlp_init(r, MLP_CONFIG),
                    jnp.asarray(items))
    init = {n: np.array(v) for n, v in state.params.items()}
    ratios = np.asarray(state.ratios)
    rng = jax.random.PRNGKey(train.seed + 1)
    # the index stack run_rounds samples: per-round keys folded on the
    # absolute round index, randint over the resident item count
    keys = jax.vmap(lambda r: jax.random.fold_in(rng, r))(jnp.arange(R))
    idx = np.array(jax.vmap(lambda k: jax.random.randint(
        k, (K, S, B), 0, data["x"].shape[1]))(keys))
    final, metrics = tr.run_rounds(
        state, {n: jnp.asarray(v) for n, v in data.items()}, R, rng=rng)
    return init, ratios, idx, final, metrics


def _port_run(fed_kw, data, items, init, idx, R):
    fed_kw = {n: v for n, v in fed_kw.items() if n != "simulate_wire"}
    fed = tbase.FedConfig(num_nodes=K, topology="ring", gamma=0.5,
                          local_steps=S, **fed_kw)
    train = tbase.TrainConfig(learning_rate=1e-3, batch_size=B)
    tr = tcdfl.build_trainer(tsimple.make_mlp_loss(T_MLP_CONFIG), fed, train,
                             device="cpu")
    buf, layout = convert.params_from_numpy(init, "cpu")
    state = tr.init(tflat.unflatten(buf, layout), items, same_init=False)
    return state, *tr.run_rounds(state, data, R, idx=idx)


@pytest.mark.parametrize("fed_kw,R,tol", [
    ({"algorithm": "cdfl"}, 10, TOL),
    ({"algorithm": "cfa"}, 10, TOL),
    ({"algorithm": "metropolis"}, 10, TOL),
    ({"algorithm": "fedavg"}, 10, TOL),
    # the JAX package skips the bf16 cast on its CPU backend unless asked
    ({"algorithm": "cdfl", "wire_dtype": "bf16", "simulate_wire": True}, 2,
     TOL_BF16),
], ids=["cdfl", "cfa", "metropolis", "fedavg", "cdfl-bf16"])
def test_slice_matches_reference(paper_data, fed_kw, R, tol):
    data, items = paper_data
    init, ratios, idx, final, metrics = _jax_run(fed_kw, data, items, R)
    state0, tfinal, tmetrics = _port_run(fed_kw, data, items, init, idx, R)

    np.testing.assert_array_equal(state0.ratios.numpy(), ratios)
    buf, layout = convert.params_from_numpy(
        {n: np.asarray(v) for n, v in final.params.items()}, "cpu")
    assert layout == tfinal.layout
    np.testing.assert_allclose(tfinal.buf.numpy(), buf.numpy(), atol=tol,
                               rtol=0)
    ref = convert.state_from_numpy(final, "cpu")
    np.testing.assert_array_equal(tfinal.opt.step.numpy(),
                                  ref.opt.step.numpy())
    np.testing.assert_allclose(tfinal.opt.m.numpy(), ref.opt.m.numpy(),
                               atol=tol, rtol=0)
    np.testing.assert_allclose(tfinal.opt.v.numpy(), ref.opt.v.numpy(),
                               atol=tol, rtol=0)
    assert tfinal.round == int(final.round) == R
    for name in ("loss", "disagreement", "gamma"):
        np.testing.assert_allclose(tmetrics[name].numpy(),
                                   np.asarray(metrics[name]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_state_from_numpy_roundtrip(paper_data):
    """A JAX init state carries across exactly: params, ratios, sizes,
    round and the zero moments."""
    data, items = paper_data
    fed = FedConfig(num_nodes=K, local_steps=2)
    loss = simple.make_mlp_loss(MLP_CONFIG)
    tr = build_trainer(lambda p, b: loss(p, b), fed, TrainConfig())
    state = tr.init(jax.random.PRNGKey(3),
                    lambda r: simple.mlp_init(r, MLP_CONFIG),
                    jnp.asarray(items), same_init=False)
    ported = convert.state_from_numpy(state, "cpu")
    assert ported.layout.padded == 23_936 and ported.layout.total == 23_860
    for name, leaf in state.params.items():
        np.testing.assert_array_equal(ported.params[name].numpy(),
                                      np.asarray(leaf))
    np.testing.assert_array_equal(ported.ratios.numpy(),
                                  np.asarray(state.ratios))
    np.testing.assert_array_equal(ported.sizes.numpy(),
                                  np.asarray(state.sizes))
    assert ported.round == 0
    assert not ported.opt.m.any() and not ported.opt.v.any()


def test_port_trainer_standalone_sampler_trains(paper_data):
    """Without an index stack the trainer samples from its own
    torch.Generator: reproducible per seed, and the loss falls."""
    data, items = paper_data
    fed = tbase.FedConfig(num_nodes=K, local_steps=5)
    train = tbase.TrainConfig(learning_rate=1e-3, batch_size=B)
    tr = tcdfl.build_trainer(tsimple.make_mlp_loss(T_MLP_CONFIG), fed, train,
                             device="cpu")
    p0 = tsimple.mlp_init(torch.Generator().manual_seed(0), T_MLP_CONFIG,
                          device="cpu")
    state = tr.init(p0, items)
    a, ma = tr.run_rounds(state, data, 6)
    b, mb = tr.run_rounds(state, data, 6)
    assert torch.equal(a.buf, b.buf)
    loss = ma["loss"].mean(dim=1)
    assert torch.isfinite(loss).all() and loss[-1] < loss[0]
    assert (ma["disagreement"] >= 0).all()
    assert a.round == 6 and state.round == 0
