"""The vehicular fleet path of the port against the JAX package:
``build_trainer -> init -> run_rounds`` on the paper MLP at full width
with the sparse and hierarchical formats and with mobility, from the same
initial params and batch indices, for 3 rounds at f32 within 1e-5 (the
bf16 wire over 2 rounds within 1e-4, as in tests/test_torch_cdfl.py).
Both sides run on the CPU, the port through its plain kernel versions.
Also: the per-round stacks each trainer builds agree, a caller's stacks
carry across through ``repro_torch.convert``, and 2 + 2 segmented rounds
equal 4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig, HierarchyConfig, MobilityConfig
from repro.configs.base import TrainConfig
from repro.configs.paper_models import MLP_CONFIG
from repro.core.cdfl import build_trainer
from repro.data import pipeline, redundancy, synthetic
from repro.hierarchy.mixing import HierEta
from repro.models import simple
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs.paper_models import MLP_CONFIG as T_MLP_CONFIG
from repro_torch.core import cdfl as tcdfl
from repro_torch.core import flatten as tflat
from repro_torch.core import topology as ttopo
from repro_torch.hierarchy.mixing import HierEta as THierEta
from repro_torch.models import simple as tsimple

S, B, N = 2, 8, 64
TOL = 1e-5
TOL_BF16 = 1e-4          # see tests/test_torch_cdfl.py: bf16 ulp drift
# benchmarks/paper_tables.py MOBILITY_SCENARIOS["manhattan"]
MANHATTAN = dict(kind="manhattan", speed=10.0, radio_range=500.0,
                 area=800.0, dt=2.0, seed=0)
# examples/mobility_platoon.py
PLATOON = dict(kind="platoon", speed=25.0, speed_jitter=0.4,
               radio_range=300.0, dt=5.0, seed=3, link_quality="quadratic")

CASES = {
    "sparse-ring": (16, dict(mixing_format="sparse", degree=4), 3, TOL),
    "sparse-manhattan": (16, dict(mixing_format="sparse", degree=5,
                                  mobility=MANHATTAN), 3, TOL),
    "hier-manhattan": (16, dict(mixing_format="hierarchical",
                                hierarchy=dict(max_cluster_size=4),
                                mobility=MANHATTAN), 3, TOL),
    "dense-platoon": (8, dict(mobility=PLATOON), 3, TOL),
    "sparse-manhattan-cfa-bf16": (16, dict(
        algorithm="cfa", mixing_format="sparse", degree=5,
        mobility=MANHATTAN, wire_dtype="bf16", simulate_wire=True), 2,
        TOL_BF16),
    "hier-static-metropolis": (16, dict(
        algorithm="metropolis", topology="erdos", mixing_format="hierarchical",
        hierarchy=dict(max_cluster_size=5, leader_policy="centrality")), 3,
        TOL),
}
_DATA = {}


def _data(k):
    if k not in _DATA:
        nodes = [redundancy.inject_duplicates(
            synthetic.synthetic_mnist(seed=i, n=N, noise=2.0),
            [0.1, 0.3, 0.5, 0.8][i % 4], seed=i) for i in range(k)]
        data = {"x": np.stack([d.x for d in nodes]),
                "y": np.stack([d.y for d in nodes])}
        items = pipeline.FederatedBatcher(nodes, B, S, seed=0).node_items()
        _DATA[k] = data, items
    return _DATA[k]


def _configs(k, kw):
    """The same FedConfig in both packages (sub-configs from dicts)."""
    kw = dict(kw, num_nodes=k, gamma=0.5, local_steps=S)
    jkw, tkw = dict(kw), {n: v for n, v in kw.items()
                          if n != "simulate_wire"}
    for name, jcls, tcls in (("mobility", MobilityConfig,
                              tbase.MobilityConfig),
                             ("hierarchy", HierarchyConfig,
                              tbase.HierarchyConfig)):
        if name in kw:
            jkw[name], tkw[name] = jcls(**kw[name]), tcls(**kw[name])
    return FedConfig(**jkw), tbase.FedConfig(**tkw)


def _jax_run(fed, k, rounds):
    data, items = _data(k)
    train = TrainConfig(learning_rate=1e-3, batch_size=B)
    loss = simple.make_mlp_loss(MLP_CONFIG)
    tr = build_trainer(lambda p, b: loss(p, b), fed, train)
    state = tr.init(jax.random.PRNGKey(0),
                    lambda r: simple.mlp_init(r, MLP_CONFIG),
                    jnp.asarray(items))
    init = {n: np.array(v) for n, v in state.params.items()}
    stacks = tr.mixing_stack(state, rounds)
    rng = jax.random.PRNGKey(train.seed + 1)
    keys = jax.vmap(lambda r: jax.random.fold_in(rng, r))(jnp.arange(rounds))
    idx = np.array(jax.vmap(lambda kk: jax.random.randint(
        kk, (k, S, B), 0, N))(keys))
    final, metrics = tr.run_rounds(
        state, {n: jnp.asarray(v) for n, v in data.items()}, rounds, rng=rng)
    return init, idx, stacks, final, metrics


def _port_trainer(tfed, k, init):
    _, items = _data(k)
    train = tbase.TrainConfig(learning_rate=1e-3, batch_size=B)
    tr = tcdfl.build_trainer(tsimple.make_mlp_loss(T_MLP_CONFIG), tfed, train,
                             device="cpu")
    buf, layout = convert.params_from_numpy(init, "cpu")
    return tr, tr.init(tflat.unflatten(buf, layout), items, same_init=False)


def _to_port_stack(stack):
    if isinstance(stack, HierEta):
        return convert.hier_eta_from_numpy(stack, "cpu")
    if hasattr(stack, "idx"):
        return convert.sparse_eta_from_numpy(stack, "cpu")
    return torch.tensor(np.asarray(stack))


def _assert_stacks_close(got, want):
    if isinstance(got, torch.Tensor):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)
        return
    for g, w in zip(got, want):
        if isinstance(g, tuple):
            _assert_stacks_close(g, w)
        elif g.dtype in (torch.int32, torch.int64):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                       rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fleet_path_matches_reference(case):
    k, kw, rounds, tol = CASES[case]
    jfed, tfed = _configs(k, kw)
    init, idx, (jetas, jgammas), final, metrics = _jax_run(jfed, k, rounds)
    tr, state = _port_trainer(tfed, k, init)
    etas, gammas = tr.mixing_stack(state, rounds)
    _assert_stacks_close(etas, jetas)
    np.testing.assert_allclose(gammas.numpy(), np.asarray(jgammas),
                               atol=1e-6, rtol=0)
    data, _ = _data(k)
    tfinal, tmetrics = tr.run_rounds(state, data, rounds, idx=idx)
    want, _ = convert.params_from_numpy(
        {n: np.asarray(v) for n, v in final.params.items()}, "cpu")
    np.testing.assert_allclose(tfinal.buf.numpy(), want.numpy(), atol=tol,
                               rtol=0)
    ref = convert.state_from_numpy(final, "cpu")
    np.testing.assert_allclose(tfinal.opt.m.numpy(), ref.opt.m.numpy(),
                               atol=tol, rtol=0)
    assert tfinal.round == int(final.round) == rounds
    names = ["loss", "disagreement", "gamma"]
    if jfed.mixing_format == "hierarchical":
        names += ["gamma_intra", "clusters"]
    assert sorted(tmetrics) == sorted(names)
    for name in names:
        np.testing.assert_allclose(tmetrics[name].numpy(),
                                   np.asarray(metrics[name]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    # the reference's own stacks, handed over, drive the same run
    xfinal, _ = tr.run_rounds(state, data, rounds, idx=idx,
                              eta_stack=_to_port_stack(jetas),
                              gamma_stack=np.array(jgammas))
    np.testing.assert_allclose(xfinal.buf.numpy(), tfinal.buf.numpy(),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", ["hier-manhattan", "sparse-manhattan"])
def test_segmented_rounds_equal_one_run(case):
    """Traces, clusters and hysteresis are keyed on the absolute round:
    rounds 0-1 then 2-3 equal rounds 0-3 exactly."""
    k, kw, _, _ = CASES[case]
    _, tfed = _configs(k, kw)
    rng = np.random.default_rng(1)
    init = {n: rng.standard_normal((k,) + tuple(v.shape)).astype(np.float32)
            * 0.1 for n, v in tsimple.mlp_init(
                torch.Generator().manual_seed(0), T_MLP_CONFIG,
                device="cpu").items()}
    idx = rng.integers(0, N, size=(4, k, S, B))
    data, _ = _data(k)
    tr, state = _port_trainer(tfed, k, init)
    whole, mw = tr.run_rounds(state, data, 4, idx=idx)
    half, m1 = tr.run_rounds(state, data, 2, idx=idx[:2])
    assert half.round == 2
    rest, m2 = tr.run_rounds(half, data, 2, idx=idx[2:])
    assert torch.equal(rest.buf, whole.buf)
    for name in mw:
        assert torch.equal(torch.cat([m1[name], m2[name]]), mw[name]), name


def test_run_rounds_checks_the_stacks():
    k, kw, _, _ = CASES["sparse-ring"]
    _, tfed = _configs(k, kw)
    init = {n: np.zeros((k,) + tuple(v.shape), np.float32)
            for n, v in tsimple.mlp_init(torch.Generator(), T_MLP_CONFIG,
                                         device="cpu").items()}
    data, _ = _data(k)
    tr, state = _port_trainer(tfed, k, init)
    idx = np.zeros((2, k, S, B), np.int64)
    etas, gammas = tr.mixing_stack(state, 3)
    with pytest.raises(ValueError, match="sparse eta stack shapes"):
        tr.run_rounds(state, data, 2, idx=idx, eta_stack=etas)
    bad = ttopo.SparseEta(etas.idx[:2] + k, etas.val[:2])
    with pytest.raises(ValueError, match="indices must lie"):
        tr.run_rounds(state, data, 2, idx=idx, eta_stack=bad)
    with pytest.raises(ValueError, match="gamma stack shape"):
        tr.run_rounds(state, data, 2, idx=idx, gamma_stack=gammas)
    # a dense stack is the dense format's: it runs under any format
    dense = ttopo.densify_eta(ttopo.SparseEta(etas.idx[:2], etas.val[:2]), k)
    out, metrics = tr.run_rounds(state, data, 2, idx=idx, eta_stack=dense)
    assert torch.isfinite(out.buf).all() and metrics["gamma"].shape == (2,)
    _, hfed = _configs(k, CASES["hier-manhattan"][1])
    hier, hstate = _port_trainer(hfed, k, init)
    with pytest.raises(ValueError, match="needs a HierEta"):
        hier.run_rounds(hstate, data, 2, idx=idx, eta_stack=dense)
    hetas, _ = hier.mixing_stack(hstate, 2)
    assert isinstance(hetas, THierEta)
    with pytest.raises(ValueError, match="needs mixing_format"):
        tr.run_rounds(state, data, 2, idx=idx, eta_stack=hetas)


def test_fedavg_refuses_mobility():
    _, tfed = _configs(8, dict(algorithm="fedavg", mobility=PLATOON))
    with pytest.raises(ValueError, match="mobility requires"):
        tcdfl.build_trainer(tsimple.make_mlp_loss(T_MLP_CONFIG), tfed,
                            tbase.TrainConfig(), device="cpu")
