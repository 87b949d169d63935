"""dpsgd and C-DFA(M) through the port's trainer against the JAX package,
plus ragged sampling (``n_items``), ``cnd_dedup`` and the paper's
Tables 1-4 MLP setup (benchmarks/paper_tables.py:24-140) for all four
algorithms.

``build_trainer -> init -> run_rounds`` on the paper MLP at full width,
from the same initial params and batch indices, for 3 rounds within 1e-5
(a bf16 wire within 1e-4; the JAX side then sets ``simulate_wire``, as
the port always casts). Both sides run on the CPU, the port through its
plain kernel versions. The data is the fleet tests' recipe (duplicates
injected), for the Adam-eps reason in ROADMAP queue C."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FaultConfig, FedConfig, HierarchyConfig
from repro.configs.base import MobilityConfig, TrainConfig
from repro.configs.paper_models import MLP_CONFIG
from repro.core.cdfl import build_trainer
from repro.data import pipeline, redundancy, synthetic
from repro.models import simple
from repro_torch import convert, registry
from repro_torch.configs import base as tbase
from repro_torch.configs.paper_models import MLP_CONFIG as T_MLP_CONFIG
from repro_torch.core import baselines as tbaselines
from repro_torch.core import cdfl as tcdfl
from repro_torch.core import flatten as tflat
from repro_torch.data import pipeline as tpipeline
from repro_torch.data import redundancy as tredundancy
from repro_torch.data import synthetic as tsynthetic
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


S, B, N = 2, 8, 64
TOL = 1e-5
TOL_BF16 = 1e-4          # see tests/test_torch_cdfl.py: bf16 ulp drift
# benchmarks/paper_tables.py MOBILITY_SCENARIOS["manhattan"]
MANHATTAN = dict(kind="manhattan", speed=10.0, radio_range=500.0,
                 area=800.0, dt=2.0, seed=0)
# examples/mobility_platoon.py
PLATOON = dict(kind="platoon", speed=25.0, speed_jitter=0.4,
               radio_range=300.0, dt=5.0, seed=3, link_quality="quadratic")

# name -> (K, FedConfig keywords, rounds, tolerance)
CASES = {
    "dpsgd-dense-ring": (6, dict(algorithm="dpsgd"), 3, TOL),
    "dpsgd-sparse": (8, dict(algorithm="dpsgd", topology="full",
                             mixing_format="sparse", degree=2), 3, TOL),
    "dpsgd-hier-manhattan": (16, dict(
        algorithm="dpsgd", mixing_format="hierarchical",
        hierarchy=dict(max_cluster_size=4), mobility=MANHATTAN), 3, TOL),
    "dpsgd-platoon": (8, dict(algorithm="dpsgd", mobility=PLATOON), 3, TOL),
    "cdfa_m-0.5": (6, dict(algorithm="cdfa_m", cdfa_fraction=0.5), 3, TOL),
    "cdfa_m-1.0": (6, dict(algorithm="cdfa_m", cdfa_fraction=1.0), 3, TOL),
    "cdfa_m-0.5-bf16": (6, dict(algorithm="cdfa_m", cdfa_fraction=0.5,
                                wire_dtype="bf16", simulate_wire=True), 3,
                        TOL_BF16),
    "cdfa_m-1.0-bf16": (6, dict(algorithm="cdfa_m", cdfa_fraction=1.0,
                                wire_dtype="bf16", simulate_wire=True), 3,
                        TOL_BF16),
    "cdfa_m-sparse-manhattan": (16, dict(
        algorithm="cdfa_m", cdfa_fraction=0.75, mixing_format="sparse",
        degree=5, mobility=MANHATTAN), 3, TOL),
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
def test_baseline_path_matches_reference(case):
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
    ref = convert.state_from_numpy(final, "cpu")
    np.testing.assert_allclose(tfinal.buf.numpy(), ref.buf.numpy(), atol=tol,
                               rtol=0)
    np.testing.assert_allclose(tfinal.opt.m.numpy(), ref.opt.m.numpy(),
                               atol=tol, rtol=0)
    np.testing.assert_array_equal(tfinal.opt.step.numpy(),
                                  ref.opt.step.numpy())
    assert tfinal.round == int(final.round) == rounds
    names = ["loss", "disagreement", "gamma"]
    if jfed.mixing_format == "hierarchical":
        names += ["gamma_intra", "clusters"]
    assert sorted(tmetrics) == sorted(names)
    for name in names:
        np.testing.assert_allclose(tmetrics[name].numpy(),
                                   np.asarray(metrics[name]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_dpsgd_loss_is_broadcast_and_adam_counts_every_step():
    """dpsgd's ``loss`` is the mean over nodes and steps, the same for
    every node; its Adam step counts rounds x local_steps."""
    k, kw, _, _ = CASES["dpsgd-dense-ring"]
    _, tfed = _configs(k, kw)
    rng = np.random.default_rng(4)
    init = {n: np.broadcast_to(v.numpy(), (k,) + tuple(v.shape)).copy()
            for n, v in tsimple.mlp_init(torch.Generator().manual_seed(1),
                                         T_MLP_CONFIG, device="cpu").items()}
    idx = rng.integers(0, N, size=(3, k, S, B))
    tr, state = _port_trainer(tfed, k, init)
    final, metrics = tr.run_rounds(state, _data(k)[0], 3, idx=idx)
    loss = metrics["loss"]
    assert tuple(loss.shape) == (3, k)
    assert torch.equal(loss, loss[:, :1].expand(3, k))
    assert final.opt.step.tolist() == [3 * S] * k
    # from one shared init a single step's gossip is the identity, so one
    # step of dpsgd is one step of cdfl, whose per-node losses average to
    # dpsgd's loss
    one = dataclasses.replace(tfed, local_steps=1)
    runs = {}
    for alg in ("dpsgd", "cdfl"):
        tr1, st1 = _port_trainer(dataclasses.replace(one, algorithm=alg), k,
                                 init)
        runs[alg] = tr1.run_rounds(st1, _data(k)[0], 1, idx=idx[:1, :, :1])
    assert torch.equal(runs["dpsgd"][0].buf, runs["cdfl"][0].buf)
    np.testing.assert_allclose(
        runs["dpsgd"][1]["loss"].numpy(),
        np.full((1, k), float(runs["cdfl"][1]["loss"].mean())), rtol=1e-6)


@pytest.mark.parametrize("case", ["dpsgd-hier-manhattan", "dpsgd-platoon",
                                  "cdfa_m-sparse-manhattan"])
def test_segmented_rounds_equal_one_run(case):
    """Stacks are keyed on the absolute round: rounds 0-1 then 2-3 equal
    rounds 0-3 exactly."""
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
    rest, m2 = tr.run_rounds(half, data, 2, idx=idx[2:])
    assert torch.equal(rest.buf, whole.buf)
    assert torch.equal(rest.opt.step, whole.opt.step)
    for name in mw:
        assert torch.equal(torch.cat([m1[name], m2[name]]), mw[name]), name


def test_cdfa_m_leaves_the_tail_to_local_steps():
    """With no local progress (lr 0) a C-DFA(M) round mixes only the leaf
    prefix: the columns past it stay as they were."""
    k = 4
    tfed = tbase.FedConfig(num_nodes=k, local_steps=1, algorithm="cdfa_m",
                           cdfa_fraction=0.5)
    tr = tcdfl.build_trainer(tsimple.make_mlp_loss(T_MLP_CONFIG), tfed,
                             tbase.TrainConfig(learning_rate=0.0,
                                               batch_size=B), device="cpu")
    rng = np.random.default_rng(5)
    init = {n: rng.standard_normal((k,) + tuple(v.shape)).astype(np.float32)
            for n, v in tsimple.mlp_init(torch.Generator().manual_seed(0),
                                         T_MLP_CONFIG, device="cpu").items()}
    buf, layout = convert.params_from_numpy(init, "cpu")
    state = tr.init(tflat.unflatten(buf, layout), _data(k)[1],
                    same_init=False)
    final, _ = tr.run_rounds(state, _data(k)[0], 1,
                             idx=np.zeros((1, k, 1, B), np.int64))
    prefix = tflat.prefix_length(layout, 0.5)
    assert prefix == 40                      # b1 (30) then b2 (10)
    assert torch.equal(final.buf[:, prefix:], state.buf[:, prefix:])
    assert not torch.equal(final.buf[:, :prefix], state.buf[:, :prefix])


# -- refusals: the reference's exception classes --------------------------

_CRASH = dict(kinds=("crash",), crash_rate=0.2)


@pytest.mark.parametrize("kw", [
    dict(algorithm="dpsgd", wire_dtype="bf16"),
    dict(algorithm="dpsgd", transport="ring"),
    dict(algorithm="dpsgd", transport="gossip", staleness=1),
    dict(algorithm="dpsgd", faults=_CRASH),
    dict(algorithm="cdfa_m", faults=_CRASH),
    dict(algorithm="dpsgd", robust="median"),
    dict(algorithm="cdfa_m", robust="trimmed_mean"),
    dict(algorithm="cdfa_m", mixing_format="hierarchical"),
])
def test_refusals_raise_the_reference_exception(kw):
    def build(pkg_fed, faults_cls, trainer, **extra):
        fkw = dict(kw)
        if "faults" in fkw:
            fkw["faults"] = faults_cls(**fkw["faults"])
        fed = pkg_fed(num_nodes=4, **fkw)
        return trainer(fed, **extra)

    loss = simple.make_mlp_loss(MLP_CONFIG)
    tloss = tsimple.make_mlp_loss(T_MLP_CONFIG)
    with pytest.raises(Exception) as want:
        build(FedConfig, FaultConfig,
              lambda f: build_trainer(loss, f, TrainConfig()))
    with pytest.raises(Exception) as got:
        build(tbase.FedConfig, tbase.FaultConfig,
              lambda f: tcdfl.build_trainer(tloss, f, tbase.TrainConfig(),
                                            device="cpu"))
    assert got.type is want.type, (got.value, want.value)


def test_algorithms_are_registered_as_in_the_reference():
    registry.ensure_plugins()
    assert "dpsgd" in registry.algorithms.names()
    assert "cdfa_m" in registry.algorithms.names()
    assert not registry.algorithms.get("dpsgd").uses_transport
    assert registry.algorithms.get("cdfa_m").uses_transport
    assert not any(key[0] == "algorithm" for key in registry.NOT_PORTED)
    tr = tbaselines.cdfa_m(tsimple.make_mlp_loss(T_MLP_CONFIG),
                           tbase.FedConfig(), tbase.TrainConfig(),
                           fraction=0.25, device="cpu")
    assert tr.device == torch.device("cpu")


# -- ragged nodes: n_items and cnd_dedup -----------------------------------

def test_n_items_draws_stay_under_each_node_count():
    k = 4
    tfed = tbase.FedConfig(num_nodes=k, local_steps=S)
    tr = tcdfl.build_trainer(tsimple.make_mlp_loss(T_MLP_CONFIG), tfed,
                             tbase.TrainConfig(learning_rate=0.0,
                                               batch_size=B), device="cpu")
    data, items = _data(k)
    state = tr.init(tsimple.mlp_init(torch.Generator().manual_seed(0),
                                     T_MLP_CONFIG, device="cpu"), items)
    n_items = [5, 64, 1, 17]
    seen = []
    real_loss = tsimple.make_mlp_loss(T_MLP_CONFIG)

    def spy(params, batch):
        seen.append(batch["y"].clone())
        return real_loss(params, dict(batch, y=batch["y"] % 10))

    # a spy on the loss sees every gathered batch; labels are unique per
    # slot here, so they name the slot each draw picked
    marked = dict(data, y=np.broadcast_to(np.arange(N), (k, N)).copy())
    tr_spy = tcdfl.build_trainer(spy, tfed, tbase.TrainConfig(
        learning_rate=0.0, batch_size=B), device="cpu")
    tr_spy.run_rounds(state, marked, 20, n_items=n_items,
                      generator=torch.Generator().manual_seed(3))
    drawn = torch.stack(seen)                       # (20*S, K, B)
    for node, n in enumerate(n_items):
        assert int(drawn[:, node].max()) < n
        assert int(drawn[:, node].min()) >= 0
    # the draws cover each node's range, not just its first slots
    assert int(drawn[:, 1].max()) > 50 and int(drawn[:, 3].max()) == 16
    assert (drawn[:, 2] == 0).all()
    # an explicit index past a node's count is refused
    idx = np.zeros((1, k, S, B), np.int64)
    idx[0, 3, 1, 2] = 17
    with pytest.raises(ValueError, match="node 3"):
        tr.run_rounds(state, data, 1, idx=idx, n_items=n_items)
    with pytest.raises(ValueError, match="n_items"):
        tr.run_rounds(state, data, 1, n_items=[5, 64, 0, 17])
    idx[0, 3, 1, 2] = 16
    tr.run_rounds(state, data, 1, idx=idx, n_items=n_items)


@pytest.mark.parametrize("ratio,seed", [(0.1, 0), (0.4, 2), (1.0, 3)])
def test_cnd_dedup_matches_reference(ratio, seed):
    ds = redundancy.inject_duplicates(
        synthetic.synthetic_mnist(seed=seed, n=320, noise=2.5), ratio,
        seed=seed)
    tds = tredundancy.inject_duplicates(
        tsynthetic.synthetic_mnist(seed=seed, n=320, noise=2.5), ratio,
        seed=seed)
    want = redundancy.cnd_dedup(ds)
    got = tredundancy.cnd_dedup(tds)
    for field in ("x", "y", "features"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    assert got.x.shape[0] == redundancy.true_distinct_count(ds.features)


# -- the paper's Tables 1-4 MLP setup -------------------------------------
# benchmarks/paper_tables.py:24-140: K=4 ring, NODE_RATIOS through
# inject_duplicates, synthetic_mnist noise 2.5, a 320-item test set from
# seed 99, the MLP config's lr/batch/betas/eps, 10 local steps, per-round
# eval accuracy, CND-deduplicated ragged nodes (n_items) for cdfl only.

NODE_RATIOS = [0.1, 0.2, 0.4, 0.8]
MLP_NOISE = 2.5
TABLE_ROUNDS = 3
TABLE_STEPS = 10


def _pad_cycle(a, n):
    reps = int(np.ceil(n / a.shape[0]))
    return np.concatenate([a] * reps)[:n]


def _table_setup(pkg, alg):
    """(train nodes, raw items, padded data, n_items, test set) from one
    package's data functions, as paper_tables._alg_setup builds them."""
    syn, red, pipe = pkg
    cfg = MLP_CONFIG
    nodes = [red.inject_duplicates(
        syn.synthetic_mnist(seed=i, n=cfg.train_per_node, noise=MLP_NOISE),
        NODE_RATIOS[i], seed=i) for i in range(4)]
    test = syn.synthetic_mnist(seed=99, n=cfg.test_per_node * 4,
                               noise=MLP_NOISE)
    train_nodes = ([red.cnd_dedup(n) for n in nodes] if alg == "cdfl"
                   else nodes)
    raw_items = pipe.FederatedBatcher(nodes, cfg.batch_size,
                                      TABLE_STEPS).node_items()
    n_per = np.asarray([d.x.shape[0] for d in train_nodes])
    n_max = int(n_per.max())
    data = {"x": np.stack([_pad_cycle(d.x, n_max) for d in train_nodes]),
            "y": np.stack([_pad_cycle(d.y, n_max) for d in train_nodes])}
    n_items = None if (n_per == n_max).all() else n_per
    return raw_items, data, n_items, test


@pytest.mark.parametrize("alg", ["cdfl", "cfa", "cdfa_m", "dpsgd"])
def test_table_setup_matches_reference(alg):
    raw_items, data, n_items, test = _table_setup(
        (synthetic, redundancy, pipeline), alg)
    t_items, t_data, t_n, t_test = _table_setup(
        (tsynthetic, tredundancy, tpipeline), alg)
    np.testing.assert_array_equal(t_items, raw_items)
    for name in data:
        np.testing.assert_array_equal(t_data[name], data[name])
    assert (n_items is None) == (t_n is None) == (alg != "cdfl")
    cfg = MLP_CONFIG
    fed = FedConfig(num_nodes=4, local_steps=TABLE_STEPS, algorithm=alg)
    train = TrainConfig(learning_rate=cfg.learning_rate,
                        batch_size=cfg.batch_size, beta1=cfg.beta1,
                        beta2=cfg.beta2, eps=cfg.eps)
    loss = simple.make_mlp_loss(cfg)
    xt, yt = jnp.asarray(test.x), jnp.asarray(test.y)
    tr = build_trainer(lambda p, b: loss(p, b), fed, train,
                       eval_fn=lambda p: simple.accuracy(
                           simple.mlp_forward(p, xt), yt))
    state = tr.init(jax.random.PRNGKey(0),
                    lambda r: simple.mlp_init(r, cfg), jnp.asarray(raw_items))
    init = {n: np.array(v) for n, v in state.params.items()}
    rng = jax.random.PRNGKey(0)
    keys = jax.vmap(lambda r: jax.random.fold_in(rng, r))(
        jnp.arange(TABLE_ROUNDS))
    shape = (4, TABLE_STEPS, cfg.batch_size)
    if n_items is None:
        idx = np.array(jax.vmap(lambda kk: jax.random.randint(
            kk, shape, 0, data["x"].shape[1]))(keys))
    else:
        # the reference's ragged draw (cdfl.py:735-741)
        nn = jnp.asarray(n_items)
        u = jax.vmap(lambda kk: jax.random.uniform(kk, shape))(keys)
        idx = np.array(jnp.minimum(
            (u * nn[None, :, None, None]).astype(jnp.int32),
            nn.astype(jnp.int32)[None, :, None, None] - 1))
    final, metrics = tr.run_rounds(
        state, {n: jnp.asarray(v) for n, v in data.items()}, TABLE_ROUNDS,
        rng=rng, n_items=None if n_items is None else jnp.asarray(n_items))

    tcfg = T_MLP_CONFIG
    tfed = tbase.FedConfig(num_nodes=4, local_steps=TABLE_STEPS,
                           algorithm=alg)
    ttrain = tbase.TrainConfig(learning_rate=tcfg.learning_rate,
                               batch_size=tcfg.batch_size, beta1=tcfg.beta1,
                               beta2=tcfg.beta2, eps=tcfg.eps)
    tx = torch.tensor(t_test.x).expand((4,) + t_test.x.shape)
    ty = torch.tensor(t_test.y).expand((4,) + t_test.y.shape)
    ttr = tcdfl.build_trainer(
        tsimple.make_mlp_loss(tcfg), tfed, ttrain, device="cpu",
        eval_fn=lambda p: tsimple.accuracy(tsimple.mlp_forward(p, tx), ty))
    buf, layout = convert.params_from_numpy(init, "cpu")
    tstate = ttr.init(tflat.unflatten(buf, layout), t_items, same_init=False)
    tfinal, tmetrics = ttr.run_rounds(tstate, t_data, TABLE_ROUNDS, idx=idx,
                                      n_items=t_n)
    ref = convert.state_from_numpy(final, "cpu")
    np.testing.assert_allclose(tfinal.buf.numpy(), ref.buf.numpy(),
                               atol=TOL, rtol=0)
    for name in ("loss", "eval"):
        np.testing.assert_allclose(tmetrics[name].numpy(),
                                   np.asarray(metrics[name]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
