"""The port's experiment layer (``repro_torch.experiment``) against the JAX
package's: ``Experiment.from_parts -> compile -> Session.run`` on the
paper MLP at K=4 from the same initial params and batch indices, dense f32
and bf16 and the platoon; ``Trainer.round`` and ``eta_fn``; and, in the
port alone, what a resumable session promises: run(10) + save + resume +
run(10) equals run(20) bit for bit, ``every=N`` segments are invisible,
callbacks fire in the reference's order, ring and gossip compile and run,
and unported paths are refused.
Both packages run on the CPU, the port through its plain kernel versions.
The data has injected duplicates, for the Adam-eps reason in ROADMAP
queue C."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import experiment as jexp
from repro.configs.base import FedConfig, MobilityConfig, TrainConfig
from repro.configs.paper_models import MLP_CONFIG
from repro.core.cdfl import build_trainer
from repro.data import pipeline, redundancy, synthetic
from repro.models import simple
from repro_torch import convert
from repro_torch import experiment as texp
from repro_torch import registry
from repro_torch.configs import base as tbase
from repro_torch.configs.paper_models import MLP_CONFIG as T_MLP_CONFIG
from repro_torch.configs.registry import get_smoke_arch
from repro_torch.core import cdfl as tcdfl
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


K, S, B, N = 4, 2, 32, 160
TOL = 1e-5               # tests/test_torch_cdfl.py's f32 tolerance
TOL_BF16 = 1e-4          # and its bf16-wire tolerance, over 2 rounds
# examples/mobility_platoon.py's scenario
PLATOON = dict(kind="platoon", speed=25.0, speed_jitter=0.4,
               radio_range=300.0, dt=5.0, seed=3, link_quality="quadratic")
# name -> (FedConfig keywords, rounds, tolerance)
CASES = {
    "dense": (dict(), 6, TOL),
    "dense-bf16": (dict(wire_dtype="bf16", simulate_wire=True), 2, TOL_BF16),
    "platoon": (dict(mobility=PLATOON), 6, TOL),
}
_LOSS = simple.make_mlp_loss(MLP_CONFIG)
_T_LOSS = tsimple.make_mlp_loss(T_MLP_CONFIG)


def _nodes():
    return [redundancy.inject_duplicates(
        synthetic.synthetic_mnist(seed=i, n=N, noise=2.0), ratio, seed=i)
        for i, ratio in enumerate([0.1, 0.3, 0.5, 0.8])]


@pytest.fixture(scope="module")
def paper_data():
    nodes = _nodes()
    data = {"x": np.stack([d.x for d in nodes]),
            "y": np.stack([d.y for d in nodes])}
    items = pipeline.FederatedBatcher(nodes, B, S, seed=0).node_items()
    return data, items


def _jfed(kw):
    kw = dict(kw)
    if "mobility" in kw:
        kw["mobility"] = MobilityConfig(**kw["mobility"])
    return FedConfig(num_nodes=K, topology="ring", gamma=0.5, local_steps=S,
                     **kw)


def _tfed(kw):
    kw = {n: v for n, v in kw.items() if n != "simulate_wire"}
    if "mobility" in kw:
        kw["mobility"] = tbase.MobilityConfig(**kw["mobility"])
    return tbase.FedConfig(num_nodes=K, topology="ring", gamma=0.5,
                           local_steps=S, **kw)


def _train():
    return TrainConfig(learning_rate=1e-3, batch_size=B)


def _t_train():
    return tbase.TrainConfig(learning_rate=1e-3, batch_size=B)


@pytest.fixture(scope="module")
def reference_runs(paper_data):
    """name -> (one node's init params, (R, K, S, B) indices, final
    state, metrics) of the JAX package's Session."""
    data, items = paper_data
    out = {}
    for name, (kw, rounds, _) in CASES.items():
        sample = jax.random.PRNGKey(3)
        session = jexp.Experiment.from_parts(
            lambda p, b: _LOSS(p, b),
            lambda r: simple.mlp_init(r, MLP_CONFIG), fed=_jfed(kw),
            train=_train()).compile(
                {n: jnp.asarray(v) for n, v in data.items()},
                jnp.asarray(items), rng=jax.random.PRNGKey(0),
                sample_rng=sample)
        init = {n: np.array(v[0]) for n, v in session.state.params.items()}
        # the indices the reference's scan draws: per-round keys folded on
        # the absolute round index, randint over the resident item count
        keys = jax.vmap(lambda r: jax.random.fold_in(sample, r))(
            jnp.arange(rounds))
        idx = np.array(jax.vmap(lambda k: jax.random.randint(
            k, (K, S, B), 0, N))(keys))
        result = session.run(rounds)
        out[name] = (init, idx, result.state,
                     {n: np.asarray(v) for n, v in result.metrics.items()})
    return out


def _experiment(kw, init=None, **exp_kw):
    init_fn = ((lambda g: {n: torch.tensor(v) for n, v in init.items()})
               if init is not None else
               (lambda g: tsimple.mlp_init(g, T_MLP_CONFIG, device="cpu")))
    return texp.Experiment.from_parts(_T_LOSS, init_fn, fed=_tfed(kw),
                                      train=_t_train(), device="cpu",
                                      **exp_kw)


@pytest.mark.parametrize("name", list(CASES))
def test_session_matches_reference(paper_data, reference_runs, name):
    data, items = paper_data
    kw, rounds, tol = CASES[name]
    init, idx, final, metrics = reference_runs[name]
    session = _experiment(kw, init).compile(data, items)
    result = session.run(rounds, idx=idx)

    ref = convert.state_from_numpy(final, "cpu")
    assert ref.layout == result.state.layout
    np.testing.assert_array_equal(result.state.ratios.numpy(),
                                  ref.ratios.numpy())
    for got, want in ((result.state.buf, ref.buf),
                      (result.state.opt.m, ref.opt.m),
                      (result.state.opt.v, ref.opt.v)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol,
                                   rtol=0)
    assert torch.equal(result.state.opt.step, ref.opt.step)
    assert result.state.round == session.rounds_completed == rounds
    for n in ("loss", "disagreement", "gamma"):
        np.testing.assert_allclose(result.metrics[n].numpy(), metrics[n],
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    for n, leaf in result.final_params.items():
        assert tuple(leaf.shape) == tuple(final.params[n].shape)


# name -> FedConfig keywords of the resume cases
RESUME = {
    "dense": dict(),
    "dense-bf16": dict(wire_dtype="bf16"),
    "platoon": dict(mobility=PLATOON),
    # straggle keeps the replay buffer in FedState.fstate
    "straggle-crash": dict(faults=tbase.FaultConfig(
        kinds=("straggle", "crash"), straggle_rate=0.3, crash_rate=0.1)),
}


def _assert_states_equal(a, b):
    assert a.layout == b.layout and a.round == b.round
    for x, y in ((a.buf, b.buf), (a.opt.m, b.opt.m), (a.opt.v, b.opt.v),
                 (a.opt.step, b.opt.step), (a.ratios, b.ratios),
                 (a.sizes, b.sizes)):
        assert torch.equal(x, y)
    assert isinstance(a.fstate, torch.Tensor) == isinstance(b.fstate,
                                                            torch.Tensor)
    if isinstance(a.fstate, torch.Tensor):
        assert torch.equal(a.fstate, b.fstate)


@pytest.mark.parametrize("name", list(RESUME))
def test_resume_equals_straight_run(paper_data, tmp_path, name):
    data, items = paper_data
    exp = _experiment(RESUME[name])
    path = str(tmp_path / "ckpt")
    straight = exp.compile(data, items).run(20)

    first = exp.compile(data, items)
    first_part = first.run(10)
    first.save(path)
    assert first.rounds_completed == 10

    resumed = exp.compile(data, items).resume(path)
    assert resumed.rounds_completed == 10
    result = resumed.run(10)
    assert resumed.rounds_completed == 20

    _assert_states_equal(straight.state, result.state)
    for n, v in straight.metrics.items():
        assert torch.equal(v, torch.cat([first_part.metrics[n],
                                         result.metrics[n]])), n
    # Adam stepped local_steps times a round through the checkpoint, but
    # in the rounds a node was down or rolled back
    live = torch.full((20, K), 1.0)
    if name == "straggle-crash":
        assert isinstance(result.state.fstate, torch.Tensor)
        assert straight.metrics["health"].min() == 0.0   # a crash happened
        live = straight.metrics["health"] - straight.metrics["frozen"]
    assert torch.equal(result.state.opt.step,
                       (S * live.sum(dim=0)).to(torch.int32))
    if name != "straggle-crash":
        assert (result.state.opt.step == 20 * S).all()


def test_periodic_segmentation_is_invisible(paper_data, tmp_path):
    """every=4 splits 9 rounds into three run_rounds calls; params and
    every stacked metric, gamma included, equal the one-call run."""
    data, items = paper_data
    exp = _experiment({})
    path = str(tmp_path / "ck")
    one = exp.compile(data, items).run(9)
    seg = exp.compile(data, items).run(
        9, callbacks=[texp.CheckpointCallback(path, every=4)])
    _assert_states_equal(one.state, seg.state)
    assert set(one.metrics) == set(seg.metrics)
    for n, v in one.metrics.items():
        assert torch.equal(v, seg.metrics[n]), n
    assert tuple(seg.metrics["loss"].shape) == (9, K)
    assert tuple(seg.metrics["gamma"].shape) == (9,)
    # the callback left a resumable checkpoint behind (the final save)
    assert exp.compile(data, items).resume(path).rounds_completed == 9


def test_callback_hooks_fire_in_order(paper_data):
    data, items = paper_data
    calls = []

    class Probe(texp.Callback):
        every = 3

        def on_run_start(self, session, rounds):
            calls.append(("start", rounds))

        def on_rounds(self, session, end_round):
            calls.append(("rounds", end_round, session.rounds_completed))

        def on_run_end(self, session, result):
            calls.append(("end", result.rounds))

    session = _experiment({}).compile(data, items)
    session.run(2)
    session.run(7, callbacks=[Probe()])
    # end_round is absolute: this run started at round 2
    assert calls == [("start", 7), ("rounds", 5, 5), ("rounds", 8, 8),
                     ("end", 7)]


def test_eval_callback_names_and_rides_as_metric(paper_data):
    data, items = paper_data
    test = synthetic.synthetic_mnist(seed=99, n=200)
    x = torch.tensor(test.x).expand((K,) + test.x.shape)
    y = torch.tensor(test.y).expand((K,) + test.y.shape)

    def eval_fn(p):
        return tsimple.accuracy(tsimple.mlp_forward(p, x), y)

    exp = _experiment({})
    result = exp.compile(data, items).run(
        6, callbacks=[texp.EvalCallback(eval_fn)])
    accs = result.metrics["eval"]
    assert tuple(accs.shape) == (6, K)
    assert accs[-1].mean() > accs[0].mean() - 0.05    # training, not noise
    named = exp.compile(data, items).run(
        3, callbacks=[texp.EvalCallback(lambda p: torch.ones(K),
                                        name="acc")])
    assert "acc" in named.metrics and "eval" not in named.metrics
    assert tuple(named.metrics["acc"].shape) == (3, K)


def test_trainer_cache_is_shared_and_bounded(paper_data):
    data, items = paper_data
    exp = _experiment({})
    s1, s2 = exp.compile(data, items), exp.compile(data, items)
    assert exp.trainer(data) is exp.trainer(data)
    assert len(exp._trainers) == 1
    assert torch.equal(s1.run(2).metrics["loss"], s2.run(2).metrics["loss"])
    evals = [lambda p, i=i: torch.full((K,), float(i)) for i in range(9)]
    for fn in evals:
        exp.trainer(data, eval_fn=fn)
    assert len(exp._trainers) == 8
    # keyed as the reference keys it: (eval_fn, sequence length), the
    # length None for an explicit loss
    assert (None, None) not in exp._trainers
    assert (evals[0], None) not in exp._trainers
    assert (evals[-1], None) in exp._trainers


def test_run_rejects_nonpositive_rounds_and_double_eval(paper_data):
    data, items = paper_data
    session = _experiment({}).compile(data, items)
    with pytest.raises(ValueError, match="positive"):
        session.run(0)
    ev = texp.EvalCallback(lambda p: torch.zeros(K))
    with pytest.raises(ValueError, match="at most one"):
        session.run(1, callbacks=[ev, texp.EvalCallback(lambda p: 1.0)])
    with pytest.raises(ValueError, match="does not hold the run's 2 rounds"):
        session.run(2, idx=np.zeros((3, K, S, B), np.int64))
    assert session.rounds_completed == 0


@pytest.mark.parametrize("transport", ["ring", "gossip"])
def test_unported_transports_are_refused(paper_data, transport):
    """Ring and gossip (ROADMAP item 20, refused until it was ported)
    compile and run through the Experiment; gossip carries its snapshots
    in the session's state."""
    data, items = paper_data
    kw = {"transport": transport}
    if transport == "gossip":
        kw["staleness"] = 2
    result = _experiment(kw).compile(data, items).run(2)
    assert result.state.round == 2
    assert torch.isfinite(result.metrics["loss"]).all()
    assert tuple(result.metrics["loss"].shape) == (2, K)
    snapshots = result.state.tstate
    if transport == "gossip":
        assert tuple(snapshots.shape) == (2,) + tuple(result.state.buf.shape)
    else:
        assert snapshots == ()


def test_token_lm_config_and_model_free_config_are_refused():
    # the token-LM loss is derived from the config; mixtral (ROADMAP item
    # 23c, refused at compile until it was ported) compiles and runs a
    # round through run_experiment (Experiment.compile, then run)
    cfg = tbase.RunConfig(model=get_smoke_arch("mixtral-8x7b"),
                          fed=tbase.FedConfig(num_nodes=4, local_steps=1),
                          train=tbase.TrainConfig(batch_size=4))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.model.vocab_size, (4, 2, 9), np.int32)
    data = {"tokens": tokens[..., :-1], "labels": tokens[..., 1:]}
    items = np.zeros((4, 2, 2), np.int32)
    result = texp.run_experiment(cfg, data, items, 1, device="cpu")
    assert result.state.round == 1
    assert tuple(result.metrics["loss"].shape) == (1, 4)
    assert torch.isfinite(result.metrics["loss"]).all()
    assert registry.MODEL_NOT_PORTED == {}
    assert ("model", "token_lm") not in registry.NOT_PORTED
    exp = texp.Experiment(tbase.RunConfig(model=None), device="cpu")
    with pytest.raises(ValueError, match="loss_fn/init_params"):
        exp.compile({"x": np.zeros((4, 2, 3))}, np.zeros((4, 2, 2)))
    with pytest.raises(ValueError, match="not both"):
        texp.Experiment(tbase.RunConfig(model=None), fed=tbase.FedConfig(),
                        device="cpu")
    with pytest.raises(ValueError, match="without init_params"):
        texp.Experiment(loss_fn=_T_LOSS, device="cpu").compile(
            {"x": np.zeros((4, 2, 3))}, np.zeros((4, 2, 2)))


def test_batch_indices_keyed_on_the_absolute_round(paper_data):
    data, items = paper_data
    counts = np.array([160, 17, 1, 90])
    session = _experiment({}).compile(data, items, n_items=counts,
                                      sample_rng=torch.Generator()
                                      .manual_seed(11))
    whole = session.batch_indices(0, 6)
    assert torch.equal(session.batch_indices(3, 3), whole[3:])
    assert tuple(whole.shape) == (6, K, S, B)
    assert (whole < torch.tensor(counts)[None, :, None, None]).all()
    assert (whole[:, 2] == 0).all() and whole[:, 0].max() > 100
    # the seed of a generator is its initial seed; an int seed is itself
    assert torch.equal(whole, session.batch_indices(0, 6, seed=11))
    assert not torch.equal(whole, session.batch_indices(0, 6, seed=12))


def test_same_init_false_draws_each_node(paper_data):
    data, items = paper_data
    exp = _experiment({})
    same = exp.compile(data, items)
    each = exp.compile(data, items, same_init=False)
    w1 = each.state.params["w1"]
    assert not torch.equal(w1[0], w1[1])
    assert torch.equal(w1[0], same.state.params["w1"][0])


def test_trainer_round_and_eta_fn_match_reference(paper_data):
    """Two host-fed rounds through ``Trainer.round`` (batches leaves
    (K, S, B, ...)) against the reference's jitted round."""
    data, items = paper_data
    fed = _jfed({})
    tr = build_trainer(lambda p, b: _LOSS(p, b), fed, _train())
    state = tr.init(jax.random.PRNGKey(1),
                    lambda r: simple.mlp_init(r, MLP_CONFIG),
                    jnp.asarray(items))
    init = {n: np.array(v[0]) for n, v in state.params.items()}
    ttr = tcdfl.build_trainer(_T_LOSS, _tfed({}), _t_train(), device="cpu")
    tstate = ttr.init({n: torch.tensor(v) for n, v in init.items()}, items)
    np.testing.assert_allclose(ttr.eta_fn(tstate).numpy(),
                               np.asarray(tr.eta_fn(state)), rtol=1e-6,
                               atol=0)
    rng = np.random.default_rng(4)
    for r in range(2):
        idx = rng.integers(0, N, size=(K, S, B))
        batches = {n: np.stack([v[k][idx[k]] for k in range(K)])
                   for n, v in data.items()}
        state, metrics = tr.round(
            state, {n: jnp.asarray(v) for n, v in batches.items()})
        tstate, tmetrics = ttr.round(tstate, batches)
        for n in ("loss", "disagreement", "gamma"):
            np.testing.assert_allclose(np.asarray(tmetrics[n]),
                                       np.asarray(metrics[n]), rtol=1e-5,
                                       atol=1e-6, err_msg=n)
    ref = convert.state_from_numpy(
        types.SimpleNamespace(
            params={n: np.asarray(v) for n, v in state.params.items()},
            opt=state.opt, ratios=state.ratios, sizes=state.sizes,
            round=state.round), "cpu")
    np.testing.assert_allclose(tstate.buf.numpy(), ref.buf.numpy(),
                               atol=TOL, rtol=0)
    assert torch.equal(tstate.opt.step, ref.opt.step)
    assert tstate.round == int(state.round) == 2


@pytest.mark.parametrize("kw,shape,match", [
    (dict(mobility=PLATOON), (S, B), "FedConfig.mobility is set"),
    (dict(faults=tbase.FaultConfig(kinds=("crash",))), (S, B),
     "FedConfig.faults is set"),
    # round is one run_rounds round: its batches lead with (K,
    # local_steps, batch_size)
    (dict(), (S + 1, B), r"not \(K, local_steps, batch_size\)"),
    (dict(), (S, B - 1), r"not \(K, local_steps, batch_size\)"),
])
def test_trainer_round_refuses_what_rides_run_rounds(paper_data, kw, shape,
                                                     match):
    data, items = paper_data
    tr = tcdfl.build_trainer(_T_LOSS, _tfed(kw), _t_train(), device="cpu")
    state = tr.init(tsimple.mlp_init(torch.Generator().manual_seed(0),
                                     T_MLP_CONFIG, device="cpu"), items)
    s, b = shape
    batches = {n: v[:, :s * b].reshape((K, s, b) + v.shape[2:])
               for n, v in data.items()}
    with pytest.raises(ValueError, match=match):
        tr.round(state, batches)


def _fake_session(pkg, mob, rounds_completed):
    """What the mobility callbacks read: ``experiment.fed`` and
    ``rounds_completed``."""
    fed = (FedConfig(num_nodes=K, mobility=MobilityConfig(**mob))
           if pkg == "jax" else
           tbase.FedConfig(num_nodes=K, mobility=tbase.MobilityConfig(**mob)))
    return types.SimpleNamespace(
        experiment=types.SimpleNamespace(fed=fed),
        rounds_completed=rounds_completed)


@pytest.mark.parametrize("start", [0, 5])
def test_mobility_callbacks_print_the_reference_lines(start):
    lines = {"jax": [], "torch": []}
    for pkg, mod in (("jax", jexp), ("torch", texp)):
        session = _fake_session(pkg, PLATOON, start)
        mod.ChurnLogCallback(lines[pkg].append).on_run_start(session, 8)
        cb = mod.DegreeStatsCallback(lines[pkg].append)
        cb.on_run_start(session, 8)
        result = types.SimpleNamespace(metrics={})
        cb.on_run_end(session, result)
        lines[pkg].append(sorted(result.metrics))
        lines[pkg].append(np.asarray(result.metrics["degree_max"]).tolist())
    assert lines["torch"] == lines["jax"]
    assert "mobility=platoon" in lines["torch"][0]
    assert lines["torch"][1].startswith("degrees: ")


def test_mobility_callbacks_silent_on_static_and_health_reports(paper_data):
    data, items = paper_data
    out = []
    _experiment({}).compile(data, items).run(
        2, callbacks=[texp.ChurnLogCallback(out.append),
                      texp.DegreeStatsCallback(out.append),
                      texp.HealthCallback(out.append)])
    assert out == []
    faulted = _experiment(RESUME["straggle-crash"]).compile(data, items)
    result = faulted.run(4, callbacks=[texp.HealthCallback(out.append)])
    crashed = int((1.0 - result.metrics["health"]).sum())
    assert out == [f"health: rounds=4 nodes={K} crashed_node_rounds="
                   f"{crashed} quarantined="
                   f"{int(result.metrics['quarantined'].sum())} frozen="
                   f"{int(result.metrics['frozen'].sum())}"]


@pytest.mark.parametrize("kw", [
    dict(), dict(algorithm="fedavg"), dict(algorithm="dpsgd"),
    dict(algorithm="cdfa_m", cdfa_fraction=0.5), dict(wire_dtype="bf16"),
    dict(mixing_format="sparse", degree=2),
    dict(mixing_format="hierarchical",
         hierarchy=tbase.HierarchyConfig(max_cluster_size=4)),
], ids=["cdfl", "fedavg", "dpsgd", "cdfa_m", "bf16", "sparse",
        "hierarchical"])
def test_trainer_round_equals_one_run_rounds_round(kw):
    """``round`` on host-gathered batches is ``run_rounds`` over one round
    with the same indices, bit for bit, in every format."""
    k, n = 8, 40
    rng = np.random.default_rng(9)
    data = {"x": rng.normal(size=(k, n, 784)).astype(np.float32),
            "y": rng.integers(0, 10, size=(k, n)).astype(np.int32)}
    items = rng.integers(0, 30, size=(k, n, 4)).astype(np.int32)
    fed = tbase.FedConfig(num_nodes=k, topology="ring", gamma=0.5,
                          local_steps=S, **kw)
    tr = tcdfl.build_trainer(_T_LOSS, fed, _t_train(), device="cpu")
    state = tr.init(tsimple.mlp_init(torch.Generator().manual_seed(2),
                                     T_MLP_CONFIG, device="cpu"), items)
    idx = torch.as_tensor(rng.integers(0, n, size=(2, k, S, B)))
    a, b = state, state
    for r in range(2):
        batches = {name: torch.as_tensor(v)[torch.arange(k)[:, None, None],
                                            idx[r]]
                   for name, v in data.items()}
        a, ma = tr.round(a, batches)
        b, mb = tr.run_rounds(b, data, 1, idx=idx[r:r + 1])
        for name in ("loss", "disagreement", "gamma"):
            assert torch.equal(ma[name].reshape(-1), mb[name].reshape(-1)), \
                name
    _assert_states_equal(a, b)
    assert a.round == 2
    eta = tr.eta_fn(state)
    assert type(eta) is type(tr.mixing(state)[0])
