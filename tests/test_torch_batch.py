"""The port's batched fleet sweeps (``Trainer.run_rounds_batch``,
``SweepAxes``, ``Experiment.compile_batch``, ``BatchedSession``, the CLI's
``--sweep``) on the CPU at K=4, with the small linear model and data recipe
of tests/test_batch.py.

* A batched run equals the loop of its single runs within 1e-5: dense
  (static, platoon, platoon with a crash plan), sparse (static, platoon),
  a bf16 wire, dpsgd, cdfa_m, fedavg and the robust trimmed mean.
* The port's ``run_rounds_batch`` equals the JAX package's on the same
  initial states and batch indices within 1e-5 (dense platoon with crashes,
  sparse, and an lr x gamma sweep); the indices are built on the JAX side
  as the reference folds them (``fold_in(key, r)``, then ``randint``).
* ``SweepAxes.variants`` and ``stack_variant_stacks`` equal the
  reference's; the facade test of tests/test_batch.py on the port; the
  reference's refusals; the CLI's ``SWEEP_SMOKE`` verdict.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import experiment as jexp
from repro.configs.base import FaultConfig, FedConfig, MobilityConfig
from repro.configs.base import TrainConfig
from repro.core.cdfl import build_trainer
from repro.mobility import mixing as jmixing
from repro_torch import convert
from repro_torch import experiment as texp
from repro_torch.configs import base as tbase
from repro_torch.core import cdfl as tcdfl
from repro_torch.core import topology as ttopo
from repro_torch.launch import train as ttrain
from repro_torch.mobility import mixing as tmixing


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


K, S, B, N, R = 4, 2, 4, 24, 3
TOL = 1e-5
PLATOON = dict(kind="platoon", speed_jitter=0.15, seed=0)
CRASH = dict(kinds=("crash",), crash_rate=0.25, seed=3)
R_FAULTS = 5             # the crash plan's first crash falls in round 3
SEEDS = [3, 9, 11]


def _jloss(p, b):
    return jnp.mean((b["x"] @ p["w"] - b["y"][:, None]) ** 2)


def _jinit(r):
    return {"w": jax.random.normal(r, (6, 1)) * 0.1}


def _tloss(p, b):
    """tests/test_batch.py's loss, node-stacked: (K,) per-node losses."""
    return ((torch.bmm(b["x"], p["w"]) - b["y"][..., None]) ** 2).mean(
        dim=(1, 2))


def _tinit(gen):
    return {"w": torch.randn((6, 1), generator=gen) * 0.1}


def _data(seed=7):
    rng = np.random.default_rng(seed)
    data = {"x": rng.normal(size=(K, N, 6)).astype(np.float32),
            "y": rng.normal(size=(K, N)).astype(np.float32)}
    return data, rng.integers(0, 40, (K, N, 4)).astype(np.int32)


def _fed(pkg, **kw):
    """The same FedConfig in either package (sub-configs from dicts)."""
    mob = (MobilityConfig if pkg == "jax" else tbase.MobilityConfig)
    flt = (FaultConfig if pkg == "jax" else tbase.FaultConfig)
    kw = dict(kw)
    if "mobility" in kw:
        kw["mobility"] = mob(**kw["mobility"])
    if "faults" in kw:
        kw["faults"] = flt(**kw["faults"])
    if pkg == "torch":
        kw.pop("simulate_wire", None)
    cls = FedConfig if pkg == "jax" else tbase.FedConfig
    return cls(num_nodes=K, gamma=0.5, local_steps=S, **kw)


def _train(pkg, lr=0.05):
    cls = TrainConfig if pkg == "jax" else tbase.TrainConfig
    return cls(learning_rate=lr, batch_size=B)


# --- the batched run against the loop of its single runs --------------------

LOOP_CASES = {
    "dense": dict(),
    "dense-platoon": dict(mobility=PLATOON),
    "dense-platoon-crash": dict(mobility=PLATOON, faults=CRASH),
    "sparse": dict(mixing_format="sparse", degree=2),
    "sparse-platoon": dict(mixing_format="sparse", degree=2,
                           mobility=PLATOON),
    "bf16": dict(wire_dtype="bf16"),
    "dpsgd": dict(algorithm="dpsgd"),
    "cdfa_m": dict(algorithm="cdfa_m"),
    "fedavg": dict(algorithm="fedavg"),
    "robust-trimmed-mean": dict(robust="trimmed_mean", faults=dict(
        kinds=("corrupt", "straggle"), corrupt_rate=0.3, straggle_rate=0.3,
        seed=1)),
}


@pytest.mark.parametrize("name", list(LOOP_CASES))
def test_batched_matches_looped(name):
    data, items = _data()
    rounds = R_FAULTS if "faults" in LOOP_CASES[name] else R
    tr = tcdfl.build_trainer(_tloss, _fed("torch", **LOOP_CASES[name]),
                             _train("torch"), device="cpu")
    inits = [tr.init(_tinit(torch.Generator().manual_seed(s)), items)
             for s in SEEDS]
    singles = [tr.run_rounds(st, data, rounds,
                             generator=torch.Generator().manual_seed(s + 1))
               for st, s in zip(inits, SEEDS)]
    final, metrics = tr.run_rounds_batch(tcdfl.stack_states(inits), data,
                                         rounds, rngs=[s + 1 for s in SEEDS])
    assert tuple(metrics["loss"].shape) == (len(SEEDS), rounds, K)
    assert tuple(metrics["disagreement"].shape) == (len(SEEDS), rounds)
    assert final.round.tolist() == [rounds] * len(SEEDS)
    for i, (fs, m) in enumerate(singles):
        torch.testing.assert_close(final.buf[i], fs.buf, rtol=0, atol=TOL)
        torch.testing.assert_close(final.opt.m[i], fs.opt.m, rtol=0,
                                   atol=TOL)
        assert set(metrics) == set(m)
        for key, series in m.items():
            torch.testing.assert_close(metrics[key][i], series, rtol=0,
                                       atol=TOL, msg=f"{name} {key} {i}")
    if "faults" in LOOP_CASES[name]:
        # the plan fired
        assert float(metrics["quarantined"].sum() + (
            1 - metrics["health"]).sum()) > 0


# --- the port against the JAX package's run_rounds_batch --------------------

JAX_CASES = {
    "dense-platoon-crash": (dict(mobility=PLATOON, faults=CRASH), None),
    "sparse": (dict(mixing_format="sparse", degree=2), None),
    "lr-x-gamma": (dict(), dict(lr=[0.05, 0.02], gamma=[0.5, 0.8])),
}


def _rounds(kw):
    return R_FAULTS if "faults" in kw else R


def _jax_batch(name):
    kw, sweep = JAX_CASES[name]
    rounds = _rounds(kw)
    data, items = _data()
    tr = build_trainer(_jloss, _fed("jax", **kw), _train("jax"))
    inits = [tr.init(jax.random.PRNGKey(s), _jinit, jnp.asarray(items))
             for s in SEEDS[:2]]
    variants = [(s, lr, g) for s in SEEDS[:2]
                for lr, g in ([(None, None)] if sweep is None else
                              [(lr, g) for lr in sweep["lr"]
                               for g in sweep["gamma"]])]
    states = [inits[SEEDS.index(s)] for s, _, _ in variants]
    rngs = jnp.stack([jax.random.PRNGKey(s + 1) for s, _, _ in variants])
    keys = jax.vmap(lambda key: jax.vmap(
        lambda r: jax.random.fold_in(key, r))(jnp.arange(rounds)))(rngs)
    idx = np.array(jax.vmap(jax.vmap(lambda kk: jax.random.randint(
        kk, (K, S, B), 0, N)))(keys))
    port_states = [convert.state_from_numpy(st, "cpu") for st in states]
    extra = {}
    if sweep is not None:
        stacks = [tr.mixing_stack(states[0], rounds, gamma_cap=g)
                  for _, _, g in variants]
        extra = dict(eta_stacks=jmixing.stack_variant_stacks(
                         [e for e, _ in stacks]),
                     gamma_stacks=jnp.stack([g for _, g in stacks]),
                     lrs=jnp.asarray([lr for _, lr, _ in variants],
                                     jnp.float32))
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
    final, metrics = tr.run_rounds_batch(
        stacked, {n: jnp.asarray(v) for n, v in data.items()}, rounds,
        rngs=rngs, **extra)
    return (variants, idx, port_states,
            {n: np.asarray(v) for n, v in final.params.items()},
            {n: np.asarray(v) for n, v in metrics.items()})


@pytest.fixture(scope="module")
def jax_batches():
    return {name: _jax_batch(name) for name in JAX_CASES}


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_port_matches_reference_run_rounds_batch(name, jax_batches):
    variants, idx, port_states, want_params, want = jax_batches[name]
    kw, sweep = JAX_CASES[name]
    data, _ = _data()
    tr = tcdfl.build_trainer(_tloss, _fed("torch", **kw), _train("torch"),
                             device="cpu")
    extra = {}
    if sweep is not None:
        stacks = [tr.mixing_stack(port_states[0], _rounds(kw), gamma_cap=g)
                  for _, _, g in variants]
        extra = dict(eta_stacks=tmixing.stack_variant_stacks(
                         [e for e, _ in stacks]),
                     gamma_stacks=torch.stack([g for _, g in stacks]),
                     lrs=[lr for _, lr, _ in variants])
    final, metrics = tr.run_rounds_batch(
        tcdfl.stack_states(port_states), data, _rounds(kw), idx=idx, **extra)
    np.testing.assert_allclose(final.params["w"].numpy(), want_params["w"],
                               rtol=0, atol=TOL)
    for key in ("loss", "disagreement", "gamma", "health", "quarantined",
                "frozen"):
        if key in want:
            np.testing.assert_allclose(metrics[key].numpy(), want[key],
                                       rtol=0, atol=TOL, err_msg=key)
    assert set(metrics) == set(want)
    if "faults" in kw:
        assert (want["health"] == 0).any()      # a node crashed


# --- SweepAxes and stack_variant_stacks against the reference ---------------

AXES = [dict(seeds=4), dict(seeds=2, lr=[1e-3, 3e-3, 1e-2]),
        dict(seeds=2, lr=[0.1, 0.2]), dict(seeds=[3, 9], gamma=[0.5, 0.8]),
        dict(lr=[0.05], mobility=[None, "platoon"])]


@pytest.mark.parametrize("kw", AXES, ids=[str(a) for a in AXES])
def test_sweep_axes_variants_match_reference(kw):
    assert texp.SweepAxes(**kw).variants() == jexp.SweepAxes(**kw).variants()


@pytest.mark.parametrize("kw,match", [
    (dict(), "at least one axis"), (dict(lr=[]), "empty"),
    (dict(seeds=0), "positive"), (dict(seeds=[]), "empty")])
def test_sweep_axes_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        jexp.SweepAxes(**kw).variants()
    with pytest.raises(ValueError, match=match):
        texp.SweepAxes(**kw).variants()


def test_stack_variant_stacks_matches_reference():
    rng = np.random.default_rng(5)
    dense = [rng.random((R, K, K)).astype(np.float32) for _ in range(3)]
    np.testing.assert_array_equal(
        tmixing.stack_variant_stacks([torch.tensor(d) for d in dense]),
        np.asarray(jmixing.stack_variant_stacks(
            [jnp.asarray(d) for d in dense])))
    idx = [rng.integers(0, K, (R, K, 2)).astype(np.int32) for _ in range(3)]
    val = [rng.random((R, K, 2)).astype(np.float32) for _ in range(3)]
    got = tmixing.stack_variant_stacks([
        ttopo.SparseEta(torch.tensor(i), torch.tensor(v))
        for i, v in zip(idx, val)])
    from repro.core import topology as jtopo
    want = jmixing.stack_variant_stacks([
        jtopo.SparseEta(jnp.asarray(i), jnp.asarray(v))
        for i, v in zip(idx, val)])
    assert isinstance(got, ttopo.SparseEta)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.val.numpy(), np.asarray(want.val))


# --- the facade: compile_batch -> run_batch == one Session a variant --------

def _exp(fed, train):
    return texp.Experiment.from_parts(_tloss, _tinit, fed=fed, train=train,
                                      device="cpu")


def test_facade_sweep_matches_looped_sessions():
    """seeds x lr x gamma x mobility through compile_batch equals one plain
    Session per variant (the corners of the product), and the eval metric
    comes back (V, R, K)."""
    data, items = _data()
    fed = tbase.FedConfig(num_nodes=K, gamma=0.5, local_steps=2,
                          algorithm="cdfl")
    train = _train("torch")
    platoon = tbase.MobilityConfig(**PLATOON)
    axes = texp.SweepAxes(seeds=[3, 9], lr=[0.05, 0.02], gamma=[0.5, 0.8],
                          mobility=[None, platoon])
    bs = _exp(fed, train).compile_batch(data, items, axes)
    assert bs.num_variants == 16

    def evalf(p):
        return (p["w"] ** 2).sum(dim=(1, 2))

    res = bs.run_batch(3, callbacks=[texp.EvalCallback(evalf, name="wnorm")])
    assert tuple(res.metrics["wnorm"].shape) == (16, 3, K)
    assert tuple(res.metrics["loss"].shape) == (16, 3, K)
    assert bs.rounds_completed == 3
    for i in (0, 5, 10, 15):                  # corners of the product
        v = res.variants[i]
        exp_i = _exp(dataclasses.replace(fed, gamma=v["gamma"],
                                         mobility=v["mobility"]),
                     dataclasses.replace(train, learning_rate=v["lr"]))
        s = exp_i.compile(data, items, rng=v["seed"],
                          sample_rng=v["seed"] + 1)
        r = s.run(3, callbacks=[texp.EvalCallback(evalf, name="wnorm")])
        one = res.select(i)
        torch.testing.assert_close(one.final_params["w"],
                                   r.final_params["w"], rtol=0, atol=TOL)
        torch.testing.assert_close(one.metrics["wnorm"], r.metrics["wnorm"],
                                   rtol=0, atol=TOL)
        assert one.state.round == r.state.round == 3


def test_unswept_seed_uses_the_compile_generators():
    """With the seed axis unswept, every variant inits from ``rng`` and
    samples with ``sample_rng``, as ``compile`` does."""
    data, items = _data()
    fed = tbase.FedConfig(num_nodes=K, local_steps=2)
    exp = _exp(fed, _train("torch"))
    res = exp.compile_batch(data, items, texp.SweepAxes(lr=[0.05]), rng=4,
                            sample_rng=21).run_batch(2)
    plain = _exp(fed, _train("torch")).compile(data, items, rng=4,
                                               sample_rng=21).run(2)
    torch.testing.assert_close(res.select(0).final_params["w"],
                               plain.final_params["w"], rtol=0, atol=TOL)


# --- the reference's refusals ------------------------------------------------

def test_lr_sweep_rejects_schedules():
    data, items = _data()
    exp = _exp(tbase.FedConfig(num_nodes=K),
               tbase.TrainConfig(learning_rate=lambda t: 0.05))
    with pytest.raises(ValueError, match="schedule"):
        exp.compile_batch(data, items, texp.SweepAxes(lr=[0.05, 0.02]))


def test_batched_session_cannot_checkpoint_or_resume(tmp_path):
    data, items = _data()
    exp = _exp(tbase.FedConfig(num_nodes=K, local_steps=2), _train("torch"))
    bs = exp.compile_batch(data, items, texp.SweepAxes(seeds=2))
    with pytest.raises(ValueError, match="cannot checkpoint a batched"):
        bs.save(str(tmp_path / "ckpt"))
    with pytest.raises(ValueError, match="cannot resume a batched"):
        bs.resume(str(tmp_path / "ckpt"))
    with pytest.raises(ValueError, match="unsupported on batched"):
        bs.run_batch(2, callbacks=[texp.CheckpointCallback(
            str(tmp_path / "ckpt"), every=1)])


def test_hierarchical_format_rejected():
    data, items = _data()
    fed = tbase.FedConfig(num_nodes=K, local_steps=2,
                          mixing_format="hierarchical")
    bs = _exp(fed, _train("torch")).compile_batch(
        data, items, texp.SweepAxes(seeds=2))
    with pytest.raises(ValueError, match="hierarchical"):
        bs.run_batch(2)


def _two_states():
    data, items = _data()
    tr = tcdfl.build_trainer(_tloss, _fed("torch"), _train("torch"),
                             device="cpu")
    states = [tr.init(_tinit(torch.Generator().manual_seed(s)), items)
              for s in (1, 2)]
    return tr, data, states


@pytest.mark.parametrize("bad,match", [
    ("single", "needs a \\(V,\\)-stacked FedState"),
    ("rounds", "same round"),
    ("lrs", "lrs shape"),
    ("gammas", "gamma stacks shape"),
    ("etas", "eta stacks shape"),
    ("sparse", "needs mixing_format='sparse'"),
    ("rngs", "rngs leading dim"),
    ("idx", "batch index stack"),
])
def test_run_rounds_batch_checks_its_inputs(bad, match):
    tr, data, states = _two_states()
    stacked = tcdfl.stack_states(states)
    kw = {}
    if bad == "single":
        stacked = states[0]
    elif bad == "rounds":
        stacked = stacked._replace(round=torch.tensor([0, 1]))
    elif bad == "lrs":
        kw["lrs"] = [0.1, 0.2, 0.3]
    elif bad == "gammas":
        kw["eta_stacks"] = torch.full((R, K, K), 0.25)
        kw["gamma_stacks"] = torch.full((3, R), 0.5)
    elif bad == "etas":
        kw["eta_stacks"] = torch.zeros((2, R + 1, K, K))
    elif bad == "sparse":
        kw["eta_stacks"] = ttopo.SparseEta(torch.zeros((R, K, 2), dtype=int),
                                           torch.zeros((R, K, 2)))
    elif bad == "rngs":
        kw["rngs"] = [1, 2, 3]
    else:
        kw["idx"] = torch.zeros((2, R, K, S, B + 1), dtype=torch.int64)
    with pytest.raises(ValueError, match=match):
        tr.run_rounds_batch(stacked, data, R, **kw)


def test_select_state_round_trips_stack_states():
    _, _, states = _two_states()
    stacked = tcdfl.stack_states(states)
    for i, st in enumerate(states):
        back = tcdfl.select_state(stacked, i)
        assert torch.equal(back.buf, st.buf) and back.round == st.round
        assert all(torch.equal(a, b) for a, b in zip(back.opt, st.opt))
        assert torch.equal(back.ratios, st.ratios)


# --- the CLI -----------------------------------------------------------------

def test_cli_sweep_prints_the_smoke_verdict(capsys):
    state, losses = ttrain.main(["--quick", "--rounds", "3", "--sweep",
                                 "seeds=2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert losses.shape == (2, 3, 4)
    assert tuple(state.buf.shape[:2]) == (2, 4)
    head = [ln for ln in lines if ln.startswith("sweep: ")]
    assert head == ["sweep: 2 variants x 3 rounds (axes: seeds) — one "
                    "batched run"]
    rows = [ln.split() for ln in lines
            if ln.split() and ln.split()[0] in ("0", "1")]
    assert [r[:5] for r in rows] == [["0", "0", "-", "-", "-"],
                                     ["1", "1", "-", "-", "-"]]
    verdict = [ln for ln in lines if ln.startswith("SWEEP_SMOKE")]
    assert len(verdict) == 1 and verdict[0].startswith(
        "SWEEP_SMOKE ok variants=2 improved=2/2 "), lines
