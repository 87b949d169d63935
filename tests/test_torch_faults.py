"""Fault injection, self-healing and robust mixing of the port against the
JAX package: ``compile_plan`` arrays identical for every kind (resumed at
``start > 0`` too), ``corrupt_rows`` bit for bit, the wire guard on dense,
sparse and hierarchical eta (clean input passed through bit for bit), the
three masked stacks, and ``build_trainer -> run_rounds`` under the fault
cocktail in the dense, sparse and hierarchical formats and under robust
mixing, from the same initial params and batch indices, within 1e-5 after
3 f32 rounds (a bf16 wire within 1e-4 over 2 rounds, ROADMAP C). Also:
zero-rate faults bit-identical to none, crashed nodes freezing their Adam
step, 3 + 3 rounds equal to 6, the straggle buffer carried across through
``repro_torch.convert``, the ``eval`` metric, and the reference's
refusals. Both sides run on the CPU, the port through its plain kernel
versions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import (FaultConfig, FedConfig, HierarchyConfig,
                                MobilityConfig, TrainConfig)
from repro.configs.paper_models import MLP_CONFIG
from repro.core import topology as jtopo
from repro.core.cdfl import build_trainer
from repro.data import pipeline, redundancy, synthetic
from repro.faults import models as jfaults
from repro.hierarchy import mixing as jhier
from repro.mobility import mixing as jmix
from repro.models import simple
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs.paper_models import MLP_CONFIG as T_MLP_CONFIG
from repro_torch.core import cdfl as tcdfl
from repro_torch.core import flatten as tflat
from repro_torch.core import topology as ttopo
from repro_torch.faults import models as tfaults
from repro_torch.hierarchy import mixing as thier
from repro_torch.mobility import mixing as tmix
from repro_torch.models import simple as tsimple

S, B, N = 2, 8, 64
TOL = 1e-5
TOL_BF16 = 1e-4          # see tests/test_torch_cdfl.py: bf16 ulp drift
KINDS = ("link_drop", "crash", "corrupt", "straggle", "byzantine")
# tests/test_faults.py's cocktail: every kind at once
COCKTAIL = dict(kinds=KINDS, crash_rate=0.3, recover_rate=0.5,
                corrupt_rate=0.3, straggle_rate=0.3, byzantine=(1,), seed=0)
# benchmarks/paper_tables.py MOBILITY_SCENARIOS["manhattan"]
MANHATTAN = dict(kind="manhattan", speed=10.0, radio_range=500.0,
                 area=800.0, dt=2.0, seed=0)

CASES = {
    "dense-cocktail": (8, dict(faults=COCKTAIL), 3, TOL),
    "dense-bitflip-crash": (8, dict(faults=dict(
        kinds=("corrupt", "crash"), corrupt_rate=0.4, crash_rate=0.2,
        corrupt_mode="bitflip", seed=2)), 3, TOL),
    "sparse-manhattan-cocktail": (16, dict(
        mixing_format="sparse", degree=5, mobility=MANHATTAN,
        faults=dict(COCKTAIL, corrupt_mode="inf")), 3, TOL),
    "hier-manhattan-cocktail": (16, dict(
        mixing_format="hierarchical", hierarchy=dict(max_cluster_size=4),
        mobility=MANHATTAN, faults=dict(COCKTAIL, corrupt_mode="bitflip")),
        3, TOL),
    "robust-trimmed-cocktail": (8, dict(robust="trimmed_mean", gamma=0.8,
                                        faults=COCKTAIL), 3, TOL),
    # a full graph, so every neighborhood outnumbers its two attackers
    # (ROADMAP C: on a ring, a node left with one scaled neighbor averages
    # it in, its params grow 5.5x and the two packages drift apart by 4.6e-5
    # through Adam's eps region)
    "robust-median-scale": (8, dict(robust="median", topology="full",
                                    faults=dict(
        kinds=("byzantine", "link_drop"), byzantine=(2, 5),
        byzantine_mode="scale", drop_rate=0.2)), 3, TOL),
    "robust-trimmed-no-faults": (8, dict(robust="trimmed_mean", trim=2),
                                 3, TOL),
    "dense-cocktail-bf16": (8, dict(faults=COCKTAIL, wire_dtype="bf16",
                                    simulate_wire=True), 2, TOL_BF16),
}
_DATA = {}


def _data(k):
    """The data recipe of tests/test_torch_fleet.py (ROADMAP C records how
    far a single fault-free round drifts on data without duplicates)."""
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
    kw = dict({"gamma": 0.5}, **kw, num_nodes=k, local_steps=S)
    jkw, tkw = dict(kw), {n: v for n, v in kw.items()
                          if n != "simulate_wire"}
    for name, jcls, tcls in (
            ("mobility", MobilityConfig, tbase.MobilityConfig),
            ("hierarchy", HierarchyConfig, tbase.HierarchyConfig),
            ("faults", FaultConfig, tbase.FaultConfig)):
        if name in kw:
            jkw[name], tkw[name] = jcls(**kw[name]), tcls(**kw[name])
    return FedConfig(**jkw), tbase.FedConfig(**tkw)


_TEST_SET = synthetic.synthetic_mnist(seed=99, n=40)


def _j_eval(p):
    return simple.accuracy(simple.mlp_forward(p, jnp.asarray(_TEST_SET.x)),
                           jnp.asarray(_TEST_SET.y))


def _t_eval(p):
    k = p["w1"].shape[0]
    x = torch.tensor(_TEST_SET.x).expand((k,) + _TEST_SET.x.shape)
    y = torch.tensor(_TEST_SET.y).expand((k,) + _TEST_SET.y.shape)
    return tsimple.accuracy(tsimple.mlp_forward(p, x), y)


def _jax_trainer(fed, k):
    _, items = _data(k)
    train = TrainConfig(learning_rate=1e-3, batch_size=B)
    loss = simple.make_mlp_loss(MLP_CONFIG)
    tr = build_trainer(lambda p, b: loss(p, b), fed, train, eval_fn=_j_eval)
    state = tr.init(jax.random.PRNGKey(0),
                    lambda r: simple.mlp_init(r, MLP_CONFIG),
                    jnp.asarray(items))
    return tr, state, TrainConfig(learning_rate=1e-3, batch_size=B)


def _jax_idx(train, k, lo, hi):
    rng = jax.random.PRNGKey(train.seed + 1)
    keys = jax.vmap(lambda r: jax.random.fold_in(rng, r))(jnp.arange(lo, hi))
    return np.array(jax.vmap(lambda kk: jax.random.randint(
        kk, (k, S, B), 0, N))(keys)), rng


def _port_trainer(tfed, k, init):
    _, items = _data(k)
    train = tbase.TrainConfig(learning_rate=1e-3, batch_size=B)
    tr = tcdfl.build_trainer(tsimple.make_mlp_loss(T_MLP_CONFIG), tfed, train,
                             device="cpu", eval_fn=_t_eval)
    buf, layout = convert.params_from_numpy(init, "cpu")
    return tr, tr.init(tflat.unflatten(buf, layout), items, same_init=False)


def _init_params(k, seed=1):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal((k,) + tuple(v.shape)).astype(np.float32)
            * 0.1 for n, v in tsimple.mlp_init(
                torch.Generator().manual_seed(0), T_MLP_CONFIG,
                device="cpu").items()}


# --- schedules and per-round helpers, array for array -----------------------

@pytest.mark.parametrize("kinds", [(kind,) for kind in KINDS] + [KINDS])
@pytest.mark.parametrize("start", [0, 3])
def test_compile_plan_identical_to_reference(kinds, start):
    kw = dict(COCKTAIL, kinds=kinds, byzantine=(1, 4, 9))
    jcfg, tcfg = FaultConfig(**kw), tbase.FaultConfig(**kw)
    jp = jfaults.compile_plan(jcfg, 5, 6, start=start)
    tp = tfaults.compile_plan(tcfg, 5, 6, start=start)
    for name in jp._fields:
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name),
                                      err_msg=name)
        assert getattr(tp, name).dtype == getattr(jp, name).dtype
    assert tp.is_noop == jp.is_noop and tp.uses_wire == jp.uses_wire
    assert tfaults.config_active(tcfg) == jfaults.config_active(jcfg)
    assert tfaults.wire_kinds(tcfg) == jfaults.wire_kinds(jcfg)


def test_zero_rate_config_is_inactive_in_both_packages():
    kw = dict(kinds=("crash", "corrupt", "byzantine", "link_drop",
                     "straggle"), crash_rate=0.0, corrupt_rate=0.0,
              drop_rate=0.0, straggle_rate=0.0, byzantine=())
    jcfg, tcfg = FaultConfig(**kw), tbase.FaultConfig(**kw)
    assert not tfaults.config_active(tcfg) and not jfaults.config_active(jcfg)
    assert tfaults.wire_kinds(tcfg) == (False, False, False)
    assert tfaults.compile_plan(tcfg, 4, 5).is_noop


@pytest.mark.parametrize("mode", ["nan", "inf", "bitflip"])
def test_corrupt_rows_bit_for_bit(mode):
    rng = np.random.default_rng(2)
    sent = (rng.standard_normal((6, 128)) * np.float32(10.0) ** rng.integers(
        -4, 3, size=(6, 128))).astype(np.float32)
    flags = np.array([0, 1, 0, 1, 1, 0], np.float32)
    want = np.asarray(jfaults.corrupt_rows(jnp.asarray(sent),
                                           jnp.asarray(flags), mode))
    got = tfaults.corrupt_rows(torch.tensor(sent), torch.tensor(flags), mode)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def _poisoned(rng, k, p, kind):
    buf = rng.standard_normal((k, p)).astype(np.float32)
    sent = buf.copy()
    if kind == "nan":
        sent[2, 5] = np.nan
    elif kind == "blown":
        sent[1] = 1e15
        sent[k - 1, 0] = -np.inf
    return buf, sent


def _assert_eta_equal(got, want, exact):
    check = (np.testing.assert_array_equal if exact else
             lambda a, b: np.testing.assert_allclose(a, b, atol=1e-6, rtol=0))
    if isinstance(got, torch.Tensor):
        check(got.numpy(), np.asarray(want))
        return
    for g, w in zip(got, want):
        if isinstance(g, tuple):
            _assert_eta_equal(g, w, exact)
        else:
            check(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("fmt", ["dense", "sparse", "hierarchical"])
@pytest.mark.parametrize("kind", ["clean", "nan", "blown"])
def test_wire_guard_matches_reference(fmt, kind):
    rng = np.random.default_rng(7)
    k, p = 12, 128
    buf, sent = _poisoned(rng, k, p, kind)
    eta = rng.random((k, k)).astype(np.float32)
    np.fill_diagonal(eta, 0.0)
    eta[rng.random((k, k)) < 0.4] = 0.0
    eta[3] = 0.0
    if fmt == "dense":
        jeta, teta = jnp.asarray(eta), torch.tensor(eta)
    else:
        jsp = jtopo.sparsify_eta(jnp.asarray(eta), 4)
        tsp = convert.sparse_eta_from_numpy(jsp, "cpu")
        jeta, teta = jsp, tsp
        if fmt == "hierarchical":
            jinter = jtopo.sparsify_eta(jnp.asarray(eta.T.copy()), 2)
            jeta = jhier.HierEta(
                cluster=jnp.zeros(k, jnp.int32), intra=jsp,
                gamma_node=jnp.full(k, 0.5), inter=jinter,
                burst=jnp.zeros(()))
            teta = convert.hier_eta_from_numpy(jeta, "cpu")
    js, je, jq = jfaults.wire_guard(jnp.asarray(sent), jnp.asarray(buf), jeta)
    ts, te, tq = tfaults.wire_guard(torch.tensor(sent), torch.tensor(buf),
                                    teta)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if fmt == "hierarchical":
        te, je = (te.intra, te.inter), (je.intra, je.inter)
    _assert_eta_equal(te, je, exact=kind == "clean")
    if kind == "clean":
        assert not tq.any()
        assert ts is not None and torch.equal(ts, torch.tensor(sent))
    else:
        assert tq.sum() >= 1


def test_wire_guard_threshold_off_keeps_finite_blown_rows():
    buf = torch.ones((3, 4))
    blown = buf.clone()
    blown[1] = 1e15
    eta = torch.full((3, 3), 0.3)
    _, _, bad = tfaults.wire_guard(blown, buf, eta)
    assert bad.tolist() == [0.0, 1.0, 0.0]
    _, _, bad = tfaults.wire_guard(blown, buf, eta, threshold=0.0)
    assert not bad.any()


def test_masked_stacks_match_reference():
    rng = np.random.default_rng(11)
    r, k = 4, 10
    plan = jfaults.compile_plan(FaultConfig(**COCKTAIL), r, k)
    etas = rng.random((r, k, k)).astype(np.float32)
    etas[rng.random((r, k, k)) < 0.3] = 0.0
    want = jmix.masked_eta_stack(jnp.asarray(etas), plan.link_mask)
    got = tmix.masked_eta_stack(torch.tensor(etas), plan.link_mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    jsp = jtopo.SparseEta(
        jnp.asarray(np.argsort(-etas, axis=-1)[..., :4].astype(np.int32)),
        jnp.asarray(np.sort(etas, axis=-1)[..., ::-1][..., :4].copy()))
    tsp = convert.sparse_eta_from_numpy(jsp, "cpu")
    mask = torch.tensor(plan.link_mask)
    want = jmix.masked_sparse_stack(jsp, jnp.asarray(plan.link_mask))
    got = tmix.masked_sparse_stack(tsp, mask)
    assert torch.equal(got.idx, tsp.idx)
    np.testing.assert_allclose(got.val.numpy(), np.asarray(want.val),
                               atol=1e-6, rtol=0)
    jh = jhier.HierEta(cluster=jnp.zeros((r, k), jnp.int32), intra=jsp,
                       gamma_node=jnp.full((r, k), 0.5),
                       inter=jtopo.SparseEta(jsp.idx[..., :2],
                                             jsp.val[..., :2]),
                       burst=jnp.zeros((r,)))
    want = jhier.masked_hier_stack(jh, jnp.asarray(plan.link_mask))
    got = thier.masked_hier_stack(convert.hier_eta_from_numpy(jh, "cpu"),
                                  mask)
    for g, w in ((got.intra, want.intra), (got.inter, want.inter)):
        np.testing.assert_allclose(g.val.numpy(), np.asarray(w.val),
                                   atol=1e-6, rtol=0)
    # a crashed node's rows drain to zero in both tiers
    dead = plan.health == 0
    rr, kk = np.nonzero(dead)
    assert len(rr) and (got.intra.val.numpy()[rr, kk] == 0).all()


# --- the trainer under faults, against the reference ------------------------

def _jax_run(jfed, k, rounds):
    tr, state, train = _jax_trainer(jfed, k)
    init = {n: np.array(v) for n, v in state.params.items()}
    idx, rng = _jax_idx(train, k, 0, rounds)
    data, _ = _data(k)
    final, metrics = tr.run_rounds(
        state, {n: jnp.asarray(v) for n, v in data.items()}, rounds, rng=rng)
    return init, idx, final, metrics


@pytest.mark.parametrize("case", sorted(CASES))
def test_faulted_trainer_matches_reference(case):
    k, kw, rounds, tol = CASES[case]
    jfed, tfed = _configs(k, kw)
    init, idx, final, metrics = _jax_run(jfed, k, rounds)
    tr, state = _port_trainer(tfed, k, init)
    data, _ = _data(k)
    tfinal, tmetrics = tr.run_rounds(state, data, rounds, idx=idx)
    want, _ = convert.params_from_numpy(
        {n: np.asarray(v) for n, v in final.params.items()}, "cpu")
    assert torch.isfinite(tfinal.buf).all()
    np.testing.assert_allclose(tfinal.buf.numpy(), want.numpy(), atol=tol,
                               rtol=0)
    ref = convert.state_from_numpy(final, "cpu")
    np.testing.assert_allclose(tfinal.opt.m.numpy(), ref.opt.m.numpy(),
                               atol=tol, rtol=0)
    assert torch.equal(tfinal.opt.step, ref.opt.step)
    assert sorted(tmetrics) == sorted(metrics)
    for name in ("health", "quarantined", "frozen"):
        if name in metrics:
            np.testing.assert_array_equal(tmetrics[name].numpy(),
                                          np.asarray(metrics[name]),
                                          err_msg=name)
    for name in ("loss", "disagreement", "gamma", "eval"):
        np.testing.assert_allclose(tmetrics[name].numpy(),
                                   np.asarray(metrics[name]), rtol=1e-5,
                                   atol=1e-6 if tol == TOL else tol,
                                   err_msg=name)
    if tfed.faults is not None:
        plan = tfaults.compile_plan(tfed.faults, rounds, k)
        np.testing.assert_array_equal(tmetrics["health"].numpy(), plan.health)
        if tfed.faults.corrupt_mode != "bitflip":
            # every NaN/Inf frame was caught by the guard
            np.testing.assert_array_equal(tmetrics["quarantined"].numpy(),
                                          plan.corrupt)


def test_straggle_buffer_carries_across_from_the_reference():
    """3 JAX rounds, the state (with its straggle replay buffer) carried
    over, 3 port rounds: equal to 6 JAX rounds."""
    k = 8
    jfed, tfed = _configs(k, dict(faults=COCKTAIL))
    tr, state, train = _jax_trainer(jfed, k)
    data, _ = _data(k)
    jdata = {n: jnp.asarray(v) for n, v in data.items()}
    _, rng = _jax_idx(train, k, 0, 6)
    mid, _ = tr.run_rounds(state, jdata, 3, rng=rng)
    assert np.asarray(mid.fstate).shape == np.asarray(mid.opt.m).shape
    tmid = convert.state_from_numpy(mid, "cpu")
    assert isinstance(tmid.fstate, torch.Tensor) and tmid.round == 3
    final, _ = tr.run_rounds(mid, jdata, 3, rng=rng)
    ttr, _ = _port_trainer(tfed, k, _init_params(k))
    idx, _ = _jax_idx(train, k, 3, 6)
    tfinal, _ = ttr.run_rounds(tmid, data, 3, idx=idx)
    want = convert.state_from_numpy(final, "cpu")
    np.testing.assert_allclose(tfinal.buf.numpy(), want.buf.numpy(),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(tfinal.fstate.numpy(), want.fstate.numpy(),
                               atol=TOL, rtol=0)


# --- port-only invariants ---------------------------------------------------

@pytest.mark.parametrize("fmt", ["dense", "sparse", "hierarchical"])
def test_zero_rate_faults_bit_identical_to_none(fmt):
    k = 8
    kw = {"dense": {}, "sparse": dict(mixing_format="sparse", degree=3),
          "hierarchical": dict(mixing_format="hierarchical",
                               hierarchy=dict(max_cluster_size=3))}[fmt]
    quiet = dict(kinds=("crash", "link_drop"), crash_rate=0.0,
                 drop_rate=0.0)
    _, tfed = _configs(k, dict(kw, mobility=MANHATTAN))
    _, qfed = _configs(k, dict(kw, mobility=MANHATTAN, faults=quiet))
    init = _init_params(k)
    idx = np.random.default_rng(3).integers(0, N, size=(4, k, S, B))
    data, _ = _data(k)
    outs = []
    for fed in (tfed, qfed):
        tr, state = _port_trainer(fed, k, init)
        outs.append(tr.run_rounds(state, data, 4, idx=idx))
    (f0, m0), (fz, mz) = outs
    assert torch.equal(f0.buf, fz.buf)
    assert torch.equal(f0.opt.m, fz.opt.m)
    assert sorted(m0) == sorted(mz) and "health" not in mz
    for name in m0:
        assert torch.equal(m0[name], mz[name]), name


def test_crashed_nodes_freeze_params_and_adam_step():
    k = 6
    cfg = dict(kinds=("crash",), crash_rate=0.4, recover_rate=0.3, seed=3)
    _, tfed = _configs(k, dict(faults=cfg))
    plan = tfaults.compile_plan(tbase.FaultConfig(**cfg), 6, k)
    assert (plan.health == 0).any()
    tr, state = _port_trainer(tfed, k, _init_params(k))
    idx = np.random.default_rng(4).integers(0, N, size=(6, k, S, B))
    data, _ = _data(k)
    final, m = tr.run_rounds(state, data, 6, idx=idx)
    np.testing.assert_array_equal(m["health"].numpy(), plan.health)
    assert not m["frozen"].any()
    # each node stepped local_steps times per ALIVE round only
    np.testing.assert_array_equal(final.opt.step.numpy(),
                                  (S * plan.health.sum(axis=0)).astype(
                                      np.int32))
    # a node dead in the last round kept its params of that round's entry
    before, _ = tr.run_rounds(state, data, 5, idx=idx[:5])
    dead = np.nonzero(plan.health[5] == 0)[0]
    assert len(dead)
    assert torch.equal(final.buf[dead], before.buf[dead])
    assert torch.equal(final.opt.v[dead], before.opt.v[dead])
    assert torch.isfinite(m["loss"]).all()


@pytest.mark.parametrize("kw", [dict(),
                                dict(mixing_format="hierarchical",
                                     hierarchy=dict(max_cluster_size=4),
                                     mobility=MANHATTAN),
                                dict(robust="trimmed_mean")])
def test_three_plus_three_rounds_equal_six(kw):
    k = 8
    _, tfed = _configs(k, dict(kw, faults=COCKTAIL))
    tr, state = _port_trainer(tfed, k, _init_params(k))
    assert isinstance(state.fstate, torch.Tensor)
    idx = np.random.default_rng(5).integers(0, N, size=(6, k, S, B))
    data, _ = _data(k)
    whole, mw = tr.run_rounds(state, data, 6, idx=idx)
    half, m1 = tr.run_rounds(state, data, 3, idx=idx[:3])
    rest, m2 = tr.run_rounds(half, data, 3, idx=idx[3:])
    assert torch.equal(rest.buf, whole.buf)
    assert torch.equal(rest.fstate, whole.fstate)
    assert torch.equal(rest.opt.step, whole.opt.step)
    for name in mw:
        assert torch.equal(torch.cat([m1[name], m2[name]]), mw[name]), name


def test_reference_refusals():
    loss = tsimple.make_mlp_loss(T_MLP_CONFIG)
    crash = tbase.FaultConfig(kinds=("crash",))
    with pytest.raises(ValueError, match="no full-buffer wire exchange"):
        tcdfl.build_trainer(loss, tbase.FedConfig(algorithm="fedavg",
                                                  faults=crash),
                            tbase.TrainConfig(), device="cpu")
    with pytest.raises(ValueError, match="robust aggregation"):
        tcdfl.build_trainer(loss, tbase.FedConfig(algorithm="fedavg",
                                                  robust="median"),
                            tbase.TrainConfig(), device="cpu")
    for fmt in ("sparse", "hierarchical"):
        with pytest.raises(ValueError, match="robust"):
            tbase.FedConfig(num_nodes=16, mixing_format=fmt,
                            robust="trimmed_mean")
    with pytest.raises(ValueError, match="krum"):
        tbase.FedConfig(robust="krum")
    with pytest.raises(ValueError, match="meteor_strike"):
        tbase.FaultConfig(kinds=("meteor_strike",))
    with pytest.raises(ValueError):
        tbase.FaultConfig(kinds=("crash",), crash_rate=1.5)
    with pytest.raises(ValueError):
        tbase.FaultConfig(kinds=("corrupt",), corrupt_mode="xor")
    with pytest.raises(ValueError):
        tbase.FaultConfig(byzantine=(-1,))
    assert not tbase.FaultConfig().active


def test_config_defaults_match_reference():
    assert dataclasses.asdict(tbase.FaultConfig()) == \
        dataclasses.asdict(FaultConfig())
