"""The redundancy-aware ingest of the port against the JAX package's, on the
CPU (the port through its plain kernel versions):

* ``IngestConfig`` validation, the scenario plans (``compile_plan``) and
  their gathers, and the slots' sketch coordinates (``slot_hashes``, with
  the port's shift-ladder ``clz``): identical arrays;
* the sketches: count-min counters, HLL registers and multiplicities equal
  while ``decay == 1`` (integer-valued); with ``decay < 1`` the port's one
  add of each bucket's hit count is within 2 ulps of the reference's adds of
  1.0; HLL estimates at rtol 1e-6;
* ``reweight_eta`` dense and sparse, ``scale_eta_columns``,
  ``drift_novelty``, ``sampling_weights``, ``weighted_indices`` (equal
  indices) and the ``"redundancy"`` mixing policy;
* ``build_trainer -> run_rounds`` over 3 rounds within 1e-5 from the same
  initial params and batch indices (the reference's uniforms under
  duplicate-corrected sampling): ``duplicate_heavy`` with ``weighting=
  "both"`` and drift detection, sparse ``sensor_overlap`` on the K=16
  Manhattan fleet, ``skewed_multiset`` under a crash and corrupt plan;
* the leftovers of ``core/sketch.py`` (union and difference estimates,
  SimHash, ``sketch_dataset``, the scatter-free bitmaps);
* in the port alone: 2 + 2 rounds equal 4 bit for bit, a resumed Session
  equals a straight one bit for bit, a batched run (V=2) equals its single
  runs, ``scenario="none"`` equals no ingest bit for bit, the
  ``IngestCallback`` line, and the reference's refusals.

The JAX runs are shared through a module-scoped fixture."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import experiment as jexp
from repro.configs.base import (FaultConfig, FedConfig, IngestConfig,
                                MobilityConfig, TrainConfig)
from repro.configs.paper_models import MLP_CONFIG
from repro.core import sketch as jsketch
from repro.core import topology as jtopo
from repro.core.cdfl import build_trainer
from repro.data import pipeline, synthetic
from repro.ingest import scenarios as jscen
from repro.ingest import sketches as jsk
from repro.ingest import weighting as jw
from repro.models import simple
from repro_torch import convert
from repro_torch import experiment as texp
from repro_torch.configs import base as tbase
from repro_torch.configs.paper_models import MLP_CONFIG as T_MLP_CONFIG
from repro_torch.core import cdfl as tcdfl
from repro_torch.core import flatten as tflat
from repro_torch.core import sketch as tsketch
from repro_torch.core import topology as ttopo
from repro_torch.ingest import scenarios as tscen
from repro_torch.ingest import sketches as tsk
from repro_torch.ingest import weighting as tw
from repro_torch.models import simple as tsimple

S, B, N = 2, 8, 64
TOL = 1e-5
MANHATTAN = dict(kind="manhattan", speed=10.0, radio_range=500.0,
                 area=800.0, dt=2.0, seed=0)
FAULTS = dict(kinds=("crash", "corrupt"), crash_rate=0.3, recover_rate=0.5,
              corrupt_rate=0.3, seed=2)
SCENARIOS = ("duplicate_heavy", "sensor_overlap", "skewed_multiset")

# name -> (K, FedConfig keywords, IngestConfig keywords)
CASES = {
    "duplicate-both-drift": (8, dict(), dict(
        scenario="duplicate_heavy", weighting="both", decay=0.8,
        drift_threshold=0.3)),
    "sparse-sensor-overlap": (16, dict(
        mixing_format="sparse", degree=5, mobility=MANHATTAN), dict(
        scenario="sensor_overlap", overlap_window=16, spread_gate=1.05)),
    "skewed-faults": (8, dict(faults=FAULTS), dict(
        scenario="skewed_multiset", weighting="mixing", spread_gate=1.05)),
}
ROUNDS = 3
_DATA = {}


def _data(k):
    """Clean MNIST-like nodes: the scenario's plan makes the redundancy."""
    if k not in _DATA:
        nodes = [synthetic.synthetic_mnist(seed=i, n=N, noise=2.0)
                 for i in range(k)]
        data = {"x": np.stack([d.x for d in nodes]),
                "y": np.stack([d.y for d in nodes])}
        items = pipeline.FederatedBatcher(nodes, B, S, seed=0).node_items()
        _DATA[k] = data, items
    return _DATA[k]


def _configs(k, kw, ikw):
    kw = dict({"gamma": 0.5}, **kw, num_nodes=k, local_steps=S)
    jkw, tkw = dict(kw), dict(kw)
    for name, jcls, tcls in (
            ("mobility", MobilityConfig, tbase.MobilityConfig),
            ("faults", FaultConfig, tbase.FaultConfig)):
        if name in kw:
            jkw[name], tkw[name] = jcls(**kw[name]), tcls(**kw[name])
    return (FedConfig(ingest=IngestConfig(**ikw), **jkw),
            tbase.FedConfig(ingest=tbase.IngestConfig(**ikw), **tkw))


def _jax_inputs(fed, k, rng, lo, hi):
    """What the reference's scan draws for rounds [lo, hi): indices, or
    uniforms under duplicate-corrected sampling."""
    keys = jax.vmap(lambda r: jax.random.fold_in(rng, r))(jnp.arange(lo, hi))
    if fed.ingest.correct_sampling:
        return np.array(jax.vmap(lambda kk: jax.random.uniform(
            kk, (k, S, B)))(keys))
    return np.array(jax.vmap(lambda kk: jax.random.randint(
        kk, (k, S, B), 0, N))(keys))


def _jax_run(jfed, k):
    data, items = _data(k)
    train = TrainConfig(learning_rate=1e-3, batch_size=B)
    loss = simple.make_mlp_loss(MLP_CONFIG)
    tr = build_trainer(lambda p, b: loss(p, b), jfed, train)
    state = tr.init(jax.random.PRNGKey(0),
                    lambda r: simple.mlp_init(r, MLP_CONFIG),
                    jnp.asarray(items))
    init = {n: np.array(v) for n, v in state.params.items()}
    rng = jax.random.PRNGKey(train.seed + 1)
    idx = _jax_inputs(jfed, k, rng, 0, ROUNDS)
    final, metrics = tr.run_rounds(
        state, {n: jnp.asarray(v) for n, v in data.items()}, ROUNDS,
        rng=rng)
    return init, idx, final, {n: np.asarray(v) for n, v in metrics.items()}


@pytest.fixture(scope="module")
def reference_runs():
    return {name: _jax_run(_configs(k, kw, ikw)[0], k)
            for name, (k, kw, ikw) in CASES.items()}


def _port_trainer(tfed, k, init):
    _, items = _data(k)
    tr = tcdfl.build_trainer(
        tsimple.make_mlp_loss(T_MLP_CONFIG), tfed,
        tbase.TrainConfig(learning_rate=1e-3, batch_size=B), device="cpu")
    buf, layout = convert.params_from_numpy(init, "cpu")
    return tr, tr.init(tflat.unflatten(buf, layout), items, same_init=False)


def _init_params(k, seed=1):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal((k,) + tuple(v.shape)).astype(np.float32)
            * 0.1 for n, v in tsimple.mlp_init(
                torch.Generator().manual_seed(0), T_MLP_CONFIG,
                device="cpu").items()}


# --- configs, plans, hashes -----------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(weighting="sometimes"), dict(duplicate_fraction=1.5),
    dict(cm_hashes=0), dict(hll_registers=100), dict(hll_registers=8),
    dict(decay=0.0), dict(spread_gate=0.5), dict(overlap_window=0),
    dict(zipf_alpha=0.0), dict(drift_threshold=2.0), dict(drift_mode="x"),
    dict(drift_discount=-1.0), dict(drift_threshold=0.2),
    dict(affected=(-1,)), dict(scenario="nope"),
])
def test_ingest_config_refusals_match_reference(kw):
    with pytest.raises(ValueError):
        IngestConfig(**kw)
    with pytest.raises(ValueError):
        tbase.IngestConfig(**kw)


def test_ingest_config_properties_match_reference():
    for weighting in ("none", "mixing", "sampling", "both"):
        for kw in (dict(), dict(scenario="duplicate_heavy", decay=0.5,
                                drift_threshold=0.4)):
            j = IngestConfig(weighting=weighting, **kw)
            t = tbase.IngestConfig(weighting=weighting, **kw)
            for prop in ("active", "reweight_mixing", "correct_sampling",
                         "drift_on"):
                assert getattr(t, prop) == getattr(j, prop), prop


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("kw", [dict(), dict(affected=(0, 3), seed=5,
                                             duplicate_fraction=0.6,
                                             overlap_window=7,
                                             zipf_alpha=1.7)])
def test_compile_plan_and_apply_plan_identical_to_reference(scenario, kw):
    k, n = 6, 40
    jp = jscen.compile_plan(IngestConfig(scenario=scenario, **kw), k, n)
    tp = tscen.compile_plan(tbase.IngestConfig(scenario=scenario, **kw), k, n)
    for name in jp._fields:
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name))
        assert getattr(tp, name).dtype == getattr(jp, name).dtype
    rng = np.random.default_rng(0)
    data = {"x": rng.standard_normal((k, n, 3)).astype(np.float32),
            "y": rng.integers(0, 10, (k, n)).astype(np.int32)}
    want = jscen.apply_plan({m: jnp.asarray(v) for m, v in data.items()}, jp)
    got = tscen.apply_plan({m: torch.tensor(v) for m, v in data.items()}, tp)
    for m in data:
        np.testing.assert_array_equal(got[m].numpy(), np.asarray(want[m]))


def test_affected_out_of_range_is_refused_in_both():
    for mod, cls in ((jscen, IngestConfig), (tscen, tbase.IngestConfig)):
        with pytest.raises(ValueError, match="out of range"):
            mod.compile_plan(cls(scenario="duplicate_heavy", affected=(9,)),
                             4, 10)


def test_clz_matches_lax_clz():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.integers(0, 2 ** 32, 2000, dtype=np.uint64),
                        [0, 1, 2, 3, 2 ** 31, 2 ** 32 - 1],
                        2 ** np.arange(32, dtype=np.uint64)]).astype(np.uint32)
    want = np.asarray(jax.lax.clz(jnp.asarray(x)))
    got = tsk._clz32(torch.tensor(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", [dict(), dict(cm_hashes=3, cm_width=500,
                                             hll_registers=16),
                                dict(hll_registers=64)])
def test_slot_hashes_identical_to_reference(kw):
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 2 ** 31 - 1, (5, 33)).astype(np.int32)
    ids[0, :3] = [0, 1, 2 ** 31 - 1]
    jcfg, tcfg = IngestConfig(**kw), tbase.IngestConfig(**kw)
    want = jsk.slot_hashes(jnp.asarray(ids), jcfg)
    got = tsk.slot_hashes(torch.tensor(ids), tcfg)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


# --- sketches and weights -------------------------------------------------------

def _sketch_inputs(k=5, n=40, cfg_kw=None, seed=2):
    cfg_kw = cfg_kw or dict(cm_width=64, hll_registers=32)
    jcfg = IngestConfig(scenario="duplicate_heavy", **cfg_kw)
    tcfg = tbase.IngestConfig(scenario="duplicate_heavy", **cfg_kw)
    plan = tscen.compile_plan(tcfg, k, n)
    rng = np.random.default_rng(seed)
    idx = [rng.integers(0, n, (k, S, B)) for _ in range(4)]
    return (jcfg, tcfg, jsk.slot_hashes(jnp.asarray(plan.item_ids), jcfg),
            tsk.slot_hashes(torch.tensor(plan.item_ids), tcfg), idx)


@pytest.mark.parametrize("decay", [1.0, 0.7])
def test_sketch_updates_match_reference(decay):
    jcfg, tcfg, jsh, tsh, idx = _sketch_inputs()
    jst, tst = jsk.init_state(5, jcfg), tsk.init_state(5, tcfg, "cpu")
    for i in idx:
        jst = jsk.update(jst, jsh, jnp.asarray(i, jnp.int32), decay=decay)
        tst = tsk.update(tst, tsh, torch.tensor(i), decay=decay)
        np.testing.assert_array_equal(tst.hll.numpy(), np.asarray(jst.hll))
        np.testing.assert_array_equal(tst.seen.numpy(), np.asarray(jst.seen))
        jcm, tcm = np.asarray(jst.cm), tst.cm.numpy()
        jm = np.asarray(jsk.multiplicity(jst.cm, jsh.buckets))
        tm = tsk.multiplicity(tst.cm, tsh.buckets).numpy()
        if decay == 1.0:
            # whole counts: the port's one add of the hit count is exact
            np.testing.assert_array_equal(tcm, jcm)
            np.testing.assert_array_equal(tm, jm)
        else:
            # one add of the hit count against adds of 1.0, one at a time
            ulp = np.spacing(np.maximum(np.abs(jcm), 1.0).astype(np.float32))
            assert (np.abs(tcm - jcm) <= 2 * ulp).all()
            np.testing.assert_allclose(tm, jm, rtol=1e-6, atol=0)
        np.testing.assert_allclose(
            tsk.hll_cardinality(tst.hll).numpy(),
            np.asarray(jsk.hll_cardinality(jst.hll)), rtol=1e-6)


@pytest.mark.parametrize("m", [16, 32, 64, 256])
def test_hll_cardinality_matches_reference(m):
    rng = np.random.default_rng(m)
    regs = rng.integers(0, 12, (6, m)).astype(np.int32)
    regs[0] = 0                                   # empty sketch
    regs[1, : m // 2] = 0                         # small-range correction
    regs[2] = rng.integers(5, 20, m)              # raw estimate
    np.testing.assert_allclose(
        tsk.hll_cardinality(torch.tensor(regs)).numpy(),
        np.asarray(jsk.hll_cardinality(jnp.asarray(regs))), rtol=1e-6)


def _eta(k=8, seed=0):
    rng = np.random.default_rng(seed)
    adj = jtopo.adjacency("erdos", k, seed=seed)
    eta = np.asarray(jtopo.mixing_weights(jnp.asarray(adj), "cnd",
                                          ratios=jnp.asarray(rng.uniform(
                                              0.2, 1.0, k), jnp.float32)))
    return eta


@pytest.mark.parametrize("fmt", ["dense", "sparse"])
@pytest.mark.parametrize("spread", ["below-gate", "above-gate"])
def test_reweight_and_scale_columns_match_reference(fmt, spread):
    k = 8
    eta = _eta(k)
    rng = np.random.default_rng(5)
    est = (rng.uniform(100, 110, k) if spread == "below-gate"
           else rng.uniform(10, 400, k)).astype(np.float32)
    scale = np.where(rng.random(k) < 0.3, 0.5, 1.0).astype(np.float32)
    scale[2] = 0.0
    jeta, teta = jnp.asarray(eta), torch.tensor(eta)
    if fmt == "sparse":
        jeta = jtopo.sparsify_eta(jeta, 3)
        teta = convert.sparse_eta_from_numpy(jeta, "cpu")
    for jfn, tfn in ((lambda e: jw.reweight_eta(e, jnp.asarray(est), 1.5),
                      lambda e: tw.reweight_eta(e, torch.tensor(est), 1.5)),
                     (lambda e: jw.scale_eta_columns(e, jnp.asarray(scale)),
                      lambda e: tw.scale_eta_columns(e, torch.tensor(scale)))):
        want, got = jfn(jeta), tfn(teta)
        if fmt == "sparse":
            assert torch.equal(got.idx, teta.idx)
            want, got = want.val, got.val
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    got = tw.reweight_eta(teta, torch.tensor(est), 1.5)
    passed = torch.equal(got if fmt == "dense" else got.val,
                         teta if fmt == "dense" else teta.val)
    assert passed == (spread == "below-gate")
    # no discounted column: bit-exact pass-through
    ones = tw.scale_eta_columns(teta, torch.ones(k))
    assert torch.equal(ones if fmt == "dense" else ones.val,
                       teta if fmt == "dense" else teta.val)


def test_reweight_takes_a_variant_axis():
    """(V, K) estimates scale a shared eta or table into one a variant,
    each equal to its own single reweight."""
    k = 8
    eta = torch.tensor(_eta(k))
    sp = ttopo.sparsify_eta(eta, 3)
    est = torch.tensor(np.random.default_rng(1).uniform(10, 400, (2, k)),
                       dtype=torch.float32)
    dense = tw.reweight_eta(eta, est, 1.5)
    sparse = tw.reweight_eta(sp, est, 1.5)
    assert tuple(dense.shape) == (2, k, k)
    for v in range(2):
        assert torch.equal(dense[v], tw.reweight_eta(eta, est[v], 1.5))
        assert torch.equal(sparse.val[v],
                           tw.reweight_eta(sp, est[v], 1.5).val)


def test_weights_indices_and_novelty_match_reference():
    k, n = 6, 40
    rng = np.random.default_rng(9)
    mult = rng.integers(0, 5, (k, n)).astype(np.float32)
    n_items = np.array([40, 33, 40, 12, 1, 40])
    want_w = np.asarray(jw.sampling_weights(jnp.asarray(mult),
                                            jnp.asarray(n_items), n))
    got_w = tw.sampling_weights(torch.tensor(mult), torch.tensor(n_items), n)
    np.testing.assert_array_equal(got_w.numpy(), want_w)
    np.testing.assert_array_equal(
        tw.sampling_weights(torch.tensor(mult), None, n).numpy(),
        np.asarray(jw.sampling_weights(jnp.asarray(mult), None, n)))
    u = rng.random((k, S, 64)).astype(np.float32)
    want_i = np.asarray(jw.weighted_indices(jnp.asarray(u),
                                            jnp.asarray(want_w)))
    got_i = tw.weighted_indices(torch.tensor(u), got_w)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    assert (got_i.numpy() < n_items[:, None, None]).all()
    idx = rng.integers(0, n, (k, S, B))
    np.testing.assert_array_equal(
        tw.drift_novelty(torch.tensor(mult), torch.tensor(idx)).numpy(),
        np.asarray(jw.drift_novelty(jnp.asarray(mult), jnp.asarray(idx))))


def test_redundancy_mixing_policy_matches_reference():
    k = 8
    rng = np.random.default_rng(4)
    adj = jtopo.adjacency("erdos", k, seed=1)
    ratios = rng.uniform(0.1, 1.0, k).astype(np.float32)
    sizes = rng.uniform(10, 400, k).astype(np.float32)
    want = jtopo.mixing_weights(jnp.asarray(adj), "redundancy",
                                ratios=jnp.asarray(ratios),
                                sizes=jnp.asarray(sizes))
    got = ttopo.mixing_weights(torch.tensor(adj), "redundancy",
                               ratios=torch.tensor(ratios),
                               sizes=torch.tensor(sizes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(
        tw.redundancy_mixing(torch.tensor(adj), torch.tensor(ratios),
                             torch.tensor(sizes)).numpy(),
        np.asarray(jw.redundancy_mixing(jnp.asarray(adj),
                                        jnp.asarray(ratios),
                                        jnp.asarray(sizes))),
        rtol=0, atol=1e-6)


# --- the trainer, against the reference --------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_trainer_matches_reference(reference_runs, case):
    k, kw, ikw = CASES[case]
    _, tfed = _configs(k, kw, ikw)
    init, idx, final, metrics = reference_runs[case]
    tr, state = _port_trainer(tfed, k, init)
    data, _ = _data(k)
    tfinal, tmetrics = tr.run_rounds(state, data, ROUNDS, idx=idx)
    ref = convert.state_from_numpy(final, "cpu")
    assert torch.isfinite(tfinal.buf).all()
    np.testing.assert_allclose(tfinal.buf.numpy(), ref.buf.numpy(),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(tfinal.opt.m.numpy(), ref.opt.m.numpy(),
                               atol=TOL, rtol=0)
    # the sketches: registers and counts of the same sampled slots
    np.testing.assert_array_equal(tfinal.istate.hll.numpy(),
                                  ref.istate.hll.numpy())
    np.testing.assert_array_equal(tfinal.istate.seen.numpy(),
                                  ref.istate.seen.numpy())
    np.testing.assert_allclose(tfinal.istate.cm.numpy(),
                               ref.istate.cm.numpy(), rtol=1e-6, atol=0)
    assert sorted(tmetrics) == sorted(metrics)
    np.testing.assert_allclose(tmetrics["est_distinct"].numpy(),
                               metrics["est_distinct"], rtol=1e-6)
    for name in ("drift", "health", "quarantined", "frozen"):
        if name in metrics:
            np.testing.assert_array_equal(tmetrics[name].numpy(),
                                          metrics[name], err_msg=name)
    for name in ("loss", "disagreement", "gamma"):
        np.testing.assert_allclose(tmetrics[name].numpy(), metrics[name],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    if "drift" in metrics:
        assert (metrics["drift"][1:] > 0).any()


def test_ingest_none_is_bit_identical_to_no_ingest():
    k = 6
    init = _init_params(k)
    idx = np.random.default_rng(3).integers(0, N, size=(3, k, S, B))
    data, _ = _data(k)
    outs = []
    for ing in (None, tbase.IngestConfig(scenario="none",
                                         weighting="both")):
        fed = tbase.FedConfig(num_nodes=k, local_steps=S, ingest=ing)
        tr, state = _port_trainer(fed, k, init)
        assert state.istate == ()
        outs.append(tr.run_rounds(state, data, 3, idx=idx))
    (f0, m0), (f1, m1) = outs
    assert torch.equal(f0.buf, f1.buf) and sorted(m0) == sorted(m1)
    assert "est_distinct" not in m1


@pytest.mark.parametrize("case", ["duplicate-both-drift", "skewed-faults"])
def test_two_plus_two_rounds_equal_four_bit_for_bit(case):
    k, kw, ikw = CASES[case]
    _, tfed = _configs(k, kw, ikw)
    init = _init_params(k)
    rng = np.random.default_rng(3)
    idx = (rng.random((4, k, S, B)).astype(np.float32)
           if tfed.ingest.correct_sampling
           else rng.integers(0, N, size=(4, k, S, B)))
    data, _ = _data(k)
    tr, state = _port_trainer(tfed, k, init)
    straight, m4 = tr.run_rounds(state, data, 4, idx=idx)
    half, m2 = tr.run_rounds(state, data, 2, idx=idx[:2])
    twice, m2b = tr.run_rounds(half, data, 2, idx=idx[2:])
    assert torch.equal(straight.buf, twice.buf)
    for a, b in zip(straight.istate, twice.istate):
        assert torch.equal(a, b)
    for name in m4:
        if name != "gamma":
            assert torch.equal(m4[name], torch.cat([m2[name], m2b[name]])), \
                name


def _experiment(k, ikw, **kw):
    fed = tbase.FedConfig(num_nodes=k, local_steps=S,
                          ingest=tbase.IngestConfig(**ikw), **kw)
    return texp.Experiment.from_parts(
        tsimple.make_mlp_loss(T_MLP_CONFIG),
        lambda g: tsimple.mlp_init(g, T_MLP_CONFIG, device="cpu"), fed=fed,
        train=tbase.TrainConfig(learning_rate=1e-3, batch_size=B),
        device="cpu")


def test_resumed_ingest_session_equals_a_straight_one(tmp_path, capsys):
    """run(3) + save + resume + run(3) == run(6) bit for bit, the session
    drawing round r's uniforms from (seed, r); the IngestCallback prints
    its line."""
    k = 6
    data, items = _data(k)
    exp = _experiment(k, CASES["duplicate-both-drift"][2])
    straight = exp.compile(data, items).run(
        6, callbacks=[texp.IngestCallback()])
    line = capsys.readouterr().out.strip()
    assert line.startswith(f"ingest: rounds=6 nodes={k} est_distinct=[")
    u = exp.compile(data, items).batch_indices(0, 2)
    assert u.dtype == torch.float32 and float(u.max()) < 1.0
    first = exp.compile(data, items)
    first.run(3)
    first.save(str(tmp_path / "ckpt"))
    resumed = exp.compile(data, items).resume(str(tmp_path / "ckpt"))
    for a, b in zip(resumed.state.istate, first.state.istate):
        assert a.dtype == b.dtype and torch.equal(a, b)
    second = resumed.run(3)
    assert torch.equal(second.state.buf, straight.state.buf)
    for a, b in zip(second.state.istate, straight.state.istate):
        assert torch.equal(a, b)
    for name in ("loss", "est_distinct", "drift"):
        assert torch.equal(second.metrics[name],
                           straight.metrics[name][3:]), name


def test_ingest_callback_line_equals_the_reference():
    est = np.array([[31.2, 12.0, 40.5], [33.9, 13.3, 44.1]], np.float32)
    lines = []
    result = texp.RunResult(state=None, metrics={
        "est_distinct": torch.tensor(est)}, rounds=2, wall_time_s=0.0)
    texp.IngestCallback(lines.append).on_run_end(None, result)
    jresult = jexp.RunResult(state=None, metrics={"est_distinct": est},
                             rounds=2, wall_time_s=0.0)
    jexp.IngestCallback(lines.append).on_run_end(None, jresult)
    assert lines[0] == lines[1]
    texp.IngestCallback(lines.append).on_run_end(None, dataclasses.replace(
        result, metrics={}))
    assert len(lines) == 2


@pytest.mark.parametrize("ikw,kw", [
    (dict(scenario="duplicate_heavy", weighting="both", decay=0.8,
          drift_threshold=0.3), dict()),
    (dict(scenario="sensor_overlap", spread_gate=1.05),
     dict(mixing_format="sparse", degree=2)),
], ids=["both-drift", "sparse-mixing"])
def test_batched_ingest_matches_its_single_runs(ikw, kw):
    k, rounds = 4, 3
    data, items = _data(k)
    exp = _experiment(k, ikw, **kw)
    batched = exp.compile_batch(data, items, texp.SweepAxes(seeds=[2, 5]))
    result = batched.run_batch(rounds)
    assert tuple(result.metrics["est_distinct"].shape) == (2, rounds, k)
    for i, seed in enumerate((2, 5)):
        single = exp.compile(data, items, rng=seed,
                             sample_rng=seed + 1).run(rounds)
        torch.testing.assert_close(result.state.buf[i], single.state.buf,
                                   rtol=0, atol=TOL)
        for name in single.metrics:
            torch.testing.assert_close(result.metrics[name][i],
                                       single.metrics[name], rtol=0,
                                       atol=TOL, msg=name)
        assert torch.equal(result.state.istate.hll[i],
                           single.state.istate.hll)


@pytest.mark.parametrize("kw,ikw", [
    (dict(algorithm="fedavg"), dict(weighting="mixing")),
    (dict(algorithm="fedavg"), dict(weighting="none", decay=0.5,
                                    drift_threshold=0.2)),
    (dict(robust="median"), dict(weighting="both")),
])
def test_refusals_raise_the_reference_exception(kw, ikw):
    ikw = dict(ikw, scenario="duplicate_heavy")
    jfed, tfed = (FedConfig(num_nodes=4, ingest=IngestConfig(**ikw), **kw),
                  tbase.FedConfig(num_nodes=4,
                                  ingest=tbase.IngestConfig(**ikw), **kw))
    with pytest.raises(Exception) as want:
        build_trainer(simple.make_mlp_loss(MLP_CONFIG), jfed, TrainConfig())
    with pytest.raises(Exception) as got:
        tcdfl.build_trainer(tsimple.make_mlp_loss(T_MLP_CONFIG), tfed,
                            tbase.TrainConfig(), device="cpu")
    assert got.type is want.type, (got.value, want.value)


def test_round_refuses_ingest_and_sampling_needs_uniforms():
    k = 4
    _, tfed = _configs(k, {}, CASES["duplicate-both-drift"][2])
    tr, state = _port_trainer(tfed, k, _init_params(k))
    batches = {"x": torch.zeros((k, S, B, 784)),
               "y": torch.zeros((k, S, B), dtype=torch.int32)}
    with pytest.raises(ValueError, match="streaming-redundancy"):
        tr.round(state, batches)
    data, _ = _data(k)
    with pytest.raises(ValueError, match="uniforms"):
        tr.run_rounds(state, data, 1, idx=np.zeros((1, k, S, B), np.int64))


# --- core/sketch.py leftovers -----------------------------------------------------

def test_sketch_leftovers_match_reference():
    rng = np.random.default_rng(6)
    a = rng.integers(0, 300, (120, 4)).astype(np.int32)
    b = rng.integers(200, 500, (90, 4)).astype(np.int32)
    m = 1024
    jbm_a, jbm_b = (jsketch.build_bitmaps(jnp.asarray(x), 3, m)
                    for x in (a, b))
    tbm_a, tbm_b = (tsketch.build_bitmaps(torch.tensor(x), 3, m)
                    for x in (a, b))
    np.testing.assert_array_equal(
        tsketch.build_bitmaps_onehot(torch.tensor(a), 3, m,
                                     block_items=32).numpy(),
        np.asarray(jsketch.build_bitmaps_onehot(jnp.asarray(a), 3, m,
                                                block_items=32))
        .view(np.int32))
    for est in ("paper_mean", "linear_counting"):
        np.testing.assert_allclose(
            float(tsketch.union_cardinality(tbm_a, tbm_b, est)),
            float(jsketch.union_cardinality(jbm_a, jbm_b, est)), rtol=1e-6)
        np.testing.assert_allclose(
            float(tsketch.difference_estimate(tbm_a, tbm_b, est)),
            float(jsketch.difference_estimate(jbm_a, jbm_b, est)),
            rtol=1e-5, atol=1e-3)
    w = rng.uniform(0.1, 2.0, a.shape).astype(np.float32)
    for weights, bits in ((None, 64), (w, 64), (None, 40)):
        want = jsketch.simhash(jnp.asarray(a), None if weights is None
                               else jnp.asarray(weights), bits)
        got = tsketch.simhash(torch.tensor(a), None if weights is None
                              else torch.tensor(weights), bits)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sa, sb = tsketch.simhash(torch.tensor(a)), tsketch.simhash(
        torch.tensor(b))
    assert int(tsketch.signature_distance(sa, sb)) == int(
        jsketch.signature_distance(jsketch.simhash(jnp.asarray(a)),
                                   jsketch.simhash(jnp.asarray(b))))
    got = tsketch.sketch_dataset(torch.tensor(a), 3, m, 32)
    want = jsketch.sketch_dataset(jnp.asarray(a), 3, m, 32)
    np.testing.assert_array_equal(got["bitmaps"].numpy(),
                                  np.asarray(want["bitmaps"]).view(np.int32))
    np.testing.assert_array_equal(got["signature"].numpy(),
                                  np.asarray(want["signature"]))
    assert int(got["total"]) == int(want["total"]) == 120
    assert tsketch.expected_load_factor(300, 1024) == \
        jsketch.expected_load_factor(300, 1024)
