"""The port's mobility subsystem against the JAX package: the numpy copies
of the traces and links give identical arrays, and the per-round dense and
sparse mixing stacks and their gammas agree within 1e-6, on the same
scenarios, for every built-in rule, sliced at any start round."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import mobility as jmob
from repro.configs.base import MobilityConfig as JMobilityConfig
from repro.core import topology as jtopo
from repro_torch import mobility as tmob
from repro_torch.configs.base import MobilityConfig as TMobilityConfig
from repro_torch.core import topology as ttopo
from repro_torch.registry import mobility_traces

RULES = ["cnd", "datasize", "uniform", "metropolis"]
K = 9
RATIOS = np.array([0.1, 0.9, 0.4, 0.7, 0.2, 1.0, 0.5, 0.3, 0.8], np.float32)
SIZES = np.array([10, 80, 40, 5, 60, 20, 33, 70, 50], np.float32)
SCENARIOS = {
    "platoon": dict(kind="platoon", speed=25.0, speed_jitter=0.4,
                    radio_range=300.0, dt=5.0, seed=3,
                    link_quality="quadratic"),
    "manhattan": dict(kind="manhattan", speed=10.0, radio_range=500.0,
                      area=800.0, dt=2.0, seed=0),
    "waypoint": dict(kind="waypoint", speed=30.0, radio_range=350.0,
                     seed=2),
}


def _side():
    return (dict(ratios=jnp.asarray(RATIOS), sizes=jnp.asarray(SIZES)),
            dict(ratios=torch.tensor(RATIOS), sizes=torch.tensor(SIZES)))


def test_registered_traces_match_reference():
    assert mobility_traces.names() == ("manhattan", "platoon", "waypoint")


@pytest.mark.parametrize("kind", ["platoon", "manhattan", "waypoint"])
def test_traces_are_identical(kind):
    kw = dict(speed=20.0, speed_jitter=0.3, area=600.0, dt=1.5, seed=4,
              headway=80.0)
    want = jmob.trace(kind, 14, 7, **kw)
    got = tmob.trace(kind, 14, 7, **kw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lq", ["binary", "quadratic"])
def test_links_are_identical(lq):
    pos = jmob.trace("waypoint", 8, 10, speed=30.0, area=500.0, seed=2)
    want = jmob.radio_adjacency(pos, 220.0, link_quality=lq)
    got = tmob.radio_adjacency(pos, 220.0, link_quality=lq)
    np.testing.assert_array_equal(got, want)
    mask = jtopo.adjacency("erdos", 10, seed=1, edge_prob=0.6)
    for d in (1, 3, 9):
        wi, wv = jmob.sparse_radio_stack(pos, 220.0, d, link_quality=lq,
                                         mask=mask)
        gi, gv = tmob.sparse_radio_stack(pos, 220.0, d, link_quality=lq,
                                         mask=mask)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gv, wv)
    js, ts = jmob.degree_stats(want), tmob.degree_stats(got)
    assert js.keys() == ts.keys()
    for name in js:
        np.testing.assert_array_equal(ts[name], js[name])
    assert tmob.handover_stats(got) == jmob.handover_stats(want)
    assert [tmob.num_components(a) for a in got] == \
        [jmob.num_components(a) for a in want]


def test_link_and_config_validation():
    pos = np.zeros((2, 3, 2), np.float32)
    with pytest.raises(ValueError, match="radio_range"):
        tmob.radio_adjacency(pos, -1.0)
    with pytest.raises(ValueError, match="link_quality"):
        TMobilityConfig(link_quality="psychic")
    with pytest.raises(ValueError, match="unknown mobility trace"):
        TMobilityConfig(kind="teleport")
    with pytest.raises(ValueError, match="out of range"):
        tmob.sparse_radio_stack(pos, 100.0, 3)


@pytest.mark.parametrize("rule", RULES)
def test_dense_and_sparse_stacks_match_reference(rule):
    adj = np.stack([jtopo.adjacency("erdos", K, seed=s, edge_prob=0.35)
                    for s in range(6)])
    jside, tside = _side()
    want = jmob.eta_stack(jnp.asarray(adj), rule, **jside)
    got = tmob.eta_stack(adj, rule, **tside)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(tmob.gamma_stack(got, 0.6).numpy(),
                               np.asarray(jmob.gamma_stack(want, 0.6)),
                               atol=1e-6, rtol=0)
    pos = jmob.trace("platoon", 6, K, speed=25.0, seed=5)
    idx, val = jmob.sparse_radio_stack(pos, 250.0, 4)
    jsp = jmob.sparse_eta_stack(jnp.asarray(idx), jnp.asarray(val), rule,
                                **jside)
    tsp = tmob.sparse_eta_stack(idx, val, rule, **tside)
    assert isinstance(tsp, ttopo.SparseEta) and tsp.idx.dtype == torch.int32
    np.testing.assert_array_equal(tsp.idx.numpy(), np.asarray(jsp.idx))
    np.testing.assert_allclose(tsp.val.numpy(), np.asarray(jsp.val),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        tmob.sparse_gamma_stack(tsp, 0.6).numpy(),
        np.asarray(jmob.sparse_gamma_stack(jsp, 0.6)), atol=1e-6, rtol=0)


def test_sparse_rule_refuses_custom_policies():
    with pytest.raises(ValueError, match="no sparse implementation"):
        tmob.sparse_eta_stack(np.zeros((1, 3, 1), np.int32),
                              np.zeros((1, 3, 1), np.float32), "redundancy",
                              ratios=torch.ones(3))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("start", [0, 3])
def test_scenario_stacks_match_reference(name, start):
    jmob_cfg = JMobilityConfig(**SCENARIOS[name])
    tmob_cfg = TMobilityConfig(**SCENARIOS[name])
    jside, tside = _side()
    np.testing.assert_array_equal(
        tmob.adjacency_stack(tmob_cfg, 5, K, start=start),
        jmob.adjacency_stack(jmob_cfg, 5, K, start=start))
    we, wg = jmob.scenario_stacks(jmob_cfg, 5, K, rule="cnd", gamma_cap=0.5,
                                  start=start, **jside)
    ge, gg = tmob.scenario_stacks(tmob_cfg, 5, K, rule="cnd", gamma_cap=0.5,
                                  start=start, **tside)
    np.testing.assert_allclose(ge.numpy(), np.asarray(we), atol=1e-6, rtol=0)
    np.testing.assert_allclose(gg.numpy(), np.asarray(wg), atol=1e-6, rtol=0)
    wsp, wg = jmob.sparse_scenario_stacks(
        jmob_cfg, 5, K, rule="datasize", gamma_cap=0.5, degree=3,
        start=start, **jside)
    tsp, tg = tmob.sparse_scenario_stacks(
        tmob_cfg, 5, K, rule="datasize", gamma_cap=0.5, degree=3,
        start=start, **tside)
    np.testing.assert_array_equal(tsp.idx.numpy(), np.asarray(wsp.idx))
    np.testing.assert_allclose(tsp.val.numpy(), np.asarray(wsp.val),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(tg.numpy(), np.asarray(wg), atol=1e-6, rtol=0)


def test_constant_stacks_broadcast():
    eta = ttopo.uniform_mixing(torch.tensor(jtopo.adjacency("ring", 5)))
    etas, gammas = tmob.constant_stacks(eta, torch.tensor(0.3), 7)
    assert etas.shape == (7, 5, 5) and gammas.shape == (7,)
    assert torch.equal(etas[4], eta)
    sp = ttopo.sparsify_eta(eta, 2)
    stacks, gammas = tmob.constant_sparse_stacks(sp, 0.3, 7)
    assert stacks.idx.shape == (7, 5, 2) and gammas.shape == (7,)
    assert torch.equal(stacks.val[3], sp.val)
    assert gammas[6].item() == pytest.approx(0.3)
