"""The port's hierarchical cluster consensus against the JAX package: the
numpy copies of clustering and leader election give identical arrays, the
two-tier stacks and their gammas agree within 1e-6 (indices exactly), and
the two-tier mix agrees within 1e-5 with the re-merge burst on and off,
at f32 and bf16 wires."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MobilityConfig as JMobilityConfig
from repro.core import topology as jtopo
from repro.hierarchy import clustering as jclu
from repro.hierarchy import leaders as jlead
from repro.hierarchy import mixing as jhier
from repro_torch import convert
from repro_torch.configs.base import HierarchyConfig
from repro_torch.configs.base import MobilityConfig as TMobilityConfig
from repro_torch.hierarchy import clustering as tclu
from repro_torch.hierarchy import leaders as tlead
from repro_torch.hierarchy import mixing as thier
from repro_torch.registry import leader_policies

RULES = ["cnd", "datasize", "uniform", "metropolis"]
POLICIES = ["centrality", "contact_duration", "degree"]


def _random_geometry(rng, k, rounds=3, density=0.4):
    """Random symmetric graphs and positions, dense enough to merge and
    split clusters from round to round."""
    pos = rng.uniform(0, 60, size=(rounds, k, 2)).astype(np.float32)
    adj = (rng.random((rounds, k, k)) < density).astype(np.float32)
    adj = adj * adj.transpose(0, 2, 1)
    adj[:, np.eye(k, dtype=bool)] = 0.0
    return adj, pos


def _side(rng, k):
    ratios = rng.uniform(0.2, 1.0, size=k).astype(np.float32)
    sizes = rng.uniform(20, 200, size=k).astype(np.float32)
    return (dict(ratios=jnp.asarray(ratios), sizes=jnp.asarray(sizes)),
            dict(ratios=torch.tensor(ratios), sizes=torch.tensor(sizes)))


def test_registered_leader_policies_match_reference():
    assert leader_policies.names() == tuple(POLICIES)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("hysteresis", [True, False])
def test_clustering_copies_are_identical(seed, hysteresis):
    rng = np.random.default_rng(seed)
    adj, pos = _random_geometry(rng, 14, rounds=5)
    np.testing.assert_array_equal(tclu.component_labels(adj[0]),
                                  jclu.component_labels(adj[0]))
    for p in (pos, None):
        want = jclu.cluster_stack(adj, p, max_cluster_size=4,
                                  hysteresis=hysteresis)
        got = tclu.cluster_stack(adj, p, max_cluster_size=4,
                                 hysteresis=hysteresis)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tclu.remerge_flags(got),
                                      jclu.remerge_flags(want))


@pytest.mark.parametrize("policy", POLICIES)
def test_leader_copies_are_identical(policy):
    rng = np.random.default_rng(7)
    adj, pos = _random_geometry(rng, 12, rounds=4)
    cluster = jclu.cluster_stack(adj, pos, max_cluster_size=5)
    for p in (pos, None):
        want = jlead.elect_leaders(cluster, adj, p, policy=policy)
        got = tlead.elect_leaders(cluster, adj, p, policy=policy)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tlead.leader_table(cluster, got),
                                  jlead.leader_table(cluster, want))
    np.testing.assert_array_equal(tlead.link_persistence(adj),
                                  jlead.link_persistence(adj))
    np.testing.assert_array_equal(
        tlead.local_iteration_counts(cluster, adj, base=2),
        jlead.local_iteration_counts(cluster, adj, base=2))


def _assert_hier_close(th, jh):
    np.testing.assert_array_equal(th.cluster.numpy(), np.asarray(jh.cluster))
    for t_sp, j_sp in ((th.intra, jh.intra), (th.inter, jh.inter)):
        assert t_sp.idx.dtype == torch.int32
        np.testing.assert_array_equal(t_sp.idx.numpy(), np.asarray(j_sp.idx))
        np.testing.assert_allclose(t_sp.val.numpy(), np.asarray(j_sp.val),
                                   atol=1e-6, rtol=0)
    np.testing.assert_allclose(th.gamma_node.numpy(),
                               np.asarray(jh.gamma_node), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(th.burst.numpy(), np.asarray(jh.burst))
    assert th.burst.device.type == "cpu"


@pytest.mark.parametrize("rule", RULES)
def test_geometry_and_stacks_match_reference(rule):
    rng = np.random.default_rng(RULES.index(rule))
    k = 13
    adj, pos = _random_geometry(rng, k, rounds=4)
    kw = dict(max_cluster_size=4, leader_policy="degree", inter_degree=3)
    want_geo = jhier.hier_geometry(adj, pos, **kw)
    got_geo = thier.hier_geometry(adj, pos, **kw)
    for g, w in zip(got_geo, want_geo):
        np.testing.assert_array_equal(g, w)
    jside, tside = _side(rng, k)
    jh, jg = jhier.build_hier_stacks(want_geo, rule=rule, gamma_cap=0.5,
                                     **jside)
    th, tg = thier.build_hier_stacks(got_geo, rule=rule, gamma_cap=0.5,
                                     **tside)
    _assert_hier_close(th, jh)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=0)
    np.testing.assert_allclose(thier.hier_gamma_stack(th, 0.5).numpy(),
                               np.asarray(jhier.hier_gamma_stack(jh, 0.5)),
                               atol=1e-6, rtol=0)


def test_static_and_constant_stacks_match_reference():
    rng = np.random.default_rng(4)
    k = 10
    adj = jtopo.adjacency("erdos", k, seed=3, edge_prob=0.4)
    jside, tside = _side(rng, k)
    kw = dict(rule="cnd", gamma_cap=0.6, max_cluster_size=3,
              leader_policy="centrality", inter_degree=2)
    jh, jg = jhier.hier_static_stacks(jnp.asarray(adj), **kw, **jside)
    th, tg = thier.hier_static_stacks(adj, **kw, **tside)
    _assert_hier_close(th, jh)
    assert tg.item() == pytest.approx(float(jg), abs=1e-6)
    js, jgs = jhier.constant_hier_stacks(jh, jg, 5)
    ts, tgs = thier.constant_hier_stacks(th, tg, 5)
    _assert_hier_close(ts, js)
    np.testing.assert_allclose(tgs.numpy(), np.asarray(jgs), atol=1e-6)


@pytest.mark.parametrize("start", [0, 2])
def test_scenario_stacks_match_reference(start):
    cfg = dict(kind="manhattan", speed=10.0, radio_range=300.0, area=800.0,
               dt=2.0, seed=0)
    rng = np.random.default_rng(9)
    k = 16
    jside, tside = _side(rng, k)
    kw = dict(rule="cnd", gamma_cap=0.5, max_cluster_size=4,
              leader_policy="degree", inter_degree=4, start=start)
    jh, jg = jhier.hier_scenario_stacks(JMobilityConfig(**cfg), 4, k, **kw,
                                        **jside)
    th, tg = thier.hier_scenario_stacks(TMobilityConfig(**cfg), 4, k, **kw,
                                        **tside)
    _assert_hier_close(th, jh)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=0)


@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("burst", [0.0, 1.0])
def test_hier_mix_flat_matches_reference(wire, burst):
    rng = np.random.default_rng(5)
    k, p = 12, 256
    adj, pos = _random_geometry(rng, k, rounds=1, density=0.9)
    jside, _ = _side(rng, k)
    geo = jhier.hier_geometry(adj, pos, max_cluster_size=4,
                              leader_policy="degree", inter_degree=2)
    jh, jg = jhier.build_hier_stacks(geo, rule="cnd", gamma_cap=0.5, **jside)
    jh = jhier.HierEta(jh.cluster[0], jtopo.SparseEta(jh.intra.idx[0],
                                                      jh.intra.val[0]),
                       jh.gamma_node[0], jtopo.SparseEta(jh.inter.idx[0],
                                                         jh.inter.val[0]),
                       jnp.float32(burst))
    th = convert.hier_eta_from_numpy(jh, "cpu")
    assert th.intra.val.any() and th.inter.val.any()
    buf = rng.standard_normal((k, p)).astype(np.float32)
    jw = None if wire == "f32" else jnp.asarray(buf).astype(jnp.bfloat16)
    tw = None if wire == "f32" else torch.tensor(buf).bfloat16()
    want = jhier.hier_mix_flat(jnp.asarray(buf), jh, jg[0], wire=jw,
                               wire_self=jw, use_kernel=False,
                               burst_passes=2)
    got = thier.hier_mix_flat(torch.tensor(buf), th, torch.tensor(
        np.asarray(jg[0])), wire=tw, wire_self=tw, burst_passes=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    quiet = thier.hier_mix_flat(torch.tensor(buf), th._replace(
        burst=torch.tensor(0.0)), torch.tensor(np.asarray(jg[0])), wire=tw,
        wire_self=tw, burst_passes=2)
    assert torch.equal(got, quiet) == (burst == 0.0)


def test_hierarchy_config_validation():
    assert HierarchyConfig().max_cluster_size == 16
    with pytest.raises(ValueError, match="max_cluster_size"):
        HierarchyConfig(max_cluster_size=1)
    with pytest.raises(ValueError, match="inter_degree"):
        HierarchyConfig(inter_degree=0)
    with pytest.raises(ValueError, match="remerge_burst"):
        HierarchyConfig(remerge_burst=-1)
    with pytest.raises(ValueError, match="unknown leader policy"):
        HierarchyConfig(leader_policy="oldest")
    with pytest.raises(ValueError, match="unknown mixing policy"):
        HierarchyConfig(intra_rule="nope")
