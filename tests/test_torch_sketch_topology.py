"""The port's CND sketch and mixing weights against the JAX package, on the
same numpy inputs: hashes, bitmaps, cardinalities and ratios bit for bit,
topologies and policies at 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from repro import registry as jregistry
from repro.core import sketch as jsketch
from repro.core import topology as jtopo
from repro_torch import registry as tregistry
from repro_torch.core import sketch as tsketch
from repro_torch.core import topology as ttopo


def _items(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(-(1 << 31), 1 << 31, size=shape,
                        dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("n,f,h,m", [(40, 1, 3, 1024), (300, 16, 3, 8192),
                                     (77, 5, 4, 2048)])
def test_hash_items_and_bitmaps_match_reference(n, f, h, m):
    items = _items(n + f, (n, f))
    want_idx = np.asarray(jsketch.hash_items(jnp.asarray(items), h, m))
    got_idx = tsketch.hash_items(torch.tensor(items), h, m)
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    want = np.asarray(jsketch.build_bitmaps(jnp.asarray(items), h, m))
    got = tsketch.build_bitmaps(torch.tensor(items), h, m)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_popcount_matches_reference():
    words = np.random.default_rng(4).integers(
        0, 1 << 32, size=(5, 64), dtype=np.uint64).astype(np.uint32)
    words[0, :4] = [0, 0xFFFFFFFF, 0x80000000, 1]
    want = np.asarray(jsketch.popcount(jnp.asarray(words)))
    got = tsketch.popcount(torch.tensor(words.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tsketch.set_bits(torch.tensor(words.view(np.int32))).numpy(),
        np.asarray(jsketch.set_bits(jnp.asarray(words))))


def _bitmap_cases():
    rng = np.random.default_rng(9)
    sparse = np.asarray(jsketch.build_bitmaps(
        jnp.asarray(_items(1, (200, 6))), 3, 8192))
    dense = np.asarray(jsketch.build_bitmaps(
        jnp.asarray(_items(2, (3000, 4))), 3, 2048))
    rand = rng.integers(0, 1 << 32, size=(3, 64),
                        dtype=np.uint64).astype(np.uint32)
    full = np.full((3, 32), 0xFFFFFFFF, np.uint32)       # saturated
    empty = np.zeros((2, 16), np.uint32)
    return {"sparse": sparse, "dense": dense, "random": rand,
            "saturated": full, "empty": empty,
            "no_rows": np.zeros((0, 8), np.uint32)}


@pytest.mark.parametrize("estimator", ["paper_mean", "linear_counting"])
@pytest.mark.parametrize("case", list(_bitmap_cases()))
def test_cardinality_matches_reference_exactly(estimator, case):
    bm = _bitmap_cases()[case]
    want = np.asarray(jsketch.cardinality(jnp.asarray(bm), estimator))
    got = tsketch.cardinality(torch.tensor(bm.view(np.int32)), estimator)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cardinality_batches_over_nodes():
    cases = _bitmap_cases()
    stack = np.stack([cases["sparse"], np.asarray(jsketch.build_bitmaps(
        jnp.asarray(_items(3, (900, 6))), 3, 8192))])
    got = tsketch.cardinality(torch.tensor(stack.view(np.int32)))
    want = [float(jsketch.cardinality(jnp.asarray(b))) for b in stack]
    np.testing.assert_array_equal(got.numpy(), np.float32(want))


@pytest.mark.parametrize("estimator", ["paper_mean", "linear_counting"])
def test_distinct_ratio_matches_reference(estimator):
    for n_distinct, n in [(100, 400), (320, 320), (5000, 6000)]:
        pool = _items(n_distinct, (n_distinct, 8))
        items = np.concatenate([pool, pool[:n - n_distinct]])
        bm = np.asarray(jsketch.build_bitmaps(jnp.asarray(items), 3, 8192))
        want = jsketch.distinct_ratio(
            {"bitmaps": jnp.asarray(bm), "total": jnp.int32(n)}, estimator)
        got = tsketch.distinct_ratio(
            {"bitmaps": torch.tensor(bm.view(np.int32)),
             "total": torch.tensor(n, dtype=torch.int32)}, estimator)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["ring", "full", "chain", "erdos"])
@pytest.mark.parametrize("k", [2, 5, 8])
def test_adjacency_matches_reference(kind, k):
    for seed in (0, 3):
        np.testing.assert_array_equal(
            ttopo.adjacency(kind, k, seed=seed, edge_prob=0.4),
            jtopo.adjacency(kind, k, seed=seed, edge_prob=0.4))


@pytest.mark.parametrize("kind", ["ring", "full", "chain", "erdos"])
@pytest.mark.parametrize("rule", ["cnd", "uniform", "datasize",
                                  "metropolis"])
def test_mixing_policies_gamma_and_operator_match_reference(kind, rule):
    k = 8
    rng = np.random.default_rng(len(kind) + len(rule))
    adj = jtopo.adjacency(kind, k, seed=1)
    ratios = rng.uniform(0.1, 1.0, k).astype(np.float32)
    sizes = rng.uniform(50, 400, k).astype(np.float32)
    want = jtopo.mixing_weights(jnp.asarray(adj), rule,
                                ratios=jnp.asarray(ratios),
                                sizes=jnp.asarray(sizes))
    got = ttopo.mixing_weights(torch.tensor(adj), rule,
                               ratios=torch.tensor(ratios),
                               sizes=torch.tensor(sizes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    for cap in (0.5, 5.0):
        np.testing.assert_allclose(
            ttopo.stable_gamma(got, cap).item(),
            float(jtopo.stable_gamma(want, cap)), rtol=1e-6)
    g = 0.4
    np.testing.assert_allclose(
        ttopo.consensus_matrix(got, g).numpy(),
        np.asarray(jtopo.consensus_matrix(want, g)), atol=1e-6, rtol=0)
    if kind != "erdos":     # erdos may be disconnected: gap 0 either way
        np.testing.assert_allclose(
            ttopo.spectral_gap(ttopo.consensus_matrix(got, g)),
            jtopo.spectral_gap(jtopo.consensus_matrix(want, g)), atol=1e-5)


def test_algorithm_mixing_and_policy_names_match_reference():
    jregistry.ensure_plugins()
    tregistry.ensure_plugins()
    assert ttopo.ALGORITHM_MIXING == jtopo.ALGORITHM_MIXING
    assert tregistry.mixing_policies.names() == \
        jregistry.mixing_policies.names()


# --- the twin of tests/test_topology.py's property fuzz, on both packages --
#
# The reference fails its own property on rows whose surviving mass lies
# below the 1e-12 clamp of renormalize_rows: there the survivors are
# scaled by target / 1e-12 instead of target / mass, so the row does not
# reach its target. Hypothesis found the 2x2 example below (off-diagonal
# weights 2.4e-35); the port keeps the reference's arithmetic, so the twin
# checks the mass property above the clamp, and that both packages agree
# everywhere.

_CLAMP = 1e-12


def _weights(pkg, adj):
    k = adj.shape[0]
    if pkg == "jax":
        a = jnp.asarray(adj, jnp.float32)
        ratios, sizes = jnp.linspace(0.1, 1.0, k), jnp.linspace(50., 400., k)
        etas = {n: np.asarray(jtopo.mixing_weights(a, n, ratios=ratios,
                                                   sizes=sizes))
                for n in ttopo.ALGORITHM_MIXING.values()}
        renorm = lambda e, t: np.asarray(jtopo.renormalize_rows(
            jnp.asarray(e), jnp.asarray(t, jnp.float32)))
    else:
        a = torch.tensor(adj, dtype=torch.float32)
        ratios = torch.linspace(0.1, 1.0, k)
        sizes = torch.linspace(50., 400., k)
        etas = {n: ttopo.mixing_weights(a, n, ratios=ratios,
                                        sizes=sizes).numpy()
                for n in ttopo.ALGORITHM_MIXING.values()}
        renorm = lambda e, t: ttopo.renormalize_rows(
            torch.tensor(e), torch.tensor(t)).numpy()
    mask = (adj > 0).astype(np.float32)
    target = etas["uniform"].sum(axis=1)
    return etas, renorm(etas["uniform"] * mask, target), target


@settings(max_examples=60, deadline=None)
@given(st.integers(2, 8).flatmap(
    lambda k: hnp.arrays(np.float32, (k, k),
                         elements=st.floats(0.0, 1.0, width=32))))
@example(np.array([[0.0, 2.3963701e-35], [2.3963701e-35, 0.0]], np.float32))
def test_twin_mixing_policies_row_stochastic_any_mask(adj):
    np.fill_diagonal(adj, 0.0)
    degree = adj.sum(axis=1)
    t_etas, t_ren, t_target = _weights("torch", adj)
    j_etas, j_ren, j_target = _weights("jax", adj)
    for name, eta in t_etas.items():
        np.testing.assert_allclose(eta, j_etas[name], atol=1e-6, rtol=0)
        assert np.isfinite(eta).all() and (eta >= 0).all(), name
        assert (eta[adj == 0] == 0).all(), name
        assert (eta.sum(axis=1) <= 1.0 + 1e-5).all(), name
        assert (eta[degree == 0] == 0).all(), name
    np.testing.assert_allclose(t_ren, j_ren, atol=1e-6, rtol=0)
    assert np.isfinite(t_ren).all()
    kept = (t_etas["uniform"] * (adj > 0)).sum(axis=1)
    above = kept >= _CLAMP
    np.testing.assert_allclose(t_ren.sum(axis=1)[above], t_target[above],
                               rtol=1e-4)
    assert (t_ren[kept == 0] == 0).all()
