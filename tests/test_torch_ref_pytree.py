"""The port's per-leaf consensus oracles (``repro_torch.kernels.ref``'s
``apply_matrix_pytree``, ``consensus_step_pytree``,
``partial_consensus_step_pytree`` and ``disagreement_pytree``):

* against the JAX package's ``repro.kernels.ref`` on the same numpy trees
  (a nested dict of 5 leaves, K=4), f32 leaves within 1e-6 and bf16
  leaves within one bf16 ulp of the reference's value;
* the port's flat engine (``core/consensus.py``: ``consensus_step``,
  ``partial_consensus_step``, ``apply_matrix``, ``disagreement``) against
  these oracles, as ``tests/test_flatten.py`` holds the reference's flat
  engine against its own.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topology as jtopology
from repro.kernels import ref as jref
from repro_torch.core import consensus, topology
from repro_torch.kernels import ref

K = 4
GAMMA = 0.4
RATIOS = [0.3, 0.8, 0.6, 0.9]
SIZES = [120.0, 160.0, 240.0, 320.0]
FRACTIONS = (0.25, 0.5, 1.0)


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors: one intra-op thread, so that a loaded machine's
    spinning worker threads do not dominate the test's time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _tree(seed: int) -> dict:
    """Five leaves over two dict levels (sorted keys put ``emb`` first and
    ``layer/w`` last), a per-node scalar among them."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.normal(size=(K,) + shape).astype(np.float32)

    return {"layer": {"w": normal(6, 5), "b": normal(5), "gain": normal()},
            "emb": normal(7, 3), "head": normal(3, 2, 2)}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {key: _map(fn, sub) for key, sub in tree.items()}
    return fn(tree)


def _pairs(tree, path=()):
    if isinstance(tree, dict):
        return [pair for key in sorted(tree)
                for pair in _pairs(tree[key], path + (key,))]
    return [(path, tree)]


def _eta(alg: str):
    """The (K, K) eta of ``alg`` on a ring, from each package."""
    adj = torch.as_tensor(topology.adjacency("ring", K), dtype=torch.float32)
    jadj = jnp.asarray(jtopology.adjacency("ring", K), jnp.float32)
    if alg == "cdfl":
        return (topology.cnd_mixing(adj, torch.tensor(RATIOS)),
                jtopology.cnd_mixing(jadj, jnp.asarray(RATIOS)))
    if alg in ("cfa", "fedavg"):
        return (topology.datasize_mixing(adj, torch.tensor(SIZES)),
                jtopology.datasize_mixing(jadj, jnp.asarray(SIZES)))
    return topology.uniform_mixing(adj), jtopology.uniform_mixing(jadj)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _close(got, want, dtype: str) -> None:
    """Leaf by leaf, in the reference's leaf order: f32 within 1e-6, bf16
    within one bf16 ulp of the reference's value."""
    got_pairs, want_pairs = _pairs(got), _pairs(want)
    assert [p for p, _ in got_pairs] == [p for p, _ in want_pairs]
    for (path, g), (_, w) in zip(got_pairs, want_pairs):
        assert g.dtype == (torch.bfloat16 if dtype == "bf16"
                           else torch.float32), path
        g32 = g.float().numpy()
        w32 = np.asarray(jnp.asarray(w, jnp.float32))
        assert g32.shape == w32.shape, path
        tol = _bf16_ulp(w32) if dtype == "bf16" else 1e-6
        assert np.all(np.abs(g32 - w32) <= tol), (
            path, np.max(np.abs(g32 - w32)))


def _inputs(dtype: str, seed: int):
    """The same tree as torch tensors and as JAX arrays, in ``dtype``."""
    tree = _tree(seed)
    if dtype == "bf16":
        return (_map(lambda a: torch.from_numpy(a).bfloat16(), tree),
                _map(lambda a: jnp.asarray(a, jnp.bfloat16), tree))
    return (_map(torch.from_numpy, tree), _map(jnp.asarray, tree))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_apply_matrix_pytree_matches_the_reference(dtype):
    tree, jtree = _inputs(dtype, 0)
    a = np.random.default_rng(1).random((K, K)).astype(np.float32)
    a /= a.sum(axis=1, keepdims=True)
    _close(ref.apply_matrix_pytree(tree, torch.from_numpy(a)),
           jref.apply_matrix_pytree(jtree, jnp.asarray(a)), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("self_weight", [1.0, 0.5])
def test_consensus_step_pytree_matches_the_reference(dtype, self_weight):
    tree, jtree = _inputs(dtype, 2)
    eta, jeta = _eta("cdfl")
    _close(ref.consensus_step_pytree(tree, eta, GAMMA, self_weight),
           jref.consensus_step_pytree(jtree, jeta, GAMMA, self_weight),
           dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fraction", FRACTIONS)
def test_partial_consensus_step_pytree_matches_the_reference(dtype,
                                                             fraction):
    tree, jtree = _inputs(dtype, 3)
    eta, jeta = _eta("cdfa_m")
    got = ref.partial_consensus_step_pytree(tree, eta, 0.3, fraction)
    _close(got, jref.partial_consensus_step_pytree(jtree, jeta, 0.3,
                                                   fraction), dtype)
    # the first max(1, round(f * 5)) leaves in the reference's order are
    # mixed, the rest are the inputs themselves
    n_mix = max(1, int(round(fraction * 5)))
    for i, ((path, g), (_, x)) in enumerate(zip(_pairs(got), _pairs(tree))):
        assert torch.equal(g, x) == (i >= n_mix), path


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_disagreement_pytree_matches_the_reference(dtype):
    tree, jtree = _inputs(dtype, 4)
    got = ref.disagreement_pytree(tree)
    want = np.float32(jnp.asarray(jref.disagreement_pytree(jtree),
                                  jnp.float32))
    assert got.dtype == (torch.bfloat16 if dtype == "bf16"
                         else torch.float32)
    tol = 1e-6 * abs(want) if dtype == "f32" else _bf16_ulp(want)
    assert abs(got.float().item() - want) <= tol, (got, want)


ALGS = ["cdfl", "cfa", "fedavg", "cdfa_m", "dpsgd"]


@pytest.mark.parametrize("alg", ALGS)
def test_flat_consensus_step_matches_the_perleaf_oracle(alg):
    tree, _ = _inputs("f32", 5)
    eta, _ = _eta(alg)
    out = consensus.consensus_step(tree, eta, GAMMA)
    _close(out, ref.consensus_step_pytree(tree, eta, GAMMA), "f32")


@pytest.mark.parametrize("alg", ALGS)
def test_flat_partial_consensus_matches_the_perleaf_oracle(alg):
    tree, _ = _inputs("f32", 6)
    eta, _ = _eta(alg)
    for fraction in FRACTIONS:
        out = consensus.partial_consensus_step(tree, eta, 0.3, fraction)
        _close(out, ref.partial_consensus_step_pytree(tree, eta, 0.3,
                                                      fraction), "f32")


def test_flat_apply_matrix_and_disagreement_match_the_perleaf_oracles():
    tree, _ = _inputs("f32", 7)
    a = torch.softmax(torch.randn((K, K), generator=torch.Generator()
                                  .manual_seed(0)), dim=1)
    _close(consensus.apply_matrix(tree, a), ref.apply_matrix_pytree(tree, a),
           "f32")
    d_flat = consensus.disagreement(tree).item()
    d_ref = ref.disagreement_pytree(tree).item()
    assert abs(d_flat - d_ref) <= 1e-6 * abs(d_ref)
