"""The sparse top-D format of the port against the JAX package: the plain
versions of kernels B5 ``sparse_mix`` and B6 ``cluster_mix`` against the
Pallas kernels in interpret mode (at the 1e-5 of tests/test_sparse_mix.py
and tests/test_hierarchy.py), ``sparsify_eta`` index for index on tied
rows, the flat sparse mixes, the sparse transport branch (with and without
per-node fault payloads), and the checks
the CUDA wrappers make before they launch. The CUDA kernels run only on
the card (``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flatten as jflat
from repro.core import topology as jtopo
from repro.core import transport as jtransport
from repro.kernels import ops as jops
from repro_torch.core import flatten as tflat
from repro_torch.core import topology as ttopo
from repro_torch.core import transport as ttransport
from repro_torch.kernels import cluster_mix as tclm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sparse_mix as tsm

TOL = 1e-5      # tests/test_sparse_mix.py:150, tests/test_hierarchy.py:295
_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def _table(rng, k, d, zero_frac=0.3):
    """(K, D) neighbor table with zero-weight slots (padding, isolated
    rows) whose indices still point at real rows."""
    idx = np.stack([rng.choice(k, size=d, replace=False) for _ in range(k)]
                   ).astype(np.int32)
    val = rng.uniform(0.05, 0.5, size=(k, d)).astype(np.float32)
    val[rng.random((k, d)) < zero_frac] = 0.0
    val[0] = 0.0                                   # one isolated node
    return idx, val


@pytest.mark.parametrize("k,d,p,wire", [(8, 3, 256, "f32"),
                                        (8, 1, 128, "f32"),
                                        (8, 3, 512, "bf16"),
                                        (16, 5, 256, "bf16")])
def test_ref_sparse_mix_matches_pallas(k, d, p, wire):
    rng = np.random.default_rng(k * 10 + d)
    idx, val = _table(rng, k, d)
    master = rng.standard_normal((k, p)).astype(np.float32)
    jdt, tdt = _DT[wire]
    w = jnp.asarray(master).astype(jdt)
    want = jops.sparse_mix(jnp.asarray(idx), jnp.asarray(val),
                           jnp.asarray(master), w, jnp.float32(0.3),
                           force_kernel=True)
    tm = torch.tensor(master)
    got = ref.sparse_mix(torch.tensor(idx), torch.tensor(val), tm,
                         tm.to(tdt), 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    # the isolated node is an exact self-update
    np.testing.assert_array_equal(got[0].numpy(), master[0])


@pytest.mark.parametrize("k,d,p,wire", [(8, 3, 256, "f32"),
                                        (8, 1, 128, "f32"),
                                        (8, 4, 512, "bf16")])
def test_ref_cluster_mix_matches_pallas(k, d, p, wire):
    rng = np.random.default_rng(100 + k + d)
    idx, val = _table(rng, k, d)
    master = rng.standard_normal((k, p)).astype(np.float32)
    wire_nb = rng.standard_normal((k, p)).astype(np.float32)
    g = rng.uniform(0.1, 0.9, size=k).astype(np.float32)
    jdt, tdt = _DT[wire]
    want = jops.cluster_mix(
        jnp.asarray(idx), jnp.asarray(val), jnp.asarray(master),
        jnp.asarray(master).astype(jdt), jnp.asarray(wire_nb).astype(jdt),
        jnp.asarray(g), force_kernel=True)
    got = ref.cluster_mix(torch.tensor(idx), torch.tensor(val),
                          torch.tensor(master),
                          torch.tensor(master).to(tdt),
                          torch.tensor(wire_nb).to(tdt), torch.tensor(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def _ring_eta(k):
    adj = jtopo.adjacency("ring", k)
    return np.asarray(jtopo.uniform_mixing(jnp.asarray(adj)))


@pytest.mark.parametrize("case", ["ring", "binary", "ties_and_zeros"])
def test_sparsify_eta_keeps_the_reference_order_on_ties(case):
    rng = np.random.default_rng(5)
    if case == "ring":
        eta = _ring_eta(9)                       # D=4: two zero slots tie
        d = 4
    elif case == "binary":
        eta = (rng.random((10, 10)) < 0.5).astype(np.float32)
        np.fill_diagonal(eta, 0.0)
        d = 6
    else:
        eta = rng.choice([0.0, 0.25, 0.5], size=(3, 7, 7)).astype(np.float32)
        d = 5
    want = jtopo.sparsify_eta(jnp.asarray(eta), d)
    got = ttopo.sparsify_eta(torch.tensor(eta), d)
    assert got.idx.dtype == torch.int32 and got.degree == d
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_allclose(got.val.numpy(), np.asarray(want.val),
                               atol=1e-6, rtol=0)
    k = eta.shape[-1]
    np.testing.assert_allclose(ttopo.densify_eta(got, k).numpy(),
                               np.asarray(jtopo.densify_eta(want, k)),
                               atol=1e-6, rtol=0)


def test_mixing_weights_degree_and_sparse_gamma():
    adj = jtopo.adjacency("full", 6)
    ratios = np.array([0.2, 0.5, 0.9, 0.3, 0.7, 1.0], np.float32)
    want = jtopo.mixing_weights(jnp.asarray(adj), "cnd",
                                ratios=jnp.asarray(ratios), degree=3)
    got = ttopo.mixing_weights(torch.tensor(adj), "cnd",
                               ratios=torch.tensor(ratios), degree=3)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_allclose(got.val.numpy(), np.asarray(want.val),
                               atol=1e-6, rtol=0)
    for cap in (0.3, 2.0):
        np.testing.assert_allclose(
            ttopo.stable_gamma(got, cap).item(),
            float(jtopo.stable_gamma(want, cap)), rtol=1e-6)
    assert ttopo.max_row_sum(got).item() == pytest.approx(
        float(jtopo.max_row_sum(want)), rel=1e-6)


@pytest.mark.parametrize("degree", [0, 6])
def test_validate_degree_rejects_out_of_range(degree):
    with pytest.raises(ValueError, match="out of range"):
        ttopo.validate_degree(degree, 6)
    with pytest.raises(ValueError, match="out of range"):
        jtopo.validate_degree(degree, 6)


def test_flat_sparse_and_cluster_mix_match_reference():
    rng = np.random.default_rng(11)
    k, d, p = 12, 4, 384
    idx, val = _table(rng, k, d)
    buf = rng.standard_normal((k, p)).astype(np.float32)
    wire = rng.standard_normal((k, p)).astype(np.float32)
    g = rng.uniform(0.1, 0.9, size=k).astype(np.float32)
    ti, tv, tb = torch.tensor(idx), torch.tensor(val), torch.tensor(buf)
    want = jflat.sparse_mix_flat(jnp.asarray(buf), jnp.asarray(idx),
                                 jnp.asarray(val), 0.4, use_kernel=False)
    got = tflat.sparse_mix_flat(tb, ti, tv, torch.tensor(0.4))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    want = jflat.cluster_mix_flat(jnp.asarray(buf), jnp.asarray(idx),
                                  jnp.asarray(val), jnp.asarray(g),
                                  use_kernel=False, wire=jnp.asarray(wire))
    got = tflat.cluster_mix_flat(tb, ti, tv, torch.tensor(g),
                                 wire=torch.tensor(wire))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_dense_transport_sparse_exchange_matches_reference(wire):
    rng = np.random.default_rng(21)
    k, p = 10, 256
    eta = _ring_eta(k)
    buf = rng.standard_normal((k, p)).astype(np.float32)
    jsp = jtopo.sparsify_eta(jnp.asarray(eta), 3)
    tsp = ttopo.sparsify_eta(torch.tensor(eta), 3)
    want, _ = jtransport.DenseTransport(
        wire_dtype=wire, simulate_wire=True).exchange(
        jnp.asarray(buf), jsp, jnp.float32(0.45))
    tr = ttransport.DenseTransport(wire_dtype=wire)
    got, _ = tr.exchange(torch.tensor(buf), tsp, torch.tensor(0.45))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    # the fault branch: per-node payloads that differ from the buffer
    # feed the gathered rows, the buffer the self rescale (kernel B6 with
    # the step size broadcast to every node)
    sent = (buf + rng.standard_normal((k, p)) * 0.1).astype(np.float32)
    want, _ = jtransport.DenseTransport(
        wire_dtype=wire, simulate_wire=True).exchange(
        jnp.asarray(buf), jsp, jnp.float32(0.45), sent=jnp.asarray(sent))
    got, _ = tr.exchange(torch.tensor(buf), tsp, torch.tensor(0.45),
                         sent=torch.tensor(sent))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def _counts():
    return tsm.sparse_mix.launches, tclm.cluster_mix.launches


def test_cuda_wrappers_refuse_cpu_tensors_and_ops_use_plain_versions():
    before = _counts()
    rng = np.random.default_rng(3)
    idx, val = (torch.tensor(a) for a in _table(rng, 4, 2))
    buf = torch.tensor(rng.standard_normal((4, 128)).astype(np.float32))
    g = torch.full((4,), 0.3)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tsm.sparse_mix(idx, val, buf, buf, torch.ones(1))
    with pytest.raises(ValueError, match="CUDA kernel"):
        tclm.cluster_mix(idx, val, buf, buf, buf, g)
    assert torch.equal(ops.sparse_mix(idx, val, buf, buf, 0.3),
                       ref.sparse_mix(idx, val, buf, buf, 0.3))
    assert torch.equal(ops.cluster_mix(idx, val, buf, buf, buf, g),
                       ref.cluster_mix(idx, val, buf, buf, buf, g))
    assert _counts() == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.sparse_mix(idx, val, torch.empty((4, 128), device="meta"),
                       buf, 0.3)


def test_gather_checks_reject_bad_shapes_before_any_launch():
    idx = torch.zeros((4, 2), dtype=torch.int32)
    val = torch.zeros((4, 2))
    buf = torch.zeros((4, 128))
    with pytest.raises(ValueError, match="idx must be int32"):
        tsm.check_gather_args(idx.long(), val, buf, buf)
    with pytest.raises(ValueError, match="val"):
        tsm.check_gather_args(idx, val[:, :1], buf, buf)
    with pytest.raises(ValueError, match="wire dtype"):
        tsm.check_gather_args(idx, val, buf, buf.half())
    with pytest.raises(ValueError, match="degree"):
        tsm.check_gather_args(idx[:, :0], val[:, :0], buf, buf)
    assert tsm.check_gather_args(idx, val, buf, buf.bfloat16()) == (4, 2, 128)
