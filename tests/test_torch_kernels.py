"""The plain PyTorch versions of kernels B1-B4 against the JAX package's
Pallas kernels (interpret mode, over the sweeps of tests/test_kernels.py),
the device dispatch of ``repro_torch.kernels.ops``, and the checks every
CUDA wrapper makes before it launches. The CUDA kernels themselves run
only on the card (``chip_smoke.py``)."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cnd_sketch import cnd_bitmaps as pallas_bitmaps
from repro.kernels.cnd_sketch import cnd_popcount as pallas_popcount
from repro.kernels.consensus_mix import flat_consensus as pallas_consensus
from repro.kernels.consensus_mix import flat_mix as pallas_mix
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import cnd_sketch as tcs
from repro_torch.kernels import consensus_mix as tcm

_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_kernels.py::test_flat_consensus_kernel_sweep, at its tolerance,
# and K where csrc/consensus_mix.cu runs its tiled kernel (from K=25; ragged
# against its 16-node stages and its 64-row tiles)
FLAT_SWEEP = [(4, 1024, 128, "f32"), (4, 2048, 512, "f32"),
              (8, 512, 128, "f32"), (4, 1024, 128, "bf16"),
              (25, 512, 128, "f32"), (33, 512, 128, "f32"),
              (64, 1024, 128, "f32"), (100, 512, 128, "f32"),
              (64, 1024, 128, "bf16")]
# tests/test_kernels.py::test_cnd_bitmaps_sweep
CND_SWEEP = [(64, 4, 1024, 3), (500, 8, 8192, 3), (1000, 16, 4096, 2),
             (37, 5, 2048, 4)]


def _tol(dtype):
    return 3e-2 if dtype == "bf16" else 1e-5


def _softmax_rows(rng, k):
    a = np.exp(rng.normal(size=(k, k))).astype(np.float32)
    return a / a.sum(axis=1, keepdims=True)


@pytest.mark.parametrize("k,p,block,dtype", FLAT_SWEEP)
def test_ref_flat_consensus_matches_pallas(k, p, block, dtype):
    rng = np.random.default_rng(k + p)
    buf = rng.normal(size=(k, p)).astype(np.float32)
    a = _softmax_rows(rng, k)
    jdt, tdt = _DT[dtype]
    want = pallas_consensus(jnp.asarray(a).astype(jdt),
                            jnp.asarray(buf).astype(jdt), block_cols=block,
                            interpret=True)
    got = ref.flat_consensus(torch.tensor(a).to(tdt),
                             torch.tensor(buf).to(tdt))
    tol = _tol(dtype)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("k,p,block,dtype", FLAT_SWEEP)
def test_ref_flat_mix_matches_pallas(k, p, block, dtype):
    """``dtype`` is the wire's; the master and the output stay f32."""
    rng = np.random.default_rng(100 + k + p)
    master = rng.normal(size=(k, p)).astype(np.float32)
    eta = _softmax_rows(rng, k)
    np.fill_diagonal(eta, 0.0)
    jdt, tdt = _DT[dtype]
    want = pallas_mix(jnp.asarray(eta), jnp.asarray(master),
                      jnp.asarray(master).astype(jdt), jnp.float32(0.4),
                      block_cols=block, interpret=True)
    tm = torch.tensor(master)
    got = ref.flat_mix(torch.tensor(eta), tm, tm.to(tdt), 0.4)
    tol = _tol(dtype)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("n,f,m,h", CND_SWEEP)
def test_ref_cnd_bitmaps_match_pallas_bit_for_bit(n, f, m, h):
    rng = np.random.default_rng(n)
    items = rng.integers(0, 1 << 16, size=(n, f)).astype(np.int32)
    want = np.asarray(pallas_bitmaps(jnp.asarray(items), h, m,
                                     interpret=True))
    got = ref.cnd_bitmaps(torch.tensor(items), h, m)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_ref_cnd_bitmaps_batch_over_nodes():
    rng = np.random.default_rng(7)
    items = rng.integers(-(1 << 31), 1 << 31, size=(3, 50, 6),
                         dtype=np.int64).astype(np.int32)
    batched = ref.cnd_bitmaps(torch.tensor(items), 3, 2048)
    assert batched.shape == (3, 3, 64)
    for node in range(3):
        want = np.asarray(pallas_bitmaps(jnp.asarray(items[node]), 3, 2048,
                                         interpret=True))
        np.testing.assert_array_equal(batched[node].numpy().view(np.uint32),
                                      want)


def test_ref_cnd_popcount_matches_pallas():
    rng = np.random.default_rng(1)
    bm = rng.integers(0, 1 << 32, size=(3, 256),
                      dtype=np.uint64).astype(np.uint32)
    want = np.asarray(pallas_popcount(jnp.asarray(bm), interpret=True))
    got = ref.cnd_popcount(torch.tensor(bm.view(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _counts():
    return (tcm.flat_mix.launches, tcm.flat_consensus.launches,
            tcs.cnd_bitmaps.launches, tcs.cnd_popcount.launches)


def test_cuda_wrappers_refuse_cpu_tensors():
    before = _counts()
    buf = torch.zeros((4, 128))
    eta = torch.full((4, 4), 0.25)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tcm.flat_mix(eta, buf, buf, torch.ones(1))
    with pytest.raises(ValueError, match="CUDA kernel"):
        tcm.flat_consensus(eta, buf)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tcs.cnd_bitmaps(torch.zeros((2, 8, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA kernel"):
        tcs.cnd_popcount(torch.zeros((3, 8), dtype=torch.int32))
    assert _counts() == before


def test_ops_send_cpu_tensors_to_the_plain_versions():
    before = _counts()
    rng = np.random.default_rng(3)
    buf = torch.tensor(rng.normal(size=(4, 256)).astype(np.float32))
    eta = torch.tensor(_softmax_rows(rng, 4))
    assert torch.equal(ops.flat_mix(eta, buf, buf, 0.3),
                       ref.flat_mix(eta, buf, buf, 0.3))
    assert torch.equal(ops.flat_consensus(eta, buf),
                       ref.flat_consensus(eta, buf))
    items = torch.tensor(rng.integers(0, 99, size=(2, 20, 3)),
                         dtype=torch.int32)
    bm = ops.cnd_bitmaps(items, 3, 1024)
    assert torch.equal(bm, ref.cnd_bitmaps(items, 3, 1024))
    assert torch.equal(ops.cnd_popcount(bm), ref.cnd_popcount(bm))
    assert _counts() == before


def test_ops_refuse_other_devices():
    t = torch.empty((4, 128), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.flat_consensus(torch.empty((4, 4), device="meta"), t)


def test_sources_export_the_bound_entry_points():
    """Every C entry point the ctypes binding declares exists in its
    source with the same number of parameters."""
    for name, fns in _build.SIGNATURES.items():
        src = (_build.CSRC / f"{name}.cu").read_text()
        found = {m.group(1): m.group(2) for m in re.finditer(
            r'extern "C" int (\w+)\(([^)]*)\)', src)}
        assert set(found) == set(fns), name
        for fn, argtypes in fns.items():
            assert len(found[fn].split(",")) == len(argtypes), fn
        assert "repro_cuda_error_string" in src


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()

