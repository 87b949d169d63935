"""The plain PyTorch versions of kernels B1-B4 against the JAX package's
Pallas kernels (interpret mode, over the sweeps of tests/test_kernels.py),
the device dispatch of ``repro_torch.kernels.ops``, and the checks every
CUDA wrapper makes before it launches. The CUDA kernels themselves run
only on the card (``chip_smoke.py``)."""
import os
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


# csrc/cnd_sketch.cu's B3 arithmetic: mix32(x, seed) = avalanche(x, seed *
# GOLDEN + SALT, PRIMES[seed % 5]) in uint32 (numpy uint32 arrays wrap)
GOLDEN, SALT = 0x9E3779B9, 0x7F4A7C15
PRIMES = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1)
MAX_THREADS = 1024


def _u32(v):
    return np.uint32(v & 0xFFFFFFFF)


def _avalanche(x, salt, prime):
    x = (x ^ salt) * _u32(prime)
    x ^= x >> np.uint32(15)
    x *= _u32(0x85EBCA77)
    x ^= x >> np.uint32(13)
    x *= _u32(0xC2B2AE3D)
    return x ^ (x >> np.uint32(16))


def _set_bits(bm, seeds, hv, m):
    """set_bit: the final mix, the bucket by mask (m a power of two) or by
    ``% m``, one OR a chain."""
    for s in np.unique(seeds):
        x = _avalanche(hv[seeds == s], _u32((101 + s) * GOLDEN + SALT),
                       PRIMES[(101 + s) % 5])
        bit = x & _u32(m - 1) if m & (m - 1) == 0 else x % _u32(m)
        np.bitwise_or.at(bm[s], (bit >> np.uint32(5)).astype(np.int64),
                         np.uint32(1) << (bit & np.uint32(31)))


def _b3_kernel_emulation(items, h, m):
    """B3's thread mapping per node (one block a node): with f = 16 and
    h = 3 a thread per item, its three chains interleaved with constant
    primes and salts, in passes of a block of min(1024, n rounded up to a
    warp) threads; otherwise a thread per (item, seed) chain c (seed c // n,
    item c % n) with the salt a per-thread base s * GOLDEN + SALT plus
    j * GOLDEN, in passes of min(1024, n * h rounded up) threads."""
    k, n, f = items.shape
    x = items.astype(np.uint32)
    out = np.zeros((k, h, m // 32), np.uint32)
    unrolled = f == 16 and h == 3
    work = n if unrolled else n * h
    threads = min(MAX_THREADS, -(-work // 32) * 32)
    for node in range(k):
        visited = np.concatenate([np.arange(tid, work, threads)
                                  for tid in range(threads)])
        assert np.array_equal(np.sort(visited), np.arange(work))
        if unrolled:       # items `visited`, chains s = 0..2 side by side
            it = np.repeat(visited, h)
            seeds = np.tile(np.arange(h), len(visited))
        else:
            seeds, it = visited // n, visited % n
        # a per-thread base s * GOLDEN + SALT plus j * GOLDEN (the chains),
        # or the constant (s + j) * GOLDEN + SALT (the unrolled kernel)
        base = (seeds.astype(np.uint64) * GOLDEN + SALT).astype(np.uint32)
        hv = np.zeros(len(it), np.uint32)
        for j in range(f):
            for s in np.unique(seeds):
                on = seeds == s
                salt = (_u32((s + j) * GOLDEN + SALT) if unrolled
                        else base[on] + _u32(j * GOLDEN))
                hv[on] = _avalanche(hv[on] * np.uint32(31)
                                    + x[node, it[on], j], salt,
                                    PRIMES[(s + j) % 5])
        _set_bits(out[node], seeds, hv, m)
    return out


@pytest.mark.parametrize("k,n,f,h,m", [
    (2, 320, 16, 3, 8192),       # the path's shape: interleaved chains
    (2, 333, 16, 3, 3040),       # n off the warp, m not a power of two
    (3, 1100, 5, 3, 8192),       # 3,300 chains: four passes of 1024
    (2, 50, 16, 5, 2080),        # f = 16 with h != 3: a chain a thread
    (2, 37, 7, 2, 96)])
def test_b3_thread_mapping_emulation_matches_bit_for_bit(k, n, f, h, m):
    rng = np.random.default_rng(n + f)
    items = rng.integers(-(1 << 31), 1 << 31, size=(k, n, f),
                         dtype=np.int64).astype(np.int32)
    got = _b3_kernel_emulation(items, h, m)
    want = ref.cnd_bitmaps(torch.tensor(items), h, m).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(pallas_bitmaps(jnp.asarray(items[0]), h, m,
                                       interpret=True))
    np.testing.assert_array_equal(got[0], pallas)


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



def _fake_tree(monkeypatch, tmp_path):
    """``_build`` pointed at an empty source and build directory with one
    source ``k.cu``, and no ``nvcc``."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    monkeypatch.setattr(_build, "SIGNATURES", {"k": {}})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    src = csrc / "k.cu"
    src.write_text("// state A\n")
    return src


def _set_mtime(path, seconds):
    os.utime(path, (seconds, seconds))


def test_stale_keys_each_library_on_its_source_bytes(monkeypatch, tmp_path):
    src = _fake_tree(monkeypatch, tmp_path)
    assert _build._stale("k")
    lib = _build.library_path("k")
    lib.write_bytes(b"built from state A")
    assert not _build._stale("k")
    # the same bytes with a touched mtime: still the library of this source
    _set_mtime(src, lib.stat().st_mtime + 100)
    assert not _build._stale("k")
    # other bytes: stale, though the old library is newer than the source
    src.write_text("// state B\n")
    _set_mtime(lib, src.stat().st_mtime + 100)
    assert _build._stale("k") and lib.exists()
    assert _build.library_path("k") != lib
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    # back to state A: its library is found again, no rebuild
    src.write_text("// state A\n")
    assert not _build._stale("k") and _build.build_all() == {}


def test_stale_keys_each_library_on_the_compiler_flags(monkeypatch,
                                                       tmp_path):
    _fake_tree(monkeypatch, tmp_path)
    _build.library_path("k").write_bytes(b"built at -O3")
    assert not _build._stale("k")
    flags = [f for f in _build.NVCC_FLAGS if f != "-O3"] + ["-O1"]
    monkeypatch.setattr(_build, "NVCC_FLAGS", flags)
    assert _build._stale("k")
