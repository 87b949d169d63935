"""The variant axis of kernels B1 ``flat_mix`` and B2 ``flat_consensus``:
their plain versions (``repro_torch.kernels.ref``) with a leading (V,) axis
against the JAX package's Pallas kernels under ``jax.vmap`` in interpret
mode — one eta shared by every variant (``in_axes=None``) or one a variant
— for V 1 and 3, f32 and bf16 wire, at tests/test_kernels.py's tolerance;
the device dispatch of ``ops``; and the wrapper's variant shape rules
(the eta stride the CUDA entry takes). The CUDA kernels run only on the
card (``chip_smoke.py``)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import consensus_mix as pallas
from repro_torch.kernels import consensus_mix as tcm
from repro_torch.kernels import ops, ref

_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}
K, P, BLOCK = 8, 1024, 128
CASES = [(v, shared, dtype) for v in (1, 3) for shared in (True, False)
         for dtype in ("f32", "bf16")]


def _tol(dtype):
    return 3e-2 if dtype == "bf16" else 1e-5


def _inputs(v, shared, seed):
    rng = np.random.default_rng(seed)
    master = rng.normal(size=(v, K, P)).astype(np.float32)
    eta = np.exp(rng.normal(size=((1 if shared else v), K, K)))
    eta = (eta / eta.sum(axis=-1, keepdims=True)).astype(np.float32)
    eta[:, np.arange(K), np.arange(K)] = 0.0
    gamma = rng.uniform(0.2, 0.8, size=(v,)).astype(np.float32)
    return master, (eta[0] if shared else eta), gamma


@pytest.mark.parametrize("v,shared,dtype", CASES)
def test_batched_ref_flat_mix_matches_vmapped_pallas(v, shared, dtype):
    master, eta, gamma = _inputs(v, shared, 10 * v + shared)
    jdt, tdt = _DT[dtype]
    fn = jax.vmap(functools.partial(pallas.flat_mix, block_cols=BLOCK,
                                    interpret=True),
                  in_axes=(None if shared else 0, 0, 0, 0))
    want = fn(jnp.asarray(eta), jnp.asarray(master),
              jnp.asarray(master).astype(jdt), jnp.asarray(gamma))
    tm = torch.tensor(master)
    got = ref.flat_mix(torch.tensor(eta), tm, tm.to(tdt), torch.tensor(gamma))
    tol = _tol(dtype)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)
    # each variant is the single-variant plain version on its own inputs
    for i in range(v):
        one = ref.flat_mix(torch.tensor(eta if shared else eta[i]), tm[i],
                           tm[i].to(tdt), float(gamma[i]))
        torch.testing.assert_close(got[i], one, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("v,shared,dtype", CASES)
def test_batched_ref_flat_consensus_matches_vmapped_pallas(v, shared, dtype):
    buf, a, _ = _inputs(v, shared, 20 * v + shared)
    jdt, tdt = _DT[dtype]
    fn = jax.vmap(functools.partial(pallas.flat_consensus, block_cols=BLOCK,
                                    interpret=True),
                  in_axes=(None if shared else 0, 0))
    want = fn(jnp.asarray(a).astype(jdt), jnp.asarray(buf).astype(jdt))
    got = ref.flat_consensus(torch.tensor(a).to(tdt),
                             torch.tensor(buf).to(tdt))
    tol = _tol(dtype)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_ops_send_batched_cpu_tensors_to_the_plain_versions():
    before = (tcm.flat_mix.launches, tcm.flat_consensus.launches,
              tcm.flat_mix.launches_variants,
              tcm.flat_consensus.launches_variants)
    master, eta, gamma = _inputs(3, False, 5)
    tm, te = torch.tensor(master), torch.tensor(eta)
    assert torch.equal(ops.flat_mix(te, tm, tm, torch.tensor(gamma)),
                       ref.flat_mix(te, tm, tm, torch.tensor(gamma)))
    assert torch.equal(ops.flat_consensus(te, tm), ref.flat_consensus(te, tm))
    # one eta shared by every variant
    assert torch.equal(ops.flat_mix(te[0], tm, tm, torch.tensor(gamma)),
                       ref.flat_mix(te[0], tm, tm, torch.tensor(gamma)))
    assert before == (tcm.flat_mix.launches, tcm.flat_consensus.launches,
                      tcm.flat_mix.launches_variants,
                      tcm.flat_consensus.launches_variants)


@pytest.mark.parametrize("eta_shape,buf_shape,want", [
    ((4, 4), (4, 256), (1, 4, 256, 0)),
    ((4, 4), (3, 4, 256), (3, 4, 256, 0)),
    ((3, 4, 4), (3, 4, 256), (3, 4, 256, 16)),
])
def test_variant_shapes_and_eta_stride(eta_shape, buf_shape, want):
    assert tcm._variants(torch.zeros(eta_shape), torch.zeros(buf_shape),
                         "buf") == want


@pytest.mark.parametrize("eta_shape,buf_shape,match", [
    ((4, 4), (4,), "must be \\(K, P\\) or \\(V, K, P\\)"),
    ((5, 5), (3, 4, 256), "eta \\(5, 5\\) != \\(4, 4\\)"),
    ((2, 4, 4), (3, 4, 256), "!= \\(4, 4\\) or \\(3, 4, 4\\)"),
    ((3, 4, 4), (4, 256), "!= \\(4, 4\\) or"),
    ((4, 4), (70000, 4, 1), "variants outside"),
])
def test_variant_shapes_are_refused(eta_shape, buf_shape, match):
    with pytest.raises(ValueError, match=match):
        tcm._variants(torch.zeros(eta_shape), torch.empty(buf_shape), "buf")


def test_cuda_wrappers_refuse_batched_cpu_tensors():
    master, eta, gamma = _inputs(2, False, 7)
    tm = torch.tensor(master)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tcm.flat_mix(torch.tensor(eta), tm, tm, torch.tensor(gamma))
    with pytest.raises(ValueError, match="CUDA kernel"):
        tcm.flat_consensus(torch.tensor(eta), tm)
