"""Kernel B10 ``rwkv6_scan``: the port's plain version against the JAX
package's Pallas kernel in interpret mode and its model forms, on the CPU.

The Pallas cases are those of tests/test_kernels.py (chunks 16, 32 and 64,
head sizes 64 and 128) at that file's tolerance (2e-3). With an initial
state, the plain version is held to ``repro.models.rwkv.chunked`` (the
same function in another f32 order: 2e-4 absolute, 1e-5 relative, against
|y| up to about 100) and ``scan_reference`` at
tests/test_ssm.py's 5e-4 / 1e-3. Inputs are made with numpy. The CUDA
kernel itself runs only on the card (``chip_smoke.py``); here its
wrapper's checks run up to the launch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_rwkv6
from repro.models import rwkv as jrwkv
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rwkv6_scan as trw


def _inputs(b, s, h, d, seed, w_kind):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32)
               for _ in range(3))
    z = rng.normal(size=(b, s, h, d))
    if w_kind == "kernel":      # tests/test_kernels.py: sigmoid * 0.9 + 0.05
        w = 0.9 / (1.0 + np.exp(-z)) + 0.05
    else:                       # the model's clamp (tests/test_ssm.py)
        w = np.exp(-np.clip(np.exp(z), 1e-6, jrwkv.MAX_LOG_DECAY))
    u = rng.normal(size=(h, d)) * 0.1
    s0 = rng.normal(size=(b, h, d, d)) * 0.3
    return [a.astype(np.float32) for a in (r, k, v, w, u, s0)]


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=rtol)


# tests/test_kernels.py::test_rwkv6_kernel_sweep
@pytest.mark.parametrize("b,s,h,d,chunk", [
    (1, 64, 1, 64, 16), (2, 128, 3, 64, 32), (1, 256, 2, 128, 64),
])
def test_plain_b10_matches_pallas_sweep(b, s, h, d, chunk):
    r, k, v, w, u, _ = _inputs(b, s, h, d, s + h, "kernel")
    jy, js = pallas_rwkv6(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                          chunk=chunk, interpret=True)
    y, sf = ref.rwkv6_scan(*(torch.tensor(a) for a in (r, k, v, w, u)),
                           chunk=chunk)
    assert y.dtype == sf.dtype == torch.float32
    assert tuple(y.shape) == (b, s, h, d) and tuple(sf.shape) == (b, h, d, d)
    _close(y, jy, 2e-3, 2e-3)
    _close(sf, js, 2e-3, 2e-3)
    ye, se = jref.rwkv6_scan(*(jnp.asarray(a) for a in (r, k, v, w, u)))
    _close(y, ye, 2e-3, 2e-3)
    _close(sf, se, 2e-3, 2e-3)


# tests/test_ssm.py::test_rwkv_chunked_matches_scan, from a non-zero state
@pytest.mark.parametrize("b,s,h,d", [(1, 16, 1, 32), (2, 64, 3, 64),
                                     (1, 128, 2, 16)])
def test_plain_b10_from_a_state_matches_chunked_and_scan(b, s, h, d):
    arrs = _inputs(b, s, h, d, s, "model")
    jarrs = [jnp.asarray(a) for a in arrs]
    y, sf = ref.rwkv6_scan(*(torch.tensor(a) for a in arrs))
    jy, js = jrwkv.chunked(*jarrs)
    _close(y, jy, 2e-4, 1e-5)
    _close(sf, js, 2e-4, 1e-5)
    ry, rs = jrwkv.scan_reference(*jarrs)
    _close(y, ry, 5e-4, 1e-3)
    _close(sf, rs, 5e-4, 1e-3)


def test_plain_b10_bf16_inputs_are_upcast():
    """bf16 r/k/v (as the bf16 model hands them over) give the f32 result
    of the same rounded values: the arithmetic is f32 throughout."""
    r, k, v, w, u, s0 = (torch.tensor(a) for a in
                         _inputs(2, 32, 2, 64, 9, "model"))
    r16, k16, v16 = (t.to(torch.bfloat16) for t in (r, k, v))
    y, sf = ops.rwkv6_scan(r16, k16, v16, w, u, s0)
    want_y, want_s = ref.rwkv6_scan(r16.float(), k16.float(), v16.float(),
                                    w, u, s0)
    assert y.dtype == torch.float32
    assert torch.equal(y, want_y) and torch.equal(sf, want_s)


def test_ops_dispatch_cpu_to_the_plain_version():
    r, k, v, w, u, s0 = (torch.tensor(a) for a in
                         _inputs(1, 32, 2, 32, 3, "model"))
    before = trw.rwkv6_scan.launches
    for state in (None, s0):
        got = ops.rwkv6_scan(r, k, v, w, u, state, chunk=16)
        want = ref.rwkv6_scan(r, k, v, w, u, state, chunk=16)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    meta = torch.empty((1, 16, 2, 32), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.rwkv6_scan(meta, meta, meta, meta, meta[0, 0])
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ref.rwkv6_scan(r[:, :24], k[:, :24], v[:, :24], w[:, :24], u)
    assert trw.rwkv6_scan.launches == before


def test_wrapper_refuses_cpu_tensors_and_inputs_that_require_grad():
    """No backward kernel exists (nor in the JAX package), so the wrapper
    refuses a tensor that requires grad before it looks at the device; a
    CPU tensor is refused (ops sends those to the plain version)."""
    args = [torch.tensor(a) for a in _inputs(1, 16, 2, 32, 4, "model")]
    before = trw.rwkv6_scan.launches
    for i in range(6):
        bad = list(args)
        bad[i] = bad[i].clone().requires_grad_(True)
        with pytest.raises(ValueError, match="no backward"):
            trw.rwkv6_scan(*bad)
    with pytest.raises(ValueError, match="CUDA kernel got a tensor on cpu"):
        trw.rwkv6_scan(*args)
    assert trw.rwkv6_scan.launches == before


@pytest.mark.parametrize("bad,msg", [
    ("r3d", "must be \\(B, S, H, D\\)"), ("k_shape", "!= r"),
    ("u_shape", "u \\("), ("s0_shape", "s0 \\("),
    ("d48", "head size 48"), ("chunk8", "chunk 8 not supported"),
    ("ragged", "multiple of the chunk"), ("f16", "not supported"),
    ("mixed", "dtypes differ"), ("w16", "w must be float32"),
    ("s0_64", "s0 must be float32"),
])
def test_wrapper_checks_before_launch(bad, msg, monkeypatch):
    """With the device check passed, every malformed call raises on its
    shape, dtype, head size or chunk before any launch."""
    monkeypatch.setattr(trw, "_check_cuda", lambda *t: t[0].device)
    x = torch.zeros((1, 32, 2, 32))
    args = [x, x.clone(), x.clone(), x.clone(), torch.zeros((2, 32)),
            torch.zeros((1, 2, 32, 32))]
    kw = {"chunk": 16}
    if bad == "r3d":
        args[0] = torch.zeros((32, 2, 32))
    elif bad == "k_shape":
        args[1] = torch.zeros((1, 32, 2, 16))
    elif bad == "u_shape":
        args[4] = torch.zeros((3, 32))
    elif bad == "s0_shape":
        args[5] = torch.zeros((1, 2, 32, 16))
    elif bad == "d48":
        args = [torch.zeros((1, 32, 2, 48))] * 4 + [
            torch.zeros((2, 48)), None]
    elif bad == "chunk8":
        kw["chunk"] = 8
    elif bad == "ragged":
        args[:4] = [torch.zeros((1, 24, 2, 32))] * 4
    elif bad == "f16":
        args[:3] = [a.half() for a in args[:3]]
    elif bad == "mixed":
        args[2] = args[2].to(torch.bfloat16)
    elif bad == "w16":
        args[3] = args[3].to(torch.bfloat16)
    elif bad == "s0_64":
        args[5] = args[5].double()
    before = trw.rwkv6_scan.launches
    with pytest.raises(ValueError, match=msg):
        trw.rwkv6_scan(*args, **kw)
    assert trw.rwkv6_scan.launches == before
