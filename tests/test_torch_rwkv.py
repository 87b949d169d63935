"""The port's rwkv6 time-mix block against the JAX package's
``repro.models.rwkv``, on the CPU in f32.

``scan_reference`` and ``chunked`` (with and without an initial state) are
held to the JAX function of the same name at tests/test_ssm.py's shapes,
tightly: the scan to 1e-5 (the same recurrence, both sequential), the
chunked form to 2e-4 absolute / 1e-5 relative (the port's plain B10
computes the pairwise form where the reference factorises, against |y| up
to about 100); the chunked form against the scan at tests/test_ssm.py's
5e-4 / 1e-3. ``_mix`` (and its decay clamp), ``init``'s keys and shapes,
``forward`` at S=32 (chunked) and S=20 (scan) and a prefill followed by 32
decode steps (tests/test_ssm.py's continuity recipe) are held to 2e-5 /
1e-4 on params that cross from JAX through ``repro_torch.convert``.
Inputs are made with numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_arch as jget_smoke_arch
from repro.models import rwkv as jrwkv
from repro_torch import convert
from repro_torch.configs.registry import get_smoke_arch
from repro_torch.models import rwkv

JCFG, TCFG = jget_smoke_arch("rwkv6-7b"), get_smoke_arch("rwkv6-7b")
B = 2


def _close(got, want, atol=2e-5, rtol=1e-4):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _scan_inputs(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, d)) for _ in range(3))
    w = np.exp(-np.clip(np.exp(rng.normal(size=(b, s, h, d))), 1e-6,
                        rwkv.MAX_LOG_DECAY))
    u = rng.normal(size=(h, d)) * 0.1
    s0 = rng.normal(size=(b, h, d, d)) * 0.3
    return [a.astype(np.float32) for a in (r, k, v, w, u, s0)]


@pytest.fixture(scope="module")
def block():
    """One rwkv block's params (JAX and crossed), an input and the JAX
    forward, per-token decode and decode states."""
    jparams = jrwkv.init(jax.random.PRNGKey(0), JCFG)
    x = np.random.default_rng(1).normal(
        size=(B, 32, JCFG.d_model)).astype(np.float32)
    fwd = jax.jit(lambda p, x: jrwkv.forward(p, JCFG, x))
    step = jax.jit(lambda p, x, st: jrwkv.decode_step(p, JCFG, x, st))
    out, st_full = fwd(jparams, jnp.asarray(x))
    out20, st20 = fwd(jparams, jnp.asarray(x[:, :20]))
    # prefill 16 tokens (chunked), then 16 decode steps from its state
    _, st16 = fwd(jparams, jnp.asarray(x[:, :16]))
    st, outs = st16, []
    for t in range(16, 32):
        o, st = step(jparams, jnp.asarray(x[:, t:t + 1]), st)
        outs.append(np.asarray(o))
    # 32 decode steps from the zero state
    st0, outs0 = jrwkv.init_state(JCFG, B), []
    for t in range(32):
        o, st0 = step(jparams, jnp.asarray(x[:, t:t + 1]), st0)
        outs0.append(np.asarray(o))
    return dict(jparams=jparams,
                params=convert.transformer_params_from_numpy(jparams, "cpu"),
                x=x, out=np.asarray(out), s=np.asarray(st_full.s),
                out20=np.asarray(out20), s20=np.asarray(st20.s),
                dec_after16=np.concatenate(outs, axis=1), s_after16=st,
                dec=np.concatenate(outs0, axis=1), s_dec=np.asarray(st0.s))


@pytest.mark.parametrize("b,s,h,d", [(1, 16, 1, 32), (2, 64, 3, 64),
                                     (1, 128, 2, 16)])
@pytest.mark.parametrize("with_state", [False, True])
def test_scan_and_chunked_match_reference(b, s, h, d, with_state):
    arrs = _scan_inputs(b, s, h, d, s)
    if not with_state:
        arrs[5] = None
    jarrs = [None if a is None else jnp.asarray(a) for a in arrs]
    targs = [None if a is None else torch.tensor(a) for a in arrs]
    ys, ss = rwkv.scan_reference(*targs)
    jys, jss = jrwkv.scan_reference(*jarrs)
    _close(ys, jys, 1e-5, 1e-5)
    _close(ss, jss, 1e-5, 1e-5)
    yc, sc = rwkv.chunked(*targs)
    jyc, jsc = jrwkv.chunked(*jarrs)
    _close(yc, jyc, 2e-4, 1e-5)
    _close(sc, jsc, 2e-4, 1e-5)
    _close(yc, jys, 5e-4, 1e-3)
    _close(sc, jss, 5e-4, 1e-3)


def test_init_keys_shapes_and_dtypes_match_reference():
    jp = jrwkv.init(jax.random.PRNGKey(0), JCFG, jnp.bfloat16)
    tp = rwkv.init(torch.Generator().manual_seed(0), TCFG, torch.bfloat16,
                   "cpu")
    assert sorted(tp) == sorted(jp)
    for name, leaf in jp.items():
        assert tuple(tp[name].shape) == leaf.shape, name
        assert tp[name].dtype == torch.bfloat16
    for name in ("decay_w0", "mu_r", "mu_k", "mu_v", "mu_w"):
        np.testing.assert_array_equal(tp[name].float().numpy(),
                                      np.asarray(jp[name], np.float32))
    assert rwkv.num_heads(TCFG) == jrwkv.num_heads(JCFG) == 4
    assert rwkv.head_size(TCFG) == jrwkv.head_size(JCFG) == 64
    st, jst = rwkv.init_state(TCFG, 3, "cpu"), jrwkv.init_state(JCFG, 3)
    assert tuple(st.s.shape) == jst.s.shape
    assert tuple(st.x_prev.shape) == jst.x_prev.shape
    assert st.s.dtype == st.x_prev.dtype == torch.float32


def test_mix_and_decay_clamp_match_reference(block):
    """tests/test_ssm.py::test_rwkv_decay_clamp_active's input (x * 50):
    the clamp holds w >= e^-4, in f32, on both sides."""
    x = np.random.default_rng(2).normal(
        size=(1, 8, JCFG.d_model)).astype(np.float32) * 50
    jxs = jrwkv._shift(jnp.asarray(x), jnp.zeros((1, JCFG.d_model)))
    txs = rwkv._shift(torch.tensor(x), torch.zeros((1, TCFG.d_model)))
    _close(txs, jxs, 0, 0)
    got = rwkv._mix(block["params"], torch.tensor(x), txs)
    want = jrwkv._mix(block["jparams"], jnp.asarray(x), jxs)
    for g, w_ in zip(got, want):
        _close(g, w_, 2e-4, 1e-4)
    assert got[3].dtype == torch.float32
    assert float(got[3].min()) >= np.exp(-rwkv.MAX_LOG_DECAY) - 1e-6


def test_forward_chunked_and_scan_match_reference(block):
    x = torch.tensor(block["x"])
    out, st = rwkv.forward(block["params"], TCFG, x)        # S=32: chunked
    _close(out, block["out"])
    _close(st.s, block["s"], 1e-4, 1e-4)
    assert torch.equal(st.x_prev, x[:, -1])
    out20, st20 = rwkv.forward(block["params"], TCFG, x[:, :20])  # scan
    _close(out20, block["out20"])
    _close(st20.s, block["s20"], 1e-4, 1e-4)


def test_prefill_then_decode_matches_reference(block):
    """tests/test_ssm.py::test_rwkv_prefill_then_decode_continuity: 32
    decode steps from the zero state equal the S=32 forward; a chunked
    prefill of 16 tokens then 16 decode steps from its state equal the
    reference's."""
    x = torch.tensor(block["x"])
    st, outs = rwkv.init_state(TCFG, B, "cpu"), []
    for t in range(32):
        o, st = rwkv.decode_step(block["params"], TCFG, x[:, t:t + 1], st)
        outs.append(o)
    dec = torch.cat(outs, dim=1)
    _close(dec, block["dec"])
    _close(st.s, block["s_dec"], 1e-4, 1e-4)
    _close(dec, block["out"], 5e-4, 1e-2)
    _, st = rwkv.forward(block["params"], TCFG, x[:, :16])
    outs = []
    for t in range(16, 32):
        o, st = rwkv.decode_step(block["params"], TCFG, x[:, t:t + 1], st)
        outs.append(o)
    _close(torch.cat(outs, dim=1), block["dec_after16"])
    _close(st.s, block["s_after16"].s, 1e-4, 1e-4)
    _close(st.x_prev, block["s_after16"].x_prev, 0, 0)
