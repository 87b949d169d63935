"""The port's Mamba2 block and the smoke zamba2 (a homogeneous mamba
stack: ``reduced`` keeps ``block_pattern[:2]`` = (mamba, mamba)) against
the JAX package's, on the CPU.

``scan_reference`` and ``chunked`` on tests/test_ssm.py's shapes and
input recipe (made with numpy): each against the reference's at 1e-5 of
max |value| (the loop over chunk summaries in place of the reference's
associative scan changes the f32 summation order only), and ``chunked``
against ``scan_reference`` at the reference's own 5e-4 / 1e-3; the causal
conv and its tail; ``init``; the block's forward (chunked and scan) and
its decode continuity (tests/test_ssm.py's recipe); the bf16 block, whose
conv tail comes back in bf16 as the reference's does; the smoke model's
forward, ``loss_fn``, 16 teacher-forced decode steps and the decode
state's crossing; a bf16 model forward. f32 at tests/test_models.py's
2e-4 / 2e-3, bf16 at 2e-2.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_arch as jget_smoke_arch
from repro.models import mamba as jmamba
from repro.models import transformer as jtransformer
from repro_torch import convert
from repro_torch.configs.registry import get_smoke_arch
from repro_torch.models import mamba, transformer

B, S = 2, 16
ATOL, RTOL = 2e-4, 2e-3
SHAPES = [(1, 16, 1, 32, 8), (2, 64, 4, 64, 16), (1, 128, 2, 16, 4)]


def _t(x):
    return convert.tensor_from_numpy(x, "cpu")


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _rel(got, want, tol):
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), err


def _inputs(b, s, h, d, n, seed):
    """tests/test_ssm.py's recipe, drawn with numpy."""
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(b, s, h, d)).astype(np.float32)
    bt = rng.normal(size=(b, s, n)).astype(np.float32)
    ct = rng.normal(size=(b, s, n)).astype(np.float32)
    dt = np.logaddexp(rng.normal(size=(b, s, h)), 0).astype(np.float32)
    a = np.exp(np.linspace(0.0, 1.5, h)).astype(np.float32)
    h0 = (rng.normal(size=(b, h, d, n)) * 0.3).astype(np.float32)
    return xh, bt, ct, dt, a, h0


@pytest.mark.parametrize("b,s,h,d,n", SHAPES)
def test_scan_and_chunked_match_reference(b, s, h, d, n):
    args = _inputs(b, s, h, d, n, seed=s)
    targs = [_t(x) for x in args]
    jargs = [jnp.asarray(x) for x in args]
    ys, ss = mamba.scan_reference(*targs)
    yc, sc = mamba.chunked(*targs)
    jys, jss = jax.jit(jmamba.scan_reference)(*jargs)
    jchunked = jax.jit(jmamba.chunked, static_argnames="chunk")
    jyc, jsc = jchunked(*jargs)
    for got, want in ((ys, jys), (ss, jss), (yc, jyc), (sc, jsc)):
        _rel(got, want, 1e-5)
    _close(yc, ys, 5e-4, 1e-3)
    _close(sc, ss, 5e-4, 1e-3)
    # from the zero state, and a chunk of 8
    z = torch.zeros_like(targs[5])
    yc8, _ = mamba.chunked(*targs[:5], z, chunk=8)
    _rel(yc8, jchunked(*jargs[:5], jnp.zeros_like(jargs[5]), chunk=8)[0],
         1e-5)


def test_chunked_refuses_a_ragged_sequence():
    args = [_t(x) for x in _inputs(1, 20, 1, 16, 4, seed=0)]
    with pytest.raises(ValueError, match="multiple of the chunk"):
        mamba.chunked(*args)


def _block_case(dtype="float32"):
    jcfg = dataclasses.replace(jget_smoke_arch("zamba2-1.2b"), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_arch("zamba2-1.2b"), dtype=dtype)
    jp = jmamba.init(jax.random.PRNGKey(0), jcfg, jnp.dtype(dtype))
    x = jnp.asarray(np.random.default_rng(1).normal(
        size=(2, 32, jcfg.d_model)), jnp.dtype(dtype))
    return jcfg, tcfg, jp, convert.transformer_params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu"), x


def test_init_and_causal_conv_match_reference():
    jcfg, tcfg, jp, tp, x = _block_case()
    mine = mamba.init(torch.Generator().manual_seed(0), tcfg)
    assert set(mine) == set(tp)
    for name, leaf in tp.items():
        leaf = leaf if isinstance(leaf, torch.Tensor) else leaf["scale"]
        got = mine[name] if isinstance(mine[name], torch.Tensor) \
            else mine[name]["scale"]
        assert got.shape == leaf.shape and got.dtype == leaf.dtype, name
    for name in ("conv_b", "a_log", "dt_bias", "d_skip"):
        _close(mine[name], tp[name], 1e-6, 1e-6)
    assert mamba.dims(tcfg) == jmamba.dims(jcfg)
    rng = np.random.default_rng(2)
    xbc = rng.normal(size=(2, 7, 40)).astype(np.float32)
    tail = rng.normal(size=(2, 3, 40)).astype(np.float32)
    w = rng.normal(size=(4, 40)).astype(np.float32)
    bias = rng.normal(size=(40,)).astype(np.float32)
    out, new_tail = mamba._causal_conv(_t(xbc), _t(w), _t(bias), _t(tail))
    jout, jtail = jmamba._causal_conv(xbc, w, bias, tail)
    _close(out, jout, 1e-6, 1e-5)
    _close(new_tail, jtail, 0, 0)


@pytest.mark.parametrize("use_chunked", [None, False])
def test_block_forward_and_decode_continuity_match_reference(use_chunked):
    """tests/test_ssm.py::test_mamba_prefill_then_decode_continuity: the
    32-token forward (chunked, or the scan) against the reference's, and
    32 decode steps from the zero state against the forward."""
    jcfg, tcfg, jp, tp, x = _block_case()
    out, st = mamba.forward(tp, tcfg, _t(x), use_chunked=use_chunked)
    jout, jst = jax.jit(lambda p, x: jmamba.forward(
        p, jcfg, x, use_chunked=use_chunked))(jp, x)
    _close(out, jout)
    _rel(st.h, jst.h, 1e-5)
    _rel(st.conv, jst.conv, 1e-5)
    state = mamba.init_state(tcfg, 2, "cpu")
    assert state.h.dtype == state.conv.dtype == torch.float32
    outs = []
    for t in range(32):
        o, state = mamba.decode_step(tp, tcfg, _t(x[:, t:t + 1]), state)
        outs.append(o)
    dec = torch.cat(outs, dim=1)
    _close(dec, out, 5e-4, 1e-2)
    _close(state.h, st.h, 5e-4, 1e-2)


def test_bf16_block_and_its_state_dtypes_match_reference():
    """bf16 params and input: the ssm state stays f32, the conv tail comes
    back in bf16 (the reference's ``_causal_conv`` returns it in the
    input's dtype), so a bf16 decode reads what the reference reads."""
    jcfg, tcfg, jp, tp, x = _block_case("bfloat16")
    out, st = mamba.forward(tp, tcfg, _t(x))
    jout, jst = jax.jit(lambda p, x: jmamba.forward(p, jcfg, x))(jp, x)
    assert out.dtype == torch.bfloat16
    _close(out, jout, 2e-2, 2e-2)
    assert st.h.dtype == torch.float32 and st.conv.dtype == torch.bfloat16
    assert np.asarray(jst.conv).dtype.name == "bfloat16"
    jstep = jax.jit(lambda p, x, s: jmamba.decode_step(p, jcfg, x, s))
    for t in range(2):
        o, st = mamba.decode_step(tp, tcfg, _t(x[:, t:t + 1]), st)
        jo, jst = jstep(jp, x[:, t:t + 1], jst)
        _close(o, jo, 2e-2, 2e-2)
    assert st.conv.dtype == torch.bfloat16


# --- the smoke zamba2: a homogeneous mamba stack ----------------------------

@functools.cache
def _model():
    jcfg, tcfg = jget_smoke_arch("zamba2-1.2b"), get_smoke_arch("zamba2-1.2b")
    assert tcfg.blocks() == ("mamba", "mamba")
    jparams = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jt = jnp.asarray(tokens)
    step = jax.jit(lambda p, s, t: jtransformer.decode_step(p, jcfg, s, t))
    state = jtransformer.init_decode(jcfg, B, S)
    outs = []
    for t in range(S):
        lg, state = step(jparams, state, jt[:, t])
        outs.append(np.asarray(lg))
    logits, _ = jax.jit(lambda p, t: jtransformer.forward(
        p, jcfg, {"tokens": t}))(jparams, jt)
    loss = jax.jit(lambda p, t: jtransformer.loss_fn(
        p, jcfg, {"tokens": t, "labels": jnp.roll(t, -1, axis=1)}))
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                params=convert.transformer_params_from_numpy(jparams, "cpu"),
                tokens=tokens, logits=np.asarray(logits),
                loss=float(loss(jparams, jt)),
                decode=np.stack(outs, axis=1), state=state, step=step)


def test_smoke_model_forward_loss_and_params_match_reference():
    case = _model()
    mine = transformer.init_params(case["tcfg"], device="cpu")
    assert set(mine["layers"]) == set(case["params"]["layers"])
    assert mine["layers"]["mix"]["w_in"].shape == \
        case["params"]["layers"]["mix"]["w_in"].shape
    tok = _t(case["tokens"])
    logits, aux = transformer.forward(case["params"], case["tcfg"],
                                      {"tokens": tok})
    _close(logits, case["logits"])
    assert float(aux) == 0.0
    loss = transformer.loss_fn(case["params"], case["tcfg"],
                               {"tokens": tok,
                                "labels": torch.roll(tok, -1, dims=1)})
    assert abs(float(loss) - case["loss"]) <= ATOL + RTOL * case["loss"]


def test_smoke_model_decode_16_tokens_and_state_crossing():
    case = _model()
    state = transformer.init_decode(case["tcfg"], B, S, device="cpu")
    assert tuple(state.states.h.shape) == (2, B, 8, 64, 16)
    outs = []
    for t in range(S):
        lg, state = transformer.decode_step(case["params"], case["tcfg"],
                                            state, _t(case["tokens"][:, t]))
        outs.append(lg)
    dec = torch.stack(outs, dim=1)
    _close(dec, case["decode"])
    _close(dec, case["logits"])
    assert state.states._fields == case["state"].states._fields
    for got, want in zip(state.states, case["state"].states):
        _close(got, want)
    crossed = convert.decode_state_from_numpy(case["state"], "cpu")
    assert isinstance(crossed.states, mamba.MambaState)
    nxt = case["tokens"][:, 0]
    lg, _ = transformer.decode_step(case["params"], case["tcfg"], crossed,
                                    _t(nxt))
    want, _ = case["step"](case["jparams"], case["state"], jnp.asarray(nxt))
    _close(lg, want)


def test_bf16_smoke_model_forward_matches_reference():
    jcfg = dataclasses.replace(jget_smoke_arch("zamba2-1.2b"),
                               dtype="bfloat16")
    tcfg = dataclasses.replace(get_smoke_arch("zamba2-1.2b"),
                               dtype="bfloat16")
    jparams = jtransformer.init_params(jax.random.PRNGKey(2), jcfg)
    params = convert.transformer_params_from_numpy(jparams, "cpu")
    tokens = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    want, _ = jax.jit(lambda p, t: jtransformer.forward(
        p, jcfg, {"tokens": t}))(jparams, jnp.asarray(tokens))
    got, _ = transformer.forward(params, tcfg, {"tokens": _t(tokens)})
    _close(got, want, 2e-2, 2e-2)
