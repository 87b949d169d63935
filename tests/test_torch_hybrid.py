"""The port's heterogeneous (hybrid) transformer against the JAX package's,
on the CPU: zamba2's widths at reduced size with the 4-layer pattern
("mamba", "shared_attn", "mamba", "shared_attn"), which ``reduced`` alone
never builds (it keeps ``block_pattern[:2]``, two mamba blocks). Two
``shared_attn`` layers use the one ``"shared_attn"`` param set.

Params come from ``repro.models.transformer.init_params`` (``"layers_list"``
and ``"shared_attn"``) and cross through ``repro_torch.convert``; tokens
are made with numpy. The params' layout, the forward, ``loss_fn``, 16
teacher-forced decode steps (a list of per-layer states: KV caches and
mamba states) and their crossing, the shared set reaching both of its
layers, every gradient leaf against ``jax.value_and_grad`` (the shared
set's gradient sums both uses) at 1e-5 of its max |value| (the mamba
per-head scalars at 1e-4), ``remat``
bit for bit the plain backward, and each bf16 block on the reference's
bf16 input. f32 at
tests/test_models.py's 2e-4 / 2e-3, bf16 at 2e-2.
"""
import dataclasses
import functools
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get_smoke_arch as jget_smoke_arch
from repro.models import transformer as jtransformer
from repro_torch import convert
from repro_torch.configs.registry import get_smoke_arch
from repro_torch.core import flatten
from repro_torch.models import attention, mamba, transformer

PATTERN = ("mamba", "shared_attn", "mamba", "shared_attn")
B, S = 2, 16
ATOL, RTOL = 2e-4, 2e-3


def _cfg(get, dtype="float32"):
    return dataclasses.replace(get("zamba2-1.2b"), num_layers=4,
                               block_pattern=PATTERN, dtype=dtype)


def _t(x):
    return convert.tensor_from_numpy(x, "cpu")


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(tokens):
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}


@functools.cache
def _case():
    jcfg, tcfg = _cfg(jget_smoke_arch), _cfg(get_smoke_arch)
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
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jtransformer.loss_fn(
        p, jcfg, jax.tree.map(jnp.asarray, _batch(tokens)))))(jparams)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tokens=tokens,
                params=convert.transformer_params_from_numpy(jparams, "cpu"),
                logits=np.asarray(logits), loss=float(loss),
                grads=_numpy(grads), decode=np.stack(outs, axis=1),
                state=state, step=step)


def test_params_layout_and_crossing_match_reference():
    case = _case()
    params = case["params"]
    assert set(params) == {"embed", "final_norm", "lm_head", "layers_list",
                           "shared_attn"}
    assert [set(p) for p in params["layers_list"]] == [
        {"norm1", "norm2", "mix", "ffn"}, {"norm1", "norm2", "ffn"}] * 2
    jflat = jax.tree_util.tree_flatten_with_path(case["jparams"])[0]
    crossed = dict(flatten.leaves_with_paths(params))
    assert len(jflat) == len(crossed)
    mine = transformer.init_params(case["tcfg"], device="cpu")
    drawn = dict(flatten.leaves_with_paths(mine))
    assert set(drawn) == set(crossed)
    for path, leaf in crossed.items():
        assert drawn[path].shape == leaf.shape, path
        assert drawn[path].dtype == torch.float32


def test_forward_and_loss_match_reference():
    case = _case()
    tok = _t(case["tokens"])
    logits, aux = transformer.forward(case["params"], case["tcfg"],
                                      {"tokens": tok})
    _close(logits, case["logits"])
    assert float(aux) == 0.0
    last, _ = transformer.forward(case["params"], case["tcfg"],
                                  {"tokens": tok}, last_only=True)
    _close(last[:, 0], case["logits"][:, -1])
    loss = transformer.loss_fn(case["params"], case["tcfg"],
                               {k: _t(v) for k, v in
                                _batch(case["tokens"]).items()})
    assert abs(float(loss) - case["loss"]) <= ATOL + RTOL * case["loss"]


def test_the_shared_set_serves_both_of_its_layers():
    case = _case()
    seen = []
    real = attention.forward

    def spy(params, cfg, x, **kw):
        seen.append(params)
        return real(params, cfg, x, **kw)

    with unittest.mock.patch.object(attention, "forward", spy):
        transformer.forward(case["params"], case["tcfg"],
                            {"tokens": _t(case["tokens"])})
    assert len(seen) == 2
    assert all(p is case["params"]["shared_attn"] for p in seen)


def test_decode_16_tokens_matches_reference_and_forward():
    case = _case()
    state = transformer.init_decode(case["tcfg"], B, S, device="cpu")
    assert [type(s) for s in state.states] == [
        mamba.MambaState, attention.KVCache] * 2
    outs = []
    for t in range(S):
        lg, state = transformer.decode_step(case["params"], case["tcfg"],
                                            state, _t(case["tokens"][:, t]))
        outs.append(lg)
    dec = torch.stack(outs, dim=1)
    _close(dec, case["decode"])
    _close(dec, case["logits"])
    assert int(state.pos) == S
    for got, want in zip(state.states, case["state"].states):
        assert got._fields == want._fields
        for a, b in zip(got, want):
            _close(a, b)
    assert [int(state.states[i].length) for i in (1, 3)] == [S, S]
    crossed = convert.decode_state_from_numpy(case["state"], "cpu")
    assert [type(s) for s in crossed.states] == [type(s) for s in
                                                state.states]
    nxt = case["tokens"][:, 0]
    lg, _ = transformer.decode_step(case["params"], case["tcfg"], crossed,
                                    _t(nxt))
    want, _ = case["step"](case["jparams"], case["state"], jnp.asarray(nxt))
    _close(lg, want)


def _grads(case, **kw):
    params = convert.transformer_params_from_numpy(_numpy(case["jparams"]),
                                                   "cpu")
    leaves = flatten.leaves_with_paths(params)
    for _, leaf in leaves:
        leaf.requires_grad_(True)
    loss = transformer.loss_fn(params, case["tcfg"],
                               {k: _t(v) for k, v in
                                _batch(case["tokens"]).items()}, **kw)
    loss.backward()
    return loss.item(), {path: leaf.grad for path, leaf in leaves}


# a mamba block's per-head decay and step bias: each gradient entry sums
# the head's B·S·64·16 (position, channel, state) terms, which cancel to
# about 1/30 of their scale, so the f32 summation order shows at 1.2e-5 -
# 2.3e-5 of max |value| (measured); tests/test_torch_lm_train.py's 1e-4
HEAD_SCALARS = {"a_log": 1e-4, "dt_bias": 1e-4}


def test_loss_and_every_gradient_leaf_match_jax():
    case = _case()
    loss, grads = _grads(case)
    assert abs(loss - case["loss"]) <= 1e-5 * abs(case["loss"])
    want = dict(flatten.leaves_with_paths(case["grads"]))
    assert set(want) == set(grads)
    assert any(path[0] == "shared_attn" for path in want)
    for path, g in want.items():
        err = np.abs(grads[path].numpy() - g).max()
        tol = HEAD_SCALARS.get(path[-1], 1e-5)
        assert err <= tol * np.abs(g).max(), (path, err)


def test_remat_gives_the_plain_backward_bit_for_bit():
    case = _case()
    loss, grads = _grads(case)
    loss_r, grads_r = _grads(case, remat=True)
    assert loss_r == loss
    for path, g in grads.items():
        assert torch.equal(grads_r[path], g), path


def test_bf16_blocks_match_reference_block_by_block():
    """bf16 params and activations, each block of the pattern on the
    reference's own bf16 input (the previous block's output): within 2**-6
    of the block output's max |value|, the card's block gate for rwkv6.
    On the same input a block's bf16 output differs from the reference's
    by 1-2 bf16 ulps (f32 sums in another order before the last rounding);
    chained, these reach 0.026 in the logits after 4 blocks, whose residual
    stream grows to |x| of about 7 (ulp 2**-5). The bf16 forward of the
    hybrid family at 2e-2 is the smoke zamba2's
    (tests/test_torch_mamba.py)."""
    jcfg, tcfg = _cfg(jget_smoke_arch, "bfloat16"), _cfg(get_smoke_arch,
                                                          "bfloat16")
    jparams = jtransformer.init_params(jax.random.PRNGKey(2), jcfg)
    params = convert.transformer_params_from_numpy(jparams, "cpu")
    assert params["shared_attn"]["wq"].dtype == torch.bfloat16
    tokens = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    x = jnp.take(jparams["embed"]["table"], jnp.asarray(tokens), axis=0)
    for i, kind in enumerate(PATTERN):
        shared = kind == "shared_attn"
        want, _, _ = jax.jit(lambda p, h, sh, kind=kind:
                             jtransformer._apply_block(
                                 p, jcfg, kind, h, shared=sh))(
            jparams["layers_list"][i], x,
            jparams["shared_attn"] if shared else None)
        got, _, _ = transformer._apply_block(
            params["layers_list"][i], tcfg, kind, _t(x),
            shared=params["shared_attn"] if shared else None)
        assert got.dtype == torch.bfloat16
        want32 = np.asarray(want, np.float32)
        err = np.abs(got.float().numpy() - want32).max()
        assert err <= 2.0 ** -6 * np.abs(want32).max(), (i, kind, err)
        x = want
