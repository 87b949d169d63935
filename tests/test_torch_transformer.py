"""The port's transformer against the JAX package's, on the CPU.

Three configs: ``reduced(qwen3-1.7b)`` (4 heads over 4 kv heads, head dim
64, qk-norm), its GQA variant (4 heads over 2, head dim 128) and
``reduced(rwkv6-7b)`` (the ssm family: 2 rwkv blocks of 4 heads of 64,
d_model 256). Params come from ``repro.models.transformer.init_params``
and cross through ``repro_torch.convert``; tokens are made with numpy. The
model forward (full and ``last_only``; 16 tokens, so rwkv runs its chunked
form), ``loss_fn``, 16 teacher-forced decode steps and the decode state's
crossing apply to all three; layers, attention (forward and one decode
step) and the sliding-window ring buffer (tests/test_models.py's recipe)
to the dense two. All are held to tests/test_models.py's tolerances (2e-4
absolute, 2e-3 relative) in f32, and one bf16 forward of each family
(plus 4 rwkv decode steps) to 2e-2. JAX results are computed once per
module.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced as jreduced
from repro.configs.registry import get_arch as jget_arch
from repro.models import attention as jattention
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro_torch import convert
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_arch
from repro_torch.models import attention, layers, transformer

B, S, WIN, S_WIN = 2, 16, 4, 24
ATOL, RTOL = 2e-4, 2e-3


def _cfgs(mod_reduced, mod_get_arch):
    base = mod_reduced(mod_get_arch("qwen3-1.7b"))
    return {"qwen3": base,
            "qwen3-gqa": dataclasses.replace(base, num_heads=4,
                                             num_kv_heads=2, head_dim=128),
            "rwkv6": mod_reduced(mod_get_arch("rwkv6-7b"))}


JCFG = _cfgs(jreduced, jget_arch)
TCFG = _cfgs(reduced, get_arch)
DENSE = ["qwen3", "qwen3-gqa"]


def _t(x):
    return convert.tensor_from_numpy(x, "cpu")


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


@functools.cache
def _case(name):
    """Params, tokens and every JAX result of one config (the windowed
    ones for the dense configs only)."""
    jcfg, tcfg = JCFG[name], TCFG[name]
    jparams = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    win_tokens = rng.integers(0, jcfg.vocab_size,
                              (B, S_WIN)).astype(np.int32)

    fwd = jax.jit(lambda p, t, **kw: jtransformer.forward(
        p, jcfg, {"tokens": t}, **kw)[0],
        static_argnames=("last_only", "window_override"))
    loss = jax.jit(lambda p, t: jtransformer.loss_fn(
        p, jcfg, {"tokens": t, "labels": jnp.roll(t, -1, axis=1)}))

    def decode(tok_seq, window=None):
        step = jax.jit(lambda p, s, t: jtransformer.decode_step(
            p, jcfg, s, t, window_override=window))
        state = jtransformer.init_decode(jcfg, B, tok_seq.shape[1],
                                         window_override=window)
        outs = []
        for t in range(tok_seq.shape[1]):
            lg, state = step(jparams, state, jnp.asarray(tok_seq[:, t]))
            outs.append(np.asarray(lg))
        return np.stack(outs, axis=1), state

    jt = jnp.asarray(tokens)
    dec, state = decode(tokens)
    out = dict(
        name=name, jcfg=jcfg, tcfg=tcfg, jparams=jparams,
        params=convert.transformer_params_from_numpy(jparams, "cpu"),
        tokens=tokens, win_tokens=win_tokens,
        logits=np.asarray(fwd(jparams, jt)),
        last=np.asarray(fwd(jparams, jt, last_only=True)),
        loss=float(loss(jparams, jt)),
        decode=dec, state=state)
    if name in DENSE:
        out.update(win_logits=np.asarray(fwd(jparams, jnp.asarray(win_tokens),
                                             window_override=WIN)),
                   win_decode=decode(win_tokens, WIN)[0])
    return out


@pytest.fixture(scope="module", params=sorted(JCFG))
def case(request):
    return _case(request.param)


@pytest.fixture(scope="module", params=DENSE)
def dense_case(request):
    return _case(request.param)


def test_params_cross_key_for_key(case):
    jflat = jax.tree_util.tree_flatten_with_path(case["jparams"])[0]
    assert len(jflat) == len(jax.tree.leaves(case["params"]))
    for path, leaf in jflat:
        node = case["params"]
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert case["params"]["layers"]["norm1"]["scale"].shape[0] == \
        case["tcfg"].num_layers


def test_init_params_shapes_match_reference(case):
    mine = transformer.init_params(case["tcfg"], torch.Generator()
                                   .manual_seed(0), device="cpu")
    want = jax.tree_util.tree_flatten_with_path(case["jparams"])[0]
    for path, leaf in want:
        node = mine
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        assert node.dtype == torch.float32
    assert sum(t.numel() for t in jax.tree.leaves(mine)) == \
        sum(leaf.size for leaf in jax.tree.leaves(case["jparams"]))


def test_layers_match_reference(dense_case):
    case = dense_case
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, S, 256)).astype(np.float32)
    scale = rng.normal(size=(256,)).astype(np.float32)
    bias = rng.normal(size=(256,)).astype(np.float32)
    _close(layers.rmsnorm({"scale": _t(scale)}, _t(x)),
           jlayers.rmsnorm({"scale": scale}, x), 1e-5, 1e-5)
    _close(layers.layernorm({"scale": _t(scale), "bias": _t(bias)}, _t(x)),
           jlayers.layernorm({"scale": scale, "bias": bias}, x), 1e-5, 1e-5)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    _close(layers.rmsnorm({"scale": _t(scale)}, _t(xb)),
           jlayers.rmsnorm({"scale": jnp.asarray(scale)}, xb), 2e-2, 2e-2)
    hd = case["tcfg"].resolved_head_dim()
    xh = rng.normal(size=(B, S, 2, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 3 + S), (B, S)).astype(np.int32)
    _close(layers.apply_rope(_t(xh), _t(pos), 10_000.0),
           jlayers.apply_rope(xh, pos, 10_000.0), 1e-5, 1e-5)
    mlp = {"w_gate": rng.normal(size=(256, 64)).astype(np.float32) / 16,
           "w_up": rng.normal(size=(256, 64)).astype(np.float32) / 16,
           "w_down": rng.normal(size=(64, 256)).astype(np.float32) / 8}
    tmlp = {k: _t(v) for k, v in mlp.items()}
    _close(layers.swiglu(tmlp, _t(x)), jlayers.swiglu(mlp, x), 1e-5, 1e-4)
    _close(layers.gelu_mlp(tmlp, _t(x)), jlayers.gelu_mlp(mlp, x), 1e-5,
           1e-4)
    table = {"table": rng.normal(size=(40, 256)).astype(np.float32)}
    tok = rng.integers(0, 40, (B, S)).astype(np.int32)
    _close(layers.embed({"table": _t(table["table"])}, _t(tok)),
           jlayers.embed(table, tok), 0, 0)
    _close(layers.unembed({"table": _t(table["table"])}, _t(x)),
           jlayers.unembed(table, x), 1e-5, 1e-5)


def test_attention_forward_and_decode_step_match_reference(dense_case):
    case = dense_case
    jcfg, tcfg = case["jcfg"], case["tcfg"]
    jp = jax.tree.map(lambda l: l[0], case["jparams"]["layers"]["mix"])
    tp = convert.transformer_params_from_numpy(jp, "cpu")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, S, 256)).astype(np.float32)
    _close(attention.forward(tp, tcfg, _t(x)),
           jattention.forward(jp, jcfg, jnp.asarray(x)))
    # one decode step into a cache that already holds 5 tokens
    jcache = jattention.init_cache(jcfg, B, 8)
    hd = tcfg.resolved_head_dim()
    kv = rng.normal(size=(2, B, 8, tcfg.num_kv_heads, hd)).astype(np.float32)
    jcache = jcache._replace(k=jnp.asarray(kv[0]), v=jnp.asarray(kv[1]),
                             length=jnp.int32(5))
    tcache = attention.KVCache(_t(kv[0]), _t(kv[1]),
                               torch.tensor(5, dtype=torch.int32))
    x1 = x[:, :1]
    jout, jnew = jattention.decode_step(jp, jcfg, jnp.asarray(x1), jcache)
    tout, tnew = attention.decode_step(tp, tcfg, _t(x1), tcache)
    _close(tout, jout)
    _close(tnew.k, jnew.k)
    _close(tnew.v, jnew.v)
    assert int(tnew.length) == int(jnew.length) == 6


def test_forward_full_and_last_only_match_reference(case):
    tok = _t(case["tokens"])
    logits, aux = transformer.forward(case["params"], case["tcfg"],
                                      {"tokens": tok})
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    _close(logits, case["logits"])
    last, _ = transformer.forward(case["params"], case["tcfg"],
                                  {"tokens": tok}, last_only=True)
    assert tuple(last.shape) == (B, 1, case["tcfg"].vocab_size)
    _close(last, case["last"])


def test_loss_matches_reference(case):
    tok = _t(case["tokens"])
    got = transformer.loss_fn(case["params"], case["tcfg"],
                              {"tokens": tok,
                               "labels": torch.roll(tok, -1, dims=1)})
    assert abs(float(got) - case["loss"]) <= ATOL + RTOL * abs(case["loss"])


def test_decode_16_tokens_matches_reference_and_forward(case):
    state = transformer.init_decode(case["tcfg"], B, S, device="cpu")
    outs = []
    for t in range(S):
        lg, state = transformer.decode_step(case["params"], case["tcfg"],
                                            state, _t(case["tokens"][:, t]))
        outs.append(lg)
    dec = torch.stack(outs, dim=1)
    _close(dec, case["decode"])
    _close(dec, case["logits"])
    assert int(state.pos) == S
    if case["name"] in DENSE:
        assert state.states.length.tolist() == [S] * case["tcfg"].num_layers
    assert state.states._fields == case["state"].states._fields
    for got, want in zip(state.states, case["state"].states):
        _close(got, want)


def test_decode_state_crosses_from_numpy(case):
    state = convert.decode_state_from_numpy(case["state"], "cpu")
    assert state.states._fields == case["state"].states._fields
    for got, want in zip(state.states, case["state"].states):
        assert tuple(got.shape) == want.shape
    if case["name"] in DENSE:
        assert state.states.length.dtype == torch.int32
    else:
        assert state.states.s.dtype == torch.float32
    assert int(state.pos) == S
    # one more token from the crossed state equals one more in JAX
    nxt = case["tokens"][:, 0]
    lg, _ = transformer.decode_step(case["params"], case["tcfg"], state,
                                    _t(nxt))
    want, _ = jtransformer.decode_step(case["jparams"], case["jcfg"],
                                       case["state"], jnp.asarray(nxt))
    _close(lg, want)


def test_sliding_window_ring_buffer_matches_reference(dense_case):
    """tests/test_models.py::test_sliding_window_ring_buffer_decode's
    recipe: window 4, 24 tokens, the cache sized to the window."""
    case = dense_case
    tok = _t(case["win_tokens"])
    logits, _ = transformer.forward(case["params"], case["tcfg"],
                                    {"tokens": tok}, window_override=WIN)
    _close(logits, case["win_logits"])
    state = transformer.init_decode(case["tcfg"], B, S_WIN,
                                    window_override=WIN, device="cpu")
    assert state.states.k.shape[2] == WIN          # (L, B, win, KV, D)
    outs = []
    for t in range(S_WIN):
        lg, state = transformer.decode_step(case["params"], case["tcfg"],
                                            state, tok[:, t],
                                            window_override=WIN)
        outs.append(lg)
    dec = torch.stack(outs, dim=1)
    _close(dec, case["win_decode"])
    _close(dec, logits)


def test_bf16_forward_matches_reference():
    jcfg = dataclasses.replace(JCFG["qwen3-gqa"], dtype="bfloat16")
    tcfg = dataclasses.replace(TCFG["qwen3-gqa"], dtype="bfloat16")
    jparams = jtransformer.init_params(jax.random.PRNGKey(2), jcfg)
    params = convert.transformer_params_from_numpy(jparams, "cpu")
    assert params["layers"]["mix"]["wq"].dtype == torch.bfloat16
    tokens = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    want, _ = jax.jit(lambda p, t: jtransformer.forward(
        p, jcfg, {"tokens": t}))(jparams, jnp.asarray(tokens))
    got, _ = transformer.forward(params, tcfg, {"tokens": _t(tokens)})
    _close(got, want, 2e-2, 2e-2)


def test_bf16_rwkv_forward_and_decode_match_reference():
    """The ssm family in bf16: a chunked forward of 16 tokens, then 4
    decode steps from the zero state; r/k/v and the layer outputs in bf16,
    the decays and the wkv state in f32 on both sides."""
    jcfg = dataclasses.replace(JCFG["rwkv6"], dtype="bfloat16")
    tcfg = dataclasses.replace(TCFG["rwkv6"], dtype="bfloat16")
    jparams = jtransformer.init_params(jax.random.PRNGKey(3), jcfg)
    params = convert.transformer_params_from_numpy(jparams, "cpu")
    assert params["layers"]["mix"]["wr"].dtype == torch.bfloat16
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    want, _ = jax.jit(lambda p, t: jtransformer.forward(
        p, jcfg, {"tokens": t}))(jparams, jnp.asarray(tokens))
    got, _ = transformer.forward(params, tcfg, {"tokens": _t(tokens)})
    _close(got, want, 2e-2, 2e-2)
    step = jax.jit(lambda p, s, t: jtransformer.decode_step(p, jcfg, s, t))
    jstate = jtransformer.init_decode(jcfg, B, 4)
    state = transformer.init_decode(tcfg, B, 4, device="cpu")
    for t in range(4):
        want, jstate = step(jparams, jstate, jnp.asarray(tokens[:, t]))
        got, state = transformer.decode_step(params, tcfg, state,
                                             _t(tokens[:, t]))
        _close(got, want, 2e-2, 2e-2)
    assert state.states.s.dtype == torch.float32
    assert state.states.x_prev.dtype == torch.bfloat16 == \
        convert.decode_state_from_numpy(jstate, "cpu").states.x_prev.dtype
