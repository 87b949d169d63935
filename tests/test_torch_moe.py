"""The port's MoE layer and MoE transformer against the JAX package's, on
the CPU.

Two configs: ``reduced(mixtral-8x7b)`` (4 experts top-2, a 128-token
sliding window) and ``reduced(dbrx-132b)`` (4 experts top-4). Layer params
come from ``repro.models.transformer.init_params`` and cross through
``repro_torch.convert``; inputs are made with numpy. The layer's
``forward`` at the config's capacity and at tests/test_models.py's tight
``capacity_factor=0.25`` (drops, the slot table's discarded column and the
combine's clamp), its ``decode_forward``, the aux loss and a routing tie
(the stable top-k order of ``jax.lax.top_k``); the model's forward,
``loss_fn``, 16 teacher-forced decode steps at ``capacity_factor=8.0``
(tests/test_models.py:64-65: decode drops nothing, so it matches prefill
only when prefill drops nothing), every gradient leaf of ``loss_fn``
against ``jax.value_and_grad`` for mixtral, and a bf16 forward. f32 at
tests/test_models.py's 2e-4 / 2e-3, bf16 at 2e-2. JAX results are
computed once per module.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_arch as jget_smoke_arch
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro_torch import convert
from repro_torch.configs.registry import get_smoke_arch
from repro_torch.core import flatten
from repro_torch.models import moe, transformer

ARCHS = ["mixtral-8x7b", "dbrx-132b"]
B, S = 2, 16
ATOL, RTOL = 2e-4, 2e-3


def _t(x):
    return convert.tensor_from_numpy(x, "cpu")


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


@functools.cache
def _case(arch):
    jcfg, tcfg = jget_smoke_arch(arch), get_smoke_arch(arch)
    jparams = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    jffn = jax.tree.map(lambda leaf: leaf[0], jparams["layers"]["ffn"])
    layer = {}
    for factor in (jcfg.capacity_factor, 0.25):
        c = dataclasses.replace(jcfg, capacity_factor=factor)
        layer[factor] = [np.asarray(v) for v in jax.jit(
            lambda p, x, c=c: jmoe.forward(p, c, x, group_size=8))(
                jffn, jnp.asarray(x))]
    dec = np.asarray(jax.jit(lambda p, x: jmoe.decode_forward(
        p, jcfg, x))(jffn, jnp.asarray(x[:, :1]))[0])

    wide = dataclasses.replace(jcfg, capacity_factor=8.0)
    fwd = jax.jit(lambda p, t: jtransformer.forward(
        p, wide, {"tokens": t}, group_size=B * S))
    loss = jax.jit(lambda p, t: jtransformer.loss_fn(
        p, jcfg, {"tokens": t, "labels": jnp.roll(t, -1, axis=1)},
        group_size=B * S))
    step = jax.jit(lambda p, s, t: jtransformer.decode_step(p, wide, s, t))
    state = jtransformer.init_decode(wide, B, S)
    outs = []
    for t in range(S):
        lg, state = step(jparams, state, jnp.asarray(tokens[:, t]))
        outs.append(np.asarray(lg))
    logits, aux = fwd(jparams, jnp.asarray(tokens))
    return dict(
        jcfg=jcfg, tcfg=tcfg, jparams=jparams,
        params=convert.transformer_params_from_numpy(jparams, "cpu"),
        ffn=convert.transformer_params_from_numpy(_numpy(jffn), "cpu"),
        tokens=tokens, x=x, layer=layer, dec=dec,
        logits=np.asarray(logits), aux=float(aux),
        loss=float(loss(jparams, jnp.asarray(tokens))),
        decode=np.stack(outs, axis=1), state=state)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return _case(request.param)


@pytest.mark.parametrize("factor", ["config", 0.25])
def test_layer_forward_and_aux_match_reference(case, factor):
    """The config's capacity (1.25) and the tight 0.25, in groups of 8
    tokens: at 0.25 each expert takes max(int(8 k 0.25 / E), k) = k slots,
    so (token, choice) pairs are dropped."""
    cf = case["jcfg"].capacity_factor if factor == "config" else factor
    cfg = dataclasses.replace(case["tcfg"], capacity_factor=cf)
    out, aux = moe.forward(case["ffn"], cfg, _t(case["x"]), group_size=8)
    want, want_aux = case["layer"][cf]
    _close(out, want)
    assert aux.dtype == torch.float32
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux))
    xg = _t(case["x"]).reshape(-1, 8, cfg.d_model)
    _, _, idx = moe.route(case["ffn"], cfg, xg)
    _, pos = moe.queue_positions(idx, cfg.num_experts)
    cap = moe._capacity(8, cfg.num_experts, cfg.experts_per_token, cf)
    if factor == 0.25:
        assert int((pos >= cap).sum()) > 0


def test_layer_decode_forward_matches_reference(case):
    out, aux = moe.decode_forward(case["ffn"], case["tcfg"],
                                  _t(case["x"][:, :1]))
    _close(out, case["dec"])
    assert float(aux) == 0.0


def test_slot_table_positions_follow_choice_rank_then_token_order():
    """Every (token, choice) of choice rank 0 queues before any of rank 1;
    within a rank, token order. Kept pairs hold distinct slots."""
    idx = torch.tensor([[[0, 1], [0, 2], [1, 0], [0, 1]]])      # (1, 4, 2)
    mask, pos = moe.queue_positions(idx, 3)
    assert pos[0].tolist() == [[0, 1], [1, 0], [0, 3], [2, 2]]
    assert mask.shape == (1, 4, 2, 3)
    assert torch.equal(mask.argmax(-1), idx)


def test_routing_ties_keep_the_lower_expert_first():
    """Two router columns equal: their probabilities tie exactly, and the
    lower expert id comes first, as ``jax.lax.top_k`` orders them; the
    layer then matches the reference's, whose capacity priority follows
    that order (a tight capacity, so the order decides the drops)."""
    jcfg = dataclasses.replace(jget_smoke_arch("mixtral-8x7b"),
                               capacity_factor=0.25)
    tcfg = dataclasses.replace(get_smoke_arch("mixtral-8x7b"),
                               capacity_factor=0.25)
    jffn = jmoe.init(jax.random.PRNGKey(3), jcfg)
    router = np.array(jffn["router"])
    router[:, 2] = router[:, 1]
    router[:, 3] = router[:, 1]
    jffn = dict(_numpy(jffn), router=router)
    x = np.random.default_rng(4).normal(
        size=(1, 8, jcfg.d_model)).astype(np.float32)
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ router), 2)
    ffn = convert.transformer_params_from_numpy(jffn, "cpu")
    _, _, idx = moe.route(ffn, tcfg, _t(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    # experts 1-3 tie: 1 is taken before 2, and 2 before 3
    first = idx[..., 0]
    assert (first == 1).any() and (first == 0).any()
    assert (idx[..., 1][first == 1] == 2).all()
    assert (idx[..., 1][first == 0] == 1).all()
    out, _ = moe.forward(ffn, tcfg, _t(x), group_size=8)
    want, _ = jax.jit(lambda p, x: jmoe.forward(p, jcfg, x, group_size=8))(
        jffn, jnp.asarray(x))
    _close(out, want)


def test_model_forward_and_loss_match_reference(case):
    tok = _t(case["tokens"])
    wide = dataclasses.replace(case["tcfg"], capacity_factor=8.0)
    logits, aux = transformer.forward(case["params"], wide, {"tokens": tok},
                                      group_size=B * S)
    _close(logits, case["logits"])
    assert float(aux) > 0.0
    assert abs(float(aux) - case["aux"]) <= 1e-5 * case["aux"]
    loss = transformer.loss_fn(case["params"], case["tcfg"],
                               {"tokens": tok,
                                "labels": torch.roll(tok, -1, dims=1)},
                               group_size=B * S)
    assert abs(float(loss) - case["loss"]) <= ATOL + RTOL * case["loss"]


def test_decode_16_tokens_matches_reference_and_prefill(case):
    wide = dataclasses.replace(case["tcfg"], capacity_factor=8.0)
    state = transformer.init_decode(wide, B, S, device="cpu")
    outs = []
    for t in range(S):
        lg, state = transformer.decode_step(case["params"], wide, state,
                                            _t(case["tokens"][:, t]))
        outs.append(lg)
    dec = torch.stack(outs, dim=1)
    _close(dec, case["decode"])
    _close(dec, case["logits"])
    crossed = convert.decode_state_from_numpy(case["state"], "cpu")
    for got, want in zip(state.states, crossed.states):
        _close(got, want)


def test_loss_and_every_gradient_leaf_match_jax():
    """Reduced mixtral, 2 x 16 tokens in one routing group at the config's
    capacity: the loss (cross entropy + router_aux_coef x aux) within 1e-5
    relative, every gradient leaf (router and experts included) within
    1e-5 of its max |value|."""
    case = _case("mixtral-8x7b")
    jcfg, tcfg = case["jcfg"], case["tcfg"]
    tok = case["tokens"]
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jtransformer.loss_fn(p, jcfg,
                                       jax.tree.map(jnp.asarray, batch),
                                       group_size=B * S)))(case["jparams"])
    params = convert.transformer_params_from_numpy(
        _numpy(case["jparams"]), "cpu")
    leaves = flatten.leaves_with_paths(params)
    for _, leaf in leaves:
        leaf.requires_grad_(True)
    loss = transformer.loss_fn(params, tcfg,
                               {k: torch.as_tensor(v) for k, v in
                                batch.items()}, group_size=B * S)
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    want = dict(flatten.leaves_with_paths(_numpy(grads_j)))
    assert set(want) == {path for path, _ in leaves}
    assert any("router" in path for path in want)
    for path, leaf in leaves:
        g = want[path]
        err = np.abs(leaf.grad.numpy() - g).max()
        assert err <= 1e-5 * np.abs(g).max(), (path, err)


def test_bf16_forward_matches_reference():
    """bf16 params and activations, the router in f32. The layer at the
    config's capacity on the same bf16 input; the model at capacity 8.0,
    where nothing is dropped: at 1.25 a route that bf16 rounding flips
    moves the queue positions of the later tokens of its group, so another
    token is dropped (a jump of 0.2-0.3 in its logits, the capacity
    bound's discontinuity, not a difference of the arithmetic)."""
    jcfg = dataclasses.replace(jget_smoke_arch("mixtral-8x7b"),
                               dtype="bfloat16")
    tcfg = dataclasses.replace(get_smoke_arch("mixtral-8x7b"),
                               dtype="bfloat16")
    jparams = jtransformer.init_params(jax.random.PRNGKey(2), jcfg)
    params = convert.transformer_params_from_numpy(jparams, "cpu")
    assert params["layers"]["ffn"]["w_gate"].dtype == torch.bfloat16
    assert params["layers"]["ffn"]["router"].dtype == torch.float32
    x = jnp.asarray(np.random.default_rng(5).normal(
        size=(B, S, jcfg.d_model)), jnp.bfloat16)
    jffn = jax.tree.map(lambda leaf: leaf[0], jparams["layers"]["ffn"])
    want, _ = jmoe.forward(jffn, jcfg, x, group_size=B * S)
    ffn = {name: v[0] for name, v in params["layers"]["ffn"].items()}
    got, _ = moe.forward(ffn, tcfg, _t(x), group_size=B * S)
    assert got.dtype == torch.bfloat16
    _close(got, want, 2e-2, 2e-2)
    got, _ = moe.decode_forward(ffn, tcfg, _t(x[:, :1]))
    _close(got, jmoe.decode_forward(jffn, jcfg, x[:, :1])[0], 2e-2, 2e-2)

    jwide = dataclasses.replace(jcfg, capacity_factor=8.0)
    twide = dataclasses.replace(tcfg, capacity_factor=8.0)
    tokens = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    want, _ = jax.jit(lambda p, t: jtransformer.forward(
        p, jwide, {"tokens": t}, group_size=B * S))(jparams,
                                                    jnp.asarray(tokens))
    got, _ = transformer.forward(params, twide, {"tokens": _t(tokens)},
                                 group_size=B * S)
    _close(got, want, 2e-2, 2e-2)
