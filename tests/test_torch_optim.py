"""The port's flat Adam (paper eq. 8) against the JAX package's
``flat_adam``: 20 steps on the same numpy gradients, params and moments
at 1e-6. The JAX side vmaps over nodes, as its trainer does, so gradient
clipping is per node on both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import flat_adam as jflat_adam
from repro_torch import optim as tadam


@pytest.mark.parametrize("kw", [
    {},
    {"grad_clip": 0.5},
    {"weight_decay": 0.01},
    {"b1": 0.8, "b2": 0.99, "eps": 1e-6, "grad_clip": 2.0},
], ids=["paper", "clip", "decay", "betas"])
def test_flat_adam_matches_reference(kw):
    rng = np.random.default_rng(len(kw))
    k, p = 4, 384
    buf = rng.normal(size=(k, p)).astype(np.float32)
    jopt = jflat_adam(1e-3, **kw)
    topt = tadam.flat_adam(1e-3, **kw)
    jbuf, tbuf = jnp.asarray(buf), torch.tensor(buf)
    jst, tst = jopt.init(jbuf), topt.init(tbuf)
    jupd = jax.vmap(jopt.update)
    for _ in range(20):
        g = rng.normal(scale=0.3, size=(k, p)).astype(np.float32)
        g[:, -16:] = 0.0                  # zero-gradient padding columns
        jbuf, jst = jupd(jnp.asarray(g), jst, jbuf)
        tbuf, tst = topt.update(torch.tensor(g), tst, tbuf)
    np.testing.assert_array_equal(tst.step.numpy(), np.asarray(jst.step))
    for got, want in ((tbuf, jbuf), (tst.m, jst.m), (tst.v, jst.v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)
    if not kw.get("weight_decay"):        # no gradient, no decay: untouched
        np.testing.assert_array_equal(tbuf[:, -16:].numpy(), buf[:, -16:])


def test_flat_adam_is_not_torch_adam():
    """eps outside the square root and one folded bias correction: the
    first step moves every coordinate by lr * sqrt(1-b2)/(1-b1) *
    g / (|g| * sqrt(1-b2) + eps), which torch.optim.Adam does not."""
    g = torch.tensor([[1e-6, 1.0]])
    opt = tadam.flat_adam(1e-3)
    out, _ = opt.update(g, opt.init(torch.zeros_like(g)), torch.zeros_like(g))
    corr = np.sqrt(1 - 0.999) / (1 - 0.9)
    want = -1e-3 * corr * 0.1 * g.numpy() / (
        np.sqrt(0.001) * np.abs(g.numpy()) + 1e-7)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5)
    p = torch.zeros_like(g, requires_grad=True)
    ref = torch.optim.Adam([p], lr=1e-3, eps=1e-7)
    p.grad = g.clone()
    ref.step()
    assert not np.allclose(p.detach().numpy(), want, rtol=1e-3)


# --- the pytree optimizers and the schedules (launch/steps.py's Adam) -------

from repro.optim import adam as jadam                       # noqa: E402
from repro.optim import global_norm as jglobal_norm         # noqa: E402
from repro.optim import schedules as jschedules             # noqa: E402
from repro.optim import sgd as jsgd                         # noqa: E402
from repro_torch.optim import schedules as tschedules       # noqa: E402


def _trees(rng, dtype=np.float32):
    """A params tree of dicts and lists, and gradients like it."""
    def tree():
        return {"w": rng.normal(size=(4, 9, 3)).astype(dtype),
                "b": [rng.normal(size=(5,)).astype(dtype),
                      rng.normal(scale=3.0, size=(2, 2)).astype(dtype)]}
    return tree(), [tree() for _ in range(6)]


def _j(tree, dtype=None):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), tree)


def _t(tree, dtype=None):
    if isinstance(tree, dict):
        return {k: _t(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_t(v, dtype) for v in tree]
    return torch.tensor(np.asarray(tree, np.float32)).to(
        dtype or torch.float32)


def _close(got, want, atol):
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for k in got:
            _close(got[k], want[k], atol)
    elif isinstance(got, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, atol)
    else:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=atol,
                                   rtol=0)


@pytest.mark.parametrize("kw", [
    {},
    {"grad_clip": 1.0},
    {"weight_decay": 0.01},
    {"b1": 0.8, "b2": 0.99, "eps": 1e-6, "grad_clip": 50.0},
], ids=["paper", "clip", "decay", "betas"])
@pytest.mark.parametrize("inplace", [False, True], ids=["new", "inplace"])
def test_pytree_adam_matches_reference(kw, inplace):
    """Six steps on the same params and gradients: params, moments and the
    step within 1e-6 (clip 1.0 is below every gradient's norm, 50.0 above
    some); ``inplace`` writes the same numbers into the given tensors."""
    p0, grads = _trees(np.random.default_rng(len(kw)))
    jopt, topt = jadam(1e-2, **kw), tadam.adam(1e-2, **kw)
    jp, tp = _j(p0), _t(p0)
    jst, tst = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, jst = jopt.update(_j(g), jst, jp)
        new, tst2 = topt.update(_t(g), tst, tp, inplace=inplace)
        if inplace:
            assert new["w"] is tp["w"] and tst2.m["w"] is tst.m["w"]
        tp, tst = new, tst2
    assert tst.step.dtype == torch.int32 and int(tst.step) == int(jst.step)
    for got, want in ((tp, jp), (tst.m, jst.m), (tst.v, jst.v)):
        _close(got, want, 1e-6)


def test_pytree_adam_clip_and_callable_rate():
    """The clipped update stays under lr * corr, as tests/test_optim.py
    checks for the reference, and a callable rate is read at the new
    step."""
    opt = tadam.adam(lambda t: 1e-2 * t.float(), grad_clip=1.0)
    p = {"w": torch.zeros(4)}
    st = opt.init(p)
    p2, st = opt.update({"w": torch.full((4,), 100.0)}, st, p)
    assert torch.isfinite(p2["w"]).all() and p2["w"].abs().max() < 0.1
    p3, _ = opt.update({"w": torch.full((4,), 100.0)}, st, p2)
    jopt = jadam(lambda t: 1e-2 * t.astype(jnp.float32), grad_clip=1.0)
    jp = {"w": jnp.zeros(4)}
    jst = jopt.init(jp)
    for _ in range(2):
        jp, jst = jopt.update({"w": jnp.full((4,), 100.0)}, jst, jp)
    np.testing.assert_allclose(p3["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6)


def test_pytree_adam_bf16_params_keep_dtype():
    p0, grads = _trees(np.random.default_rng(7))
    opt, jopt = tadam.adam(1e-3), jadam(1e-3)
    tp, jp = _t(p0, torch.bfloat16), _j(p0, jnp.bfloat16)
    st, jst = opt.init(tp), jopt.init(jp)
    assert st.m["w"].dtype == torch.float32
    for g in grads[:3]:
        tp, st = opt.update(_t(g, torch.bfloat16), st, tp)
        jp, jst = jopt.update(_j(g, jnp.bfloat16), jst, jp)
    assert tp["w"].dtype == torch.bfloat16 and st.m["w"].dtype == torch.float32
    _close(st.m, jst.m, 1e-6)
    _close(tp, jp, 0.0)             # the same f32 update, rounded once


def test_sgd_momentum_matches_reference():
    opt = tadam.sgd(0.1, momentum=0.9)
    p = {"w": torch.tensor([1.0])}
    st = opt.init(p)
    g = {"w": torch.tensor([1.0])}
    p, st = opt.update(g, st, p)
    np.testing.assert_allclose(p["w"].numpy(), [0.9], rtol=1e-6)
    p, st = opt.update(g, st, p)
    np.testing.assert_allclose(p["w"].numpy(), [0.9 - 0.19], rtol=1e-5)
    assert int(st.step) == 2
    p0, grads = _trees(np.random.default_rng(3))
    jopt = jsgd(jschedules.linear_decay(0.05, 2, 5), momentum=0.5)
    topt = tadam.sgd(tschedules.linear_decay(0.05, 2, 5), momentum=0.5)
    jp, tp = _j(p0), _t(p0)
    jst, tst = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, jst = jopt.update(_j(g), jst, jp)
        tp, tst = topt.update(_t(g), tst, tp)
    _close(tp, jp, 1e-6)
    _close(tst.m, jst.m, 1e-6)


def test_global_norm_matches_reference():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert float(tadam.global_norm(t)) == 5.0
    _, grads = _trees(np.random.default_rng(5))
    got = tadam.global_norm(_t(grads[0], torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.item(), float(jglobal_norm(_j(grads[0], jnp.bfloat16))),
        rtol=1e-6)


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)),
    ("cosine", (1e-3, 10, 100)),
    ("cosine", (1e-3, 0, 50, 1e-5)),
    ("linear_decay", (2e-3, 5, 40)),
    ("linear_decay", (2e-3, 0, 1)),
])
def test_schedules_match_reference(name, args):
    """Every step from 0 to total + 5, as an (n,) step vector and one at a
    time: f32 tensors within 1e-6 of the peak rate from the reference's
    values (the two packages' f32 cosines differ by an ulp or two)."""
    total = args[2] if len(args) > 2 else 10
    steps = np.arange(total + 6, dtype=np.int32)
    fn, jfn = getattr(tschedules, name)(*args), getattr(jschedules,
                                                         name)(*args)
    want = np.broadcast_to(np.asarray(jfn(jnp.asarray(steps))), steps.shape)
    got = fn(torch.tensor(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(np.broadcast_to(got.numpy(), steps.shape), want,
                               rtol=0, atol=1e-6 * args[0])
    for s in (0, 1, total, total + 5):
        one = fn(torch.tensor(s, dtype=torch.int32))
        assert one.dtype == torch.float32 and one.dim() == 0
        np.testing.assert_allclose(one.item(), want[s], rtol=0,
                                   atol=1e-6 * args[0])
