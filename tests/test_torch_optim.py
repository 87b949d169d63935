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
from repro_torch.optim import adam as tadam


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
