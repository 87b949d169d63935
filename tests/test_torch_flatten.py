"""The port's flat buffer and dense transport against the JAX package, on the
same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_models import MLP_CONFIG
from repro.core import flatten as jflat
from repro.core import transport as jtransport
from repro.models import simple
from repro_torch.core import flatten as tflat
from repro_torch.core import transport as ttransport


def _mlp_params(k, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), k)
    p = jax.vmap(lambda r: simple.mlp_init(r, MLP_CONFIG))(keys)
    return {n: np.array(v) for n, v in p.items()}


def _eta(rng, k):
    eta = rng.random((k, k)).astype(np.float32)
    np.fill_diagonal(eta, 0.0)
    return eta / eta.sum(axis=1, keepdims=True)


def test_layout_order_and_padding_match_reference():
    p = _mlp_params(4, 0)
    jbuf, jl = jflat.flatten({n: jnp.asarray(v) for n, v in p.items()})
    tbuf, tl = tflat.flatten({n: torch.tensor(v) for n, v in p.items()})
    assert tl.names == ("b1", "b2", "w1", "w2")
    assert (tl.total, tl.padded) == (jl.total, jl.padded) == (23_860, 23_936)
    assert tl.offsets == jl.offsets and tl.sizes == jl.sizes
    assert tl.shapes == jl.shapes
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    assert not tbuf[:, tl.total:].any()


def test_unflatten_returns_exact_views():
    p = _mlp_params(3, 1)
    buf, layout = tflat.flatten({n: torch.tensor(v) for n, v in p.items()})
    views = tflat.unflatten(buf, layout)
    for name, leaf in views.items():
        np.testing.assert_array_equal(leaf.numpy(), p[name])
        assert leaf.untyped_storage().data_ptr() == \
            buf.untyped_storage().data_ptr()
    views["b2"].fill_(7.0)                       # writes through
    off = layout.offsets[layout.names.index("b2")]
    assert (buf[:, off:off + 10] == 7.0).all()


def test_unflatten_restores_dtypes():
    p = {"a": torch.arange(12, dtype=torch.bfloat16).reshape(2, 6),
         "b": torch.ones((2, 3), dtype=torch.float32)}
    buf, layout = tflat.flatten(p)
    out = tflat.unflatten(buf, layout)
    assert out["a"].dtype == torch.bfloat16 and torch.equal(out["a"], p["a"])
    assert torch.equal(out["b"], p["b"])


@pytest.mark.parametrize("fraction", [0.1, 0.25, 0.5, 0.75, 1.0])
def test_prefix_length_matches_reference(fraction):
    p = _mlp_params(2, 2)
    _, jl = jflat.flatten({n: jnp.asarray(v) for n, v in p.items()})
    _, tl = tflat.flatten({n: torch.tensor(v) for n, v in p.items()})
    assert tflat.prefix_length(tl, fraction) == \
        jflat.prefix_length(jl, fraction)


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("self_weight", [1.0, 0.5])
def test_mix_flat_matches_reference(k, wire, self_weight):
    rng = np.random.default_rng(k)
    buf = rng.normal(size=(k, 640)).astype(np.float32)
    eta = _eta(rng, k)
    jb, tb = jnp.asarray(buf), torch.tensor(buf)
    jw = tw = None
    if wire == "bf16":
        jw, tw = jb.astype(jnp.bfloat16), tb.to(torch.bfloat16)
    want = jflat.mix_flat(jb, jnp.asarray(eta), 0.4, self_weight=self_weight,
                          wire=jw)
    got = tflat.mix_flat(tb, torch.tensor(eta), 0.4, self_weight=self_weight,
                         wire=tw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("k", [4, 8])
def test_apply_matrix_flat_matches_reference(k):
    rng = np.random.default_rng(10 + k)
    buf = rng.normal(size=(k, 384)).astype(np.float32)
    a = _eta(rng, k)
    want = jflat.apply_matrix_flat(jnp.asarray(buf), jnp.asarray(a))
    got = tflat.apply_matrix_flat(torch.tensor(buf), torch.tensor(a))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_disagreement_divides_by_unpadded_total():
    p = _mlp_params(4, 3)
    jbuf, jl = jflat.flatten({n: jnp.asarray(v) for n, v in p.items()})
    tbuf, tl = tflat.flatten({n: torch.tensor(v) for n, v in p.items()})
    want = jflat.disagreement_flat(jbuf, jl.total)
    got = tflat.disagreement_flat(tbuf, tl.total)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("with_sent", [False, True])
def test_dense_transport_matches_reference(wire, with_sent):
    rng = np.random.default_rng(5)
    k = 6
    buf = rng.normal(size=(k, 256)).astype(np.float32)
    sent = (buf + rng.normal(scale=0.1, size=buf.shape)).astype(np.float32)
    eta = _eta(rng, k)
    jt = jtransport.DenseTransport(wire_dtype=wire, simulate_wire=True)
    tt = ttransport.DenseTransport(wire_dtype=wire)
    want, _ = jt.exchange(jnp.asarray(buf), jnp.asarray(eta), 0.3,
                          sent=jnp.asarray(sent) if with_sent else None)
    got, _ = tt.exchange(torch.tensor(buf), torch.tensor(eta), 0.3,
                         sent=torch.tensor(sent) if with_sent else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)

