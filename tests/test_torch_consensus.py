"""Kernel B8 ``consensus_mix``, ``ops.consensus_mix_pytree`` and
``repro_torch.core.consensus`` against the JAX package, on the CPU.

B8's plain version is held against the Pallas kernel in interpret mode
and against ``repro.kernels.ref.consensus_mix`` over the sweep of
tests/test_kernels.py::test_consensus_mix_sweep, at that test's
tolerances (1e-5 f32, 3e-2 bf16). The consensus one-shots are held
against both of the reference's forms of ``consensus_step`` (the
per-leaf precomposed operator and the flat delta form) and against its
``partial_consensus_step``, ``disagreement``, ``apply_matrix`` and
``simulate_rounds`` within 1e-6. The CUDA kernel itself runs only on
the card (``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import consensus as jcons
from repro.core import topology as jtopo
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.consensus_mix import consensus_mix as pallas_consensus_mix
from repro_torch.core import consensus as tcons
from repro_torch.core import flatten as tflat
from repro_torch.core import topology as ttopo
from repro_torch.kernels import consensus_mix as tcm
from repro_torch.kernels import ops, ref

_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_kernels.py::test_consensus_mix_sweep: rows, N, dtype
SWEEP = [(256, 2, "f32"), (512, 4, "f32"), (256, 2, "bf16"),
         (1024, 8, "f32")]
TOL = 1e-6               # one-shot consensus: a few f32 roundings


def _tol(dtype):
    return 3e-2 if dtype == "bf16" else 1e-5


def _mix_inputs(rows, n, seed, lane=128):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(rows, lane)).astype(np.float32)
    nb = rng.normal(size=(n, rows, lane)).astype(np.float32)
    e = np.exp(rng.normal(size=n))
    return w, nb, (e / e.sum()).astype(np.float32)


@pytest.mark.parametrize("rows,n,dtype", SWEEP)
def test_ref_consensus_mix_matches_pallas_and_reference(rows, n, dtype):
    w, nb, eta = _mix_inputs(rows, n, rows + n)
    jdt, tdt = _DT[dtype]
    jw, jnb = jnp.asarray(w).astype(jdt), jnp.asarray(nb).astype(jdt)
    pallas = pallas_consensus_mix(jw, jnb, jnp.asarray(eta), 0.4,
                                  block_rows=128, interpret=True)
    oracle = jref.consensus_mix(jw, jnb, jnp.asarray(eta), 0.4)
    got = ref.consensus_mix(torch.tensor(w).to(tdt),
                            torch.tensor(nb).to(tdt), torch.tensor(eta), 0.4)
    assert got.dtype == tdt and tuple(got.shape) == (rows, 128)
    tol = _tol(dtype)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("rows,n,lane", [(187, 2, 128), (5, 3, 7)])
def test_ref_consensus_mix_takes_any_rows(rows, n, lane):
    """The port drops the TPU tile assert (rows % block_rows): the paper
    MLP's buffer is 187 rows of 128. Held against the reference oracle
    and a numpy loop."""
    w, nb, eta = _mix_inputs(rows, n, 3, lane)
    got = ops.consensus_mix(torch.tensor(w), torch.tensor(nb),
                            torch.tensor(eta), 0.7).numpy()
    want = w.copy()
    for i in range(n):
        want += 0.7 * eta[i] * (nb[i] - w)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    oracle = jref.consensus_mix(jnp.asarray(w), jnp.asarray(nb),
                                jnp.asarray(eta), 0.7)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=1e-6,
                               rtol=1e-6)


def test_ops_consensus_mix_cpu_takes_the_plain_version():
    w, nb, eta = _mix_inputs(16, 2, 4)
    before = tcm.consensus_mix.launches
    tw, tnb, te = torch.tensor(w), torch.tensor(nb), torch.tensor(eta)
    assert torch.equal(ops.consensus_mix(tw, tnb, te, 0.5),
                       ref.consensus_mix(tw, tnb, te, 0.5))
    assert tcm.consensus_mix.launches == before


def test_consensus_mix_wrapper_refuses_cpu_tensors():
    w = torch.zeros((4, 128))
    nb = torch.zeros((2, 4, 128))
    eta, g = torch.full((2,), 0.5), torch.ones(1)
    before = tcm.consensus_mix.launches
    with pytest.raises(ValueError, match="CUDA kernel"):
        tcm.consensus_mix(w, nb, eta, g)
    meta = torch.empty((4, 128), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.consensus_mix(meta, torch.empty((2, 4, 128), device="meta"),
                          eta, 0.5)
    assert tcm.consensus_mix.launches == before


@pytest.mark.parametrize("bad,msg", [
    ("w3d", "w must be"), ("nb_shape", "neighbors"), ("eta_len", "eta"),
    ("gamma2", "gamma must"), ("eta_f64", "float32"), ("f16", "not supported"),
    ("mixed", "neighbors dtype"),
])
def test_consensus_mix_wrapper_checks_before_launch(bad, msg, monkeypatch):
    """The checks run before any launch: with the device check passed,
    every malformed call raises on its shape or dtype."""
    monkeypatch.setattr(tcm, "_check_cuda", lambda *t: t[0].device)
    w = torch.zeros((4, 128))
    nb = torch.zeros((2, 4, 128))
    eta, g = torch.full((2,), 0.5), torch.ones(1)
    args = dict(w=w, neighbors=nb, eta=eta, gamma=g)
    if bad == "w3d":
        args["w"] = torch.zeros((1, 4, 128))
    elif bad == "nb_shape":
        args["neighbors"] = torch.zeros((2, 5, 128))
    elif bad == "eta_len":
        args["eta"] = torch.full((3,), 0.5)
    elif bad == "gamma2":
        args["gamma"] = torch.ones(2)
    elif bad == "eta_f64":
        args["eta"] = eta.double()
    elif bad == "f16":
        args["w"], args["neighbors"] = w.half(), nb.half()
    elif bad == "mixed":
        args["neighbors"] = nb.to(torch.bfloat16)
    before = tcm.consensus_mix.launches
    with pytest.raises(ValueError, match=msg):
        tcm.consensus_mix(**args)
    assert tcm.consensus_mix.launches == before


# -- ops.consensus_mix_pytree ---------------------------------------------

def test_consensus_mix_pytree_reference_case():
    """tests/test_kernels.py::test_consensus_mix_pytree_wrapper's case."""
    w = {"a": torch.ones((33, 5)), "b": torch.arange(100.0)}
    nb = {"a": torch.zeros((3, 33, 5)),
          "b": torch.stack([torch.arange(100.0)] * 3)}
    out = ops.consensus_mix_pytree(w, nb, torch.tensor([0.5, 0.25, 0.25]),
                                   1.0)
    np.testing.assert_allclose(out["a"].numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(out["b"].numpy(), np.arange(100.0),
                               atol=1e-6)


@pytest.mark.parametrize("nb_dtype", ["f32", "bf16"])
def test_consensus_mix_pytree_matches_reference(nb_dtype):
    rng = np.random.default_rng(11)
    w = {"w1": rng.normal(size=(23, 7)).astype(np.float32),
         "b1": rng.normal(size=(7,)).astype(np.float32),
         "z": rng.normal(size=(3, 2, 5)).astype(np.float32)}
    nb = {n: rng.normal(size=(3,) + v.shape).astype(np.float32)
          for n, v in w.items()}
    eta = np.asarray([0.2, 0.5, 0.3], np.float32)
    jdt, tdt = _DT[nb_dtype]
    want = jops.consensus_mix_pytree(
        {n: jnp.asarray(v) for n, v in w.items()},
        {n: jnp.asarray(v).astype(jdt) for n, v in nb.items()},
        jnp.asarray(eta), 0.6)
    got = ops.consensus_mix_pytree(
        {n: torch.tensor(v) for n, v in w.items()},
        {n: torch.tensor(v).to(tdt) for n, v in nb.items()},
        torch.tensor(eta), 0.6)
    assert sorted(got) == sorted(want)
    for name in w:
        assert got[name].dtype == torch.float32
        assert tuple(got[name].shape) == w[name].shape
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=TOL, rtol=TOL, err_msg=name)


def test_consensus_mix_pytree_keeps_each_leaf_dtype():
    w = {"a": torch.ones((4, 3), dtype=torch.bfloat16),
         "b": torch.ones(5)}
    nb = {"a": torch.zeros((2, 4, 3), dtype=torch.bfloat16),
          "b": torch.zeros((2, 5))}
    out = ops.consensus_mix_pytree(w, nb, torch.tensor([0.25, 0.25]), 1.0)
    assert out["a"].dtype == torch.bfloat16 and out["b"].dtype == \
        torch.float32
    np.testing.assert_allclose(out["a"].float().numpy(), 0.5)
    np.testing.assert_allclose(out["b"].numpy(), 0.5)


# -- core/consensus.py ----------------------------------------------------

def _params(k, seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(k, 8, 3)).astype(np.float32),
            "b": rng.normal(size=(k, 5)).astype(np.float32),
            "c": rng.normal(size=(k, 130)).astype(np.float32)}


def _eta(k, kind, seed):
    adj = jtopo.adjacency(kind, k)
    ratios = np.random.default_rng(seed).uniform(0.2, 1.0, size=k)
    return np.asarray(jtopo.cnd_mixing(jnp.asarray(adj),
                                       jnp.asarray(ratios, jnp.float32)))


def _close(got: dict, want, tol=TOL):
    assert sorted(got) == sorted(want)
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("k,kind,sw", [(4, "ring", 1.0), (6, "full", 0.7),
                                       (8, "erdos", 1.3)])
@pytest.mark.parametrize("use_flat", [False, True])
def test_consensus_step_matches_both_reference_forms(k, kind, sw, use_flat):
    params = _params(k, k)
    eta = _eta(k, kind, k)
    want = jcons.consensus_step({n: jnp.asarray(v) for n, v in
                                 params.items()}, jnp.asarray(eta), 0.4,
                                self_weight=sw, use_flat=use_flat)
    got = tcons.consensus_step({n: torch.tensor(v) for n, v in
                                params.items()}, torch.tensor(eta), 0.4,
                               self_weight=sw)
    _close(got, want)


@pytest.mark.parametrize("fraction", [0.25, 0.5, 1.0])
@pytest.mark.parametrize("sparse", [False, True])
def test_partial_consensus_step_matches_reference(fraction, sparse):
    k = 6
    params = _params(k, 21)
    eta = _eta(k, "full", 3)
    jeta, teta = jnp.asarray(eta), torch.tensor(eta)
    if sparse:
        jeta = jtopo.sparsify_eta(jeta, 3)
        teta = ttopo.sparsify_eta(teta, 3)
    want = jcons.partial_consensus_step(
        {n: jnp.asarray(v) for n, v in params.items()}, jeta, 0.3, fraction)
    got = tcons.partial_consensus_step(
        {n: torch.tensor(v) for n, v in params.items()}, teta, 0.3, fraction)
    _close(got, want)
    # the leaves past the prefix pass through untouched
    layout = tflat.make_layout({n: torch.tensor(v)
                                for n, v in params.items()})
    n_mix = max(1, round(fraction * len(layout.names)))
    for name in layout.names[n_mix:]:
        np.testing.assert_array_equal(got[name].numpy(), params[name])


def test_partial_mix_flat_on_an_unaligned_prefix():
    """The paper MLP's prefixes (30, 40, 23,560) are not lane-aligned: the
    copied prefix goes through the mix, the tail stays bit for bit."""
    rng = np.random.default_rng(2)
    buf = torch.tensor(rng.normal(size=(4, 256)).astype(np.float32))
    eta = torch.tensor(_eta(4, "ring", 5))
    for prefix in (30, 40, 200):
        out = tflat.partial_mix_flat(buf, eta, 0.5, prefix)
        np.testing.assert_allclose(
            out[:, :prefix].numpy(),
            tflat.mix_flat(buf[:, :prefix].contiguous(), eta, 0.5).numpy(),
            atol=0, rtol=0)
        assert torch.equal(out[:, prefix:], buf[:, prefix:])


def test_disagreement_and_apply_matrix_match_reference():
    k = 5
    params = _params(k, 8)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    tp = {n: torch.tensor(v) for n, v in params.items()}
    np.testing.assert_allclose(float(tcons.disagreement(tp)),
                               float(jcons.disagreement(jp)), rtol=1e-6)
    a = np.asarray(jtopo.consensus_matrix(jnp.asarray(_eta(k, "full", 1)),
                                          0.5))
    _close(tcons.apply_matrix(tp, torch.tensor(a)),
           jcons.apply_matrix(jp, jnp.asarray(a)))


@pytest.mark.parametrize("rounds", [1, 7])
def test_simulate_rounds_matches_reference(rounds):
    k = 6
    params = _params(k, 13)
    eta = _eta(k, "ring", 2)
    jp, jds = jcons.simulate_rounds({n: jnp.asarray(v) for n, v in
                                     params.items()}, jnp.asarray(eta), 0.5,
                                    rounds)
    tp, tds = tcons.simulate_rounds({n: torch.tensor(v) for n, v in
                                     params.items()}, torch.tensor(eta), 0.5,
                                    rounds)
    _close(tp, jp)
    assert tuple(tds.shape) == (rounds,)
    np.testing.assert_allclose(tds.numpy(), np.asarray(jds), rtol=1e-5,
                               atol=TOL)
    if rounds > 1:
        assert tds[-1] < tds[0]
