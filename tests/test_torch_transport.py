"""The ring and gossip transports of the port against the JAX package's, on
the CPU (the port through its plain kernel versions):

* one exchange at a time: the ring's two shifts within 1e-5 (f32, bf16 with
  the reference's ``simulate_wire=True``, with fault payloads, batched);
  stale gossip reading a snapshot exactly s rounds old, dense and sparse,
  within rtol/atol 1e-6 of the reference and of the formula, its encoded
  snapshots equal to the reference's; ``staleness=0`` bit for bit the dense
  transport, in each package;
* ``wire_codec``/``wire_bytes`` and the registered names;
* ``build_trainer -> run_rounds`` over 3 rounds within 1e-5 from the same
  initial params and batch indices: the ring at K=6 (static and under the
  platoon, whose radio links the ring masks), dense gossip s=2, sparse
  gossip s=2 on the K=16 Manhattan fleet, gossip under a crash and corrupt
  plan; bf16 wires within 1e-4 over 2 rounds;
* in the port alone: 2 + 2 rounds equal 4 bit for bit, a resumed Session
  equals a straight one bit for bit (snapshots saved at bf16), a batched
  gossip run (V=2) equals its single runs, and the reference's refusals.

The JAX runs are shared through a module-scoped fixture."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import (FaultConfig, FedConfig, MobilityConfig,
                                TrainConfig)
from repro.configs.paper_models import MLP_CONFIG
from repro.core import flatten as jflat
from repro.core import topology as jtopo
from repro.core import transport as jtransport
from repro.core.cdfl import build_trainer
from repro.data import pipeline, redundancy, synthetic
from repro.models import simple
from repro_torch import convert
from repro_torch import experiment as texp
from repro_torch import registry
from repro_torch.configs import base as tbase
from repro_torch.configs.paper_models import MLP_CONFIG as T_MLP_CONFIG
from repro_torch.core import cdfl as tcdfl
from repro_torch.core import flatten as tflat
from repro_torch.core import topology as ttopo
from repro_torch.core import transport as ttransport
from repro_torch.models import simple as tsimple

S, B, N = 2, 8, 64
TOL = 1e-5
TOL_BF16 = 1e-4          # ROADMAP C: bf16 ulp drift, over 2 rounds
# benchmarks/paper_tables.py MOBILITY_SCENARIOS["manhattan"]
MANHATTAN = dict(kind="manhattan", speed=10.0, radio_range=500.0,
                 area=800.0, dt=2.0, seed=0)
PLATOON = dict(kind="platoon", speed=25.0, speed_jitter=0.4,
               radio_range=300.0, dt=5.0, seed=3)
FAULTS = dict(kinds=("crash", "corrupt"), crash_rate=0.3, recover_rate=0.5,
              corrupt_rate=0.3, seed=2)

# name -> (K, FedConfig keywords, rounds, tolerance)
CASES = {
    "ring": (6, dict(transport="ring"), 3, TOL),
    "ring-platoon": (6, dict(transport="ring", mobility=PLATOON), 3, TOL),
    "gossip-dense": (8, dict(transport="gossip", staleness=2), 3, TOL),
    "gossip-sparse-manhattan": (16, dict(
        transport="gossip", staleness=2, mixing_format="sparse", degree=5,
        mobility=MANHATTAN), 3, TOL),
    "gossip-crash-corrupt": (8, dict(transport="gossip", staleness=2,
                                     faults=FAULTS), 3, TOL),
    "ring-bf16": (6, dict(transport="ring", wire_dtype="bf16",
                          simulate_wire=True), 2, TOL_BF16),
    "gossip-bf16": (8, dict(transport="gossip", staleness=2,
                            wire_dtype="bf16", simulate_wire=True), 2,
                    TOL_BF16),
}
_DATA = {}


def _data(k):
    """tests/test_torch_faults.py's recipe: MNIST-like nodes with injected
    duplicates (ROADMAP C, Adam's eps region)."""
    if k not in _DATA:
        nodes = [redundancy.inject_duplicates(
            synthetic.synthetic_mnist(seed=i, n=N, noise=2.0),
            [0.1, 0.3, 0.5, 0.8][i % 4], seed=i) for i in range(k)]
        data = {"x": np.stack([d.x for d in nodes]),
                "y": np.stack([d.y for d in nodes])}
        items = pipeline.FederatedBatcher(nodes, B, S, seed=0).node_items()
        _DATA[k] = data, items
    return _DATA[k]


def _configs(k, kw):
    """The same FedConfig in both packages (sub-configs from dicts)."""
    kw = dict({"gamma": 0.5}, **kw, num_nodes=k, local_steps=S)
    jkw = dict(kw)
    tkw = {n: v for n, v in kw.items() if n != "simulate_wire"}
    for name, jcls, tcls in (
            ("mobility", MobilityConfig, tbase.MobilityConfig),
            ("faults", FaultConfig, tbase.FaultConfig)):
        if name in kw:
            jkw[name], tkw[name] = jcls(**kw[name]), tcls(**kw[name])
    return FedConfig(**jkw), tbase.FedConfig(**tkw)


def _jax_run(jfed, k, rounds):
    data, items = _data(k)
    train = TrainConfig(learning_rate=1e-3, batch_size=B)
    loss = simple.make_mlp_loss(MLP_CONFIG)
    tr = build_trainer(lambda p, b: loss(p, b), jfed, train)
    state = tr.init(jax.random.PRNGKey(0),
                    lambda r: simple.mlp_init(r, MLP_CONFIG),
                    jnp.asarray(items))
    init = {n: np.array(v) for n, v in state.params.items()}
    rng = jax.random.PRNGKey(train.seed + 1)
    keys = jax.vmap(lambda r: jax.random.fold_in(rng, r))(
        jnp.arange(rounds))
    idx = np.array(jax.vmap(lambda kk: jax.random.randint(
        kk, (k, S, B), 0, N))(keys))
    final, metrics = tr.run_rounds(
        state, {n: jnp.asarray(v) for n, v in data.items()}, rounds,
        rng=rng)
    return init, idx, final, {n: np.asarray(v) for n, v in metrics.items()}


@pytest.fixture(scope="module")
def reference_runs():
    """name -> (init params, (R, K, S, B) indices, final state, metrics)
    of the JAX package's trainer."""
    return {name: _jax_run(_configs(k, kw)[0], k, rounds)
            for name, (k, kw, rounds, _) in CASES.items()}


def _port_trainer(tfed, k, init):
    _, items = _data(k)
    train = tbase.TrainConfig(learning_rate=1e-3, batch_size=B)
    tr = tcdfl.build_trainer(tsimple.make_mlp_loss(T_MLP_CONFIG), tfed, train,
                             device="cpu")
    buf, layout = convert.params_from_numpy(init, "cpu")
    return tr, tr.init(tflat.unflatten(buf, layout), items, same_init=False)


def _init_params(k, seed=1):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal((k,) + tuple(v.shape)).astype(np.float32)
            * 0.1 for n, v in tsimple.mlp_init(
                torch.Generator().manual_seed(0), T_MLP_CONFIG,
                device="cpu").items()}


# --- one exchange at a time --------------------------------------------------

def _exchange_inputs(k, p=384, seed=0, kind="ring"):
    rng = np.random.default_rng(seed)
    buf = rng.standard_normal((k, p)).astype(np.float32)
    sent = buf + 0.01 * rng.standard_normal((k, p)).astype(np.float32)
    adj = jtopo.adjacency(kind, k)
    ratios = jnp.asarray(rng.uniform(0.2, 1.0, k), jnp.float32)
    eta = np.asarray(jtopo.mixing_weights(jnp.asarray(adj), "cnd",
                                          ratios=ratios))
    return buf, sent, eta


@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("faulted", [False, True])
def test_ring_exchange_matches_reference(wire, faulted):
    k = 6
    buf, sent, eta = _exchange_inputs(k)
    jt = jtransport.RingShardTransport(wire_dtype=wire, simulate_wire=True)
    tt = ttransport.RingShardTransport(wire_dtype=wire)
    js = jnp.asarray(sent) if faulted else None
    ts = torch.tensor(sent) if faulted else None
    want, _ = jt.exchange(jnp.asarray(buf), jnp.asarray(eta), 0.4, sent=js)
    got, state = tt.exchange(torch.tensor(buf), torch.tensor(eta), 0.4,
                             sent=ts)
    assert state == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    # the shifts read only the ring weights: dense B1 on the ring eta agrees
    if wire == "f32" and not faulted:
        dense, _ = ttransport.DenseTransport().exchange(
            torch.tensor(buf), torch.tensor(eta), 0.4)
        np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0,
                                   atol=TOL)


def test_ring_exchange_batched_rolls_each_variant():
    """A (V, K, P) buffer with per-variant (V, K, K) weights and gammas
    equals each variant's own exchange."""
    k, v = 5, 3
    rng = np.random.default_rng(4)
    bufs = torch.tensor(rng.standard_normal((v, k, 256)).astype(np.float32))
    etas = torch.stack([torch.tensor(_exchange_inputs(k, seed=s)[2])
                        for s in range(v)])
    gammas = torch.tensor([0.3, 0.5, 0.7])
    tt = ttransport.RingShardTransport()
    got, _ = tt.exchange(bufs, etas, gammas)
    for i in range(v):
        want, _ = tt.exchange(bufs[i], etas[i], gammas[i])
        np.testing.assert_allclose(got[i].numpy(), want.numpy(), rtol=0,
                                   atol=1e-6)


def _sparse(eta, degree):
    jsp = jtopo.sparsify_eta(jnp.asarray(eta), degree)
    return jsp, convert.sparse_eta_from_numpy(jsp, "cpu")


@pytest.mark.parametrize("fmt", ["dense", "sparse"])
@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_gossip_reads_a_snapshot_exactly_s_rounds_old(fmt, wire):
    k, s, g = 8, 2, 0.45
    rng = np.random.default_rng(1)
    bufs = [rng.standard_normal((k, 256)).astype(np.float32)
            for _ in range(6)]
    _, _, eta = _exchange_inputs(k, kind="erdos")
    jeta, teta = jnp.asarray(eta), torch.tensor(eta)
    if fmt == "sparse":
        jeta, teta = _sparse(eta, 3)
    jt = jtransport.GossipTransport(staleness=s, wire_dtype=wire,
                                    simulate_wire=True)
    tt = ttransport.GossipTransport(staleness=s, wire_dtype=wire)
    assert tt.stateful and jt.stateful
    jstate = jt.init_state(jnp.asarray(bufs[0]))
    tstate = tt.init_state(torch.tensor(bufs[0]))

    def cast(a):
        if wire == "f32":
            return a
        return np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                          .astype(jnp.float32))

    for r, buf in enumerate(bufs):
        want, jstate = jt.exchange(jnp.asarray(buf), jeta, g, jstate, r)
        got, tstate = tt.exchange(torch.tensor(buf), teta, g, tstate, r)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
        assert tstate.dtype == ttransport.wire_codec(wire).cast_dtype
        np.testing.assert_array_equal(
            tstate.to(torch.float32).numpy(),
            np.asarray(jstate).astype(np.float32))
        # the formula: neighbors at round max(r - s, 0), self at round r
        old = cast(bufs[max(r - s, 0)]).astype(np.float64)
        if fmt == "sparse":
            idx, val = teta.idx.numpy(), teta.val.numpy().astype(np.float64)
            mixed = (val[..., None] * old[idx]).sum(axis=1)
            row = val.sum(axis=1)
        else:
            mixed = eta.astype(np.float64) @ old
            row = eta.astype(np.float64).sum(axis=1)
        formula = buf + g * (mixed - row[:, None] * cast(buf))
        np.testing.assert_allclose(got.numpy(), formula, rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("fmt", ["dense", "sparse"])
@pytest.mark.parametrize("faulted", [False, True])
def test_gossip_staleness_zero_is_the_dense_transport_bit_for_bit(fmt,
                                                                  faulted):
    k = 8
    buf, sent, eta = _exchange_inputs(k, kind="erdos")
    jeta, teta = jnp.asarray(eta), torch.tensor(eta)
    if fmt == "sparse":
        jeta, teta = _sparse(eta, 3)
    ts = torch.tensor(sent) if faulted else None
    js = jnp.asarray(sent) if faulted else None
    tg = ttransport.GossipTransport(staleness=0)
    assert not tg.stateful and tg.init_state(torch.tensor(buf)) == ()
    got, _ = tg.exchange(torch.tensor(buf), teta, 0.5, (), 3, sent=ts)
    dense, _ = ttransport.DenseTransport().exchange(
        torch.tensor(buf), teta, 0.5, (), 3, sent=ts)
    assert torch.equal(got, dense)
    want, _ = jtransport.GossipTransport(staleness=0).exchange(
        jnp.asarray(buf), jeta, 0.5, (), 3, sent=js)
    jdense, _ = jtransport.DenseTransport().exchange(
        jnp.asarray(buf), jeta, 0.5, (), 3, sent=js)
    np.testing.assert_array_equal(np.asarray(want), np.asarray(jdense))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_wire_codecs_and_bytes_match_reference():
    buf = torch.tensor(np.random.default_rng(0).normal(size=(4, 256))
                       .astype(np.float32))
    jlayout = jflat.make_layout({"w": jnp.zeros((4, 16, 16))})
    tlayout = tflat.make_layout({"w": torch.zeros((4, 16, 16))})
    for name in ("f32", "bf16"):
        codec, jcodec = ttransport.wire_codec(name), \
            jtransport.wire_codec(name)
        assert codec.wire_bytes(tlayout) == jcodec.wire_bytes(jlayout)
        np.testing.assert_array_equal(
            codec.roundtrip(buf).numpy(),
            np.asarray(jcodec.roundtrip(jnp.asarray(buf.numpy()))))
        for t in (ttransport.DenseTransport(wire_dtype=name),
                  ttransport.RingShardTransport(wire_dtype=name),
                  ttransport.GossipTransport(staleness=1, wire_dtype=name)):
            assert t.wire_bytes(tlayout) == jcodec.wire_bytes(jlayout)
    assert ttransport.wire_codec("bf16").encode(buf).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="registered:"):
        ttransport.wire_codec("int3")
    assert sorted(ttransport.TRANSPORTS) == sorted(jtransport.TRANSPORTS)
    assert registry.NOT_PORTED == {}


# --- the trainer, against the reference --------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_trainer_matches_reference(reference_runs, case):
    k, kw, rounds, tol = CASES[case]
    _, tfed = _configs(k, kw)
    init, idx, final, metrics = reference_runs[case]
    tr, state = _port_trainer(tfed, k, init)
    data, _ = _data(k)
    tfinal, tmetrics = tr.run_rounds(state, data, rounds, idx=idx)
    ref = convert.state_from_numpy(final, "cpu")
    assert torch.isfinite(tfinal.buf).all()
    np.testing.assert_allclose(tfinal.buf.numpy(), ref.buf.numpy(),
                               atol=tol, rtol=0)
    np.testing.assert_allclose(tfinal.opt.m.numpy(), ref.opt.m.numpy(),
                               atol=tol, rtol=0)
    assert torch.equal(tfinal.opt.step, ref.opt.step)
    if kw.get("staleness"):
        # the snapshot ring: the last s rounds' payloads at the wire dtype
        assert tfinal.tstate.dtype == ref.tstate.dtype
        np.testing.assert_allclose(tfinal.tstate.float().numpy(),
                                   ref.tstate.float().numpy(), atol=tol,
                                   rtol=0)
    else:
        assert tfinal.tstate == () and ref.tstate == ()
    assert sorted(tmetrics) == sorted(metrics)
    for name in ("health", "quarantined", "frozen"):
        if name in metrics:
            np.testing.assert_array_equal(tmetrics[name].numpy(),
                                          metrics[name], err_msg=name)
    for name in ("loss", "disagreement", "gamma"):
        np.testing.assert_allclose(tmetrics[name].numpy(), metrics[name],
                                   rtol=1e-5, atol=1e-6 if tol == TOL
                                   else tol, err_msg=name)
    if "faults" in kw:
        assert metrics["quarantined"].sum() + (1 - metrics["health"]).sum() \
            > 0


def test_gossip_state_carries_across_from_the_reference(reference_runs):
    """The reference's snapshots after its 3 rounds come across through
    ``convert.state_from_numpy``; 1 more round of the port from there
    equals a 4th round of the reference."""
    k, kw, _, _ = CASES["gossip-dense"]
    jfed, tfed = _configs(k, kw)
    init, _, _, _ = reference_runs["gossip-dense"]
    data, items = _data(k)
    train = TrainConfig(learning_rate=1e-3, batch_size=B)
    loss = simple.make_mlp_loss(MLP_CONFIG)
    jtr = build_trainer(lambda p, b: loss(p, b), jfed, train)
    state = jtr.init(jax.random.PRNGKey(0),
                     lambda r: simple.mlp_init(r, MLP_CONFIG),
                     jnp.asarray(items))
    rng = jax.random.PRNGKey(5)
    jdata = {n: jnp.asarray(v) for n, v in data.items()}
    mid, _ = jtr.run_rounds(state, jdata, 3, rng=rng)
    tmid = convert.state_from_numpy(mid, "cpu")
    assert tuple(tmid.tstate.shape) == (2,) + tuple(tmid.buf.shape)
    final, _ = jtr.run_rounds(mid, jdata, 1, rng=rng)
    idx = np.array(jax.random.randint(jax.random.fold_in(rng, 3),
                                      (k, S, B), 0, N))[None]
    ttr, _ = _port_trainer(tfed, k, init)
    tfinal, _ = ttr.run_rounds(tmid, data, 1, idx=idx)
    want = convert.state_from_numpy(final, "cpu")
    np.testing.assert_allclose(tfinal.buf.numpy(), want.buf.numpy(),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(tfinal.tstate.numpy(), want.tstate.numpy(),
                               atol=TOL, rtol=0)


# --- port-only invariants ------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(transport="ring"),
    dict(transport="gossip", staleness=2, wire_dtype="bf16"),
    dict(transport="gossip", staleness=3, mixing_format="sparse", degree=3,
         mobility=MANHATTAN, faults=FAULTS),
], ids=["ring", "gossip-bf16", "gossip-sparse-faults"])
def test_two_plus_two_rounds_equal_four_bit_for_bit(kw):
    k = 8
    _, tfed = _configs(k, kw)
    init = _init_params(k)
    idx = np.random.default_rng(3).integers(0, N, size=(4, k, S, B))
    data, _ = _data(k)
    tr, state = _port_trainer(tfed, k, init)
    straight, m4 = tr.run_rounds(state, data, 4, idx=idx)
    half, m2 = tr.run_rounds(state, data, 2, idx=idx[:2])
    twice, m2b = tr.run_rounds(half, data, 2, idx=idx[2:])
    assert torch.equal(straight.buf, twice.buf)
    assert torch.equal(straight.opt.m, twice.opt.m)
    if kw.get("staleness"):
        assert torch.equal(straight.tstate, twice.tstate)
    assert torch.equal(m4["loss"], torch.cat([m2["loss"], m2b["loss"]]))
    # run_rounds leaves its input state as it was
    _, again = _port_trainer(tfed, k, init)
    assert torch.equal(state.buf, again.buf)
    if kw.get("staleness"):
        assert torch.equal(state.tstate, again.tstate)


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_resumed_gossip_session_equals_a_straight_one(tmp_path, wire):
    """run(3) + save + resume + run(3) == run(6) bit for bit; the bf16
    snapshots are stored as f32 and cast back exactly."""
    k = 6
    data, items = _data(k)
    fed = tbase.FedConfig(num_nodes=k, local_steps=S, transport="gossip",
                          staleness=2, wire_dtype=wire)
    exp = texp.Experiment.from_parts(
        tsimple.make_mlp_loss(T_MLP_CONFIG),
        lambda g: tsimple.mlp_init(g, T_MLP_CONFIG, device="cpu"), fed=fed,
        train=tbase.TrainConfig(learning_rate=1e-3, batch_size=B),
        device="cpu")
    straight = exp.compile(data, items).run(6)
    first = exp.compile(data, items)
    first.run(3)
    first.save(str(tmp_path / "ckpt"))
    resumed = exp.compile(data, items).resume(str(tmp_path / "ckpt"))
    assert resumed.state.tstate.dtype == ttransport.wire_codec(
        wire).cast_dtype
    assert torch.equal(resumed.state.tstate, first.state.tstate)
    second = resumed.run(3)
    assert torch.equal(second.state.buf, straight.state.buf)
    assert torch.equal(second.state.opt.v, straight.state.opt.v)
    assert torch.equal(second.state.tstate, straight.state.tstate)
    assert torch.equal(second.metrics["loss"],
                       straight.metrics["loss"][3:])


def _lin_loss(p, b):
    """tests/test_batch.py's linear loss, node-stacked: (K,) losses."""
    return ((torch.bmm(b["x"], p["w"]) - b["y"][..., None]) ** 2).mean(
        dim=(1, 2))


@pytest.mark.parametrize("kw", [
    dict(transport="gossip", staleness=2),
    dict(transport="gossip", staleness=2, mobility=dict(
        kind="platoon", speed_jitter=0.15, seed=0)),
    dict(transport="gossip", staleness=2, mobility=dict(
        kind="platoon", speed_jitter=0.15, seed=0),
        faults=dict(kinds=("crash",), crash_rate=0.25, seed=3)),
    dict(transport="gossip", staleness=1, mixing_format="sparse", degree=2),
    dict(transport="ring"),
], ids=["gossip", "gossip-platoon", "gossip-platoon-crash", "gossip-sparse",
        "ring"])
def test_batched_gossip_matches_its_single_runs(kw):
    """The gossip combinations of tests/test_batch.py (and the sparse
    gossip and the ring): V=2 variants of run_rounds_batch, snapshots
    (V, s, K, P), equal to their single runs within 1e-5."""
    k, n, rounds = 4, 24, 5
    rng = np.random.default_rng(7)
    data = {"x": rng.normal(size=(k, n, 6)).astype(np.float32),
            "y": rng.normal(size=(k, n)).astype(np.float32)}
    items = rng.integers(0, 40, (k, n, 4)).astype(np.int32)
    _, tfed = _configs(k, kw)
    tr = tcdfl.build_trainer(_lin_loss, tfed, tbase.TrainConfig(
        learning_rate=0.05, batch_size=4), device="cpu")
    seeds = [3, 9]
    inits = [tr.init({"w": torch.randn(
        (6, 1), generator=torch.Generator().manual_seed(s)) * 0.1}, items)
        for s in seeds]
    singles = [tr.run_rounds(st, data, rounds,
                             generator=torch.Generator().manual_seed(s + 1))
               for st, s in zip(inits, seeds)]
    stacked = tcdfl.stack_states(inits)
    final, metrics = tr.run_rounds_batch(stacked, data, rounds,
                                         rngs=[s + 1 for s in seeds])
    for i, (fs, m) in enumerate(singles):
        torch.testing.assert_close(final.buf[i], fs.buf, rtol=0, atol=TOL)
        torch.testing.assert_close(final.opt.m[i], fs.opt.m, rtol=0,
                                   atol=TOL)
        torch.testing.assert_close(metrics["loss"][i], m["loss"], rtol=0,
                                   atol=TOL)
        if kw.get("staleness"):
            torch.testing.assert_close(final.tstate[i], fs.tstate, rtol=0,
                                       atol=TOL)
            assert torch.equal(tcdfl.select_state(final, i).tstate,
                               final.tstate[i])


@pytest.mark.parametrize("kw", [
    dict(transport="ring", num_nodes=2),
    dict(transport="ring", topology="full"),
    dict(transport="ring", robust="median"),
    dict(transport="gossip", staleness=1, robust="trimmed_mean"),
    dict(transport="gossip", mixing_format="hierarchical"),
    dict(transport="ring", mixing_format="sparse", num_nodes=8, degree=2),
    dict(transport="gossip", algorithm="dpsgd"),
])
def test_refusals_raise_the_reference_exception(kw):
    kw = dict({"num_nodes": 4}, **kw)
    loss = simple.make_mlp_loss(MLP_CONFIG)
    tloss = tsimple.make_mlp_loss(T_MLP_CONFIG)
    with pytest.raises(Exception) as want:
        build_trainer(loss, FedConfig(**kw), TrainConfig())
    with pytest.raises(Exception) as got:
        tcdfl.build_trainer(tloss, tbase.FedConfig(**kw),
                            tbase.TrainConfig(), device="cpu")
    assert got.type is want.type, (got.value, want.value)


def test_ring_refuses_sparse_weights_and_two_nodes():
    tt = ttransport.RingShardTransport()
    buf = torch.zeros((4, 128))
    with pytest.raises(ValueError, match="degree-2"):
        tt.exchange(buf, ttopo.SparseEta(torch.zeros((4, 1), dtype=torch.int32),
                                         torch.zeros((4, 1))), 0.5)
    with pytest.raises(ValueError, match="K >= 3"):
        tt.exchange(torch.zeros((2, 128)), torch.zeros((2, 2)), 0.5)
    with pytest.raises(ValueError, match="round index"):
        ttransport.GossipTransport(staleness=1).exchange(
            buf, torch.zeros((4, 4)), 0.5, torch.zeros((1, 4, 128)))
