"""The port's abstract step inputs and its roofline against the JAX
package's, with nothing allocated:

* ``launch/steps.py``'s ``fed_state_struct``, ``serve_params_struct``,
  ``input_specs`` and ``decode_state_struct`` give meta tensors whose key
  paths, shapes and dtypes equal those of the reference's
  ``ShapeDtypeStruct``s (``jax.eval_shape``) for every arch in ``ARCHS``
  at full size and every input shape of ``INPUT_SHAPES`` (F=4 nodes for
  training; the decode states also with a 4,096-token window), and draw
  no number from the host generator;
* ``launch/roofline.py``: ``model_flops_per_device`` and
  ``transport_consensus_bytes`` equal the reference's, ``parse_collectives``
  reads a literal HLO snippet as the reference does, a ``Roofline``'s
  terms follow its formulas, and the constants are the H100 SXM's
  published peaks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs.registry import ARCHS as JARCHS
from repro.core import flatten as jflatten
from repro.core import transport as jtransport
from repro.launch import roofline as jroofline
from repro.launch import steps as jsteps
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import ARCHS
from repro_torch.core import flatten as tflatten
from repro_torch.core import transport as ttransport
from repro_torch.launch import roofline, steps

FED = 4
WINDOW = 4096


def _port_paths(tree, prefix=()):
    """(key path, shape, dtype name) of every tensor: dict keys sorted,
    NamedTuple fields by name, lists by position."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _port_paths(tree[k], prefix + (k,))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for name in tree._fields
                for x in _port_paths(getattr(tree, name), prefix + (name,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, sub in enumerate(tree)
                for x in _port_paths(sub, prefix + (i,))]
    assert isinstance(tree, torch.Tensor) and tree.device.type == "meta", \
        (prefix, type(tree))
    return [(prefix, tuple(tree.shape), str(tree.dtype).split(".")[-1])]


def _key(entry):
    for attr in ("key", "idx", "name"):
        if hasattr(entry, attr):
            return getattr(entry, attr)
    raise TypeError(entry)


def _jax_paths(tree):
    pairs, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(tuple(_key(e) for e in path), tuple(leaf.shape),
             jnp.dtype(leaf.dtype).name) for path, leaf in pairs]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_structs_match_reference_for_every_shape(arch, monkeypatch):
    draws = []
    real_randn = torch.randn

    def counted_randn(*args, **kw):
        out = real_randn(*args, **kw)
        if not isinstance(out, torch._subclasses.fake_tensor.FakeTensor):
            draws.append(out.numel())
        return out

    monkeypatch.setattr(torch, "randn", counted_randn)
    jcfg, tcfg = JARCHS[arch], ARCHS[arch]
    train = jbase.TrainConfig(remat="full")
    assert _port_paths(steps.serve_params_struct(tcfg)) == \
        _jax_paths(jsteps.serve_params_struct(jcfg))
    assert _port_paths(steps.fed_state_struct(
        tcfg, FED, tbase.TrainConfig(remat="full"))) == \
        _jax_paths(jsteps.fed_state_struct(jcfg, FED, train))
    for name, jshape in jbase.INPUT_SHAPES.items():
        tshape = tbase.INPUT_SHAPES[name]
        fed = FED if jshape.mode == "train" else 0
        assert _port_paths(steps.input_specs(tcfg, tshape, fed)) == \
            _jax_paths(jsteps.input_specs(jcfg, jshape, fed)), name
        if jshape.mode == "decode":
            for window in (None, WINDOW):
                assert _port_paths(steps.decode_state_struct(
                    tcfg, tshape, window)) == _jax_paths(
                        jsteps.decode_state_struct(jcfg, jshape, window)), \
                    (name, window)
    assert draws == []


def test_fed_state_struct_layout():
    """Params in the config's dtype (bf16; the MoE router f32), f32
    moments, an (F,) int32 Adam step and (F,) f32 ratios: about 10 bytes a
    parameter a node of state."""
    cfg = ARCHS["mixtral-8x7b"]
    state = steps.fed_state_struct(cfg, 2, tbase.TrainConfig())
    params = [leaf for _, leaf in tflatten.leaves_with_paths(state.params)]
    assert {p.dtype for p in params} == {torch.bfloat16, torch.float32}
    for tree in (state.opt.m, state.opt.v):
        moments = [leaf for _, leaf in tflatten.leaves_with_paths(tree)]
        assert [m.shape for m in moments] == [p.shape for p in params]
        assert {m.dtype for m in moments} == {torch.float32}
    assert state.opt.step.shape == (2,) and state.opt.step.dtype == torch.int32
    assert state.ratios.shape == (2,) and state.ratios.dtype == torch.float32
    nbytes = sum(leaf.numel() * leaf.element_size()
                 for _, leaf in tflatten.leaves_with_paths(state))
    assert nbytes == sum(p.numel() * (p.element_size() + 8)
                         for p in params) + 2 * 4 + 2 * 4
    assert 10 * cfg.param_count() * 2 < nbytes < 10.01 * cfg.param_count() * 2


# --- roofline -----------------------------------------------------------------

HLO = """
  %ag = bf16[16,4096]{1,0} all-gather(bf16[1,4096]{1,0} %p), dimensions={0}
  %ar.1 = f32[256,1024]{1,0} all-reduce(f32[256,1024]{1,0} %x), to_apply=%add
  %ars = (f32[8]{0}, bf16[4,4]{1,0}) all-reduce-start(f32[8]{0} %a, bf16[4,4]{1,0} %b)
  %rs = f32[16,64]{1,0} reduce-scatter(f32[256,64]{1,0} %y), dimensions={0}
  %cp = bf16[2,1024,4096]{2,1,0} collective-permute(bf16[2,1024,4096]{2,1,0} %z), source_target_pairs={{0,1},{1,0}}
  %a2a = s32[128]{0} all-to-all(s32[128]{0} %w), dimensions={0}
  %add.2 = f32[256,1024]{1,0} add(f32[256,1024]{1,0} %u, f32[256,1024]{1,0} %v)
"""


def test_roofline_constants_are_the_h100s():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.NVLINK_BW == 450e9


def test_parse_collectives_matches_reference():
    got, want = roofline.parse_collectives(HLO), \
        jroofline.parse_collectives(HLO)
    assert got.bytes_by_op == want.bytes_by_op
    assert got.count_by_op == want.count_by_op
    assert got.total == want.total == 6
    assert got.wire_bytes == want.wire_bytes


@pytest.mark.parametrize("shape", sorted(tbase.INPUT_SHAPES))
def test_model_flops_per_device_matches_reference(shape):
    for arch in sorted(ARCHS):
        for devices, fed in ((1, 0), (256, FED)):
            got = roofline.model_flops_per_device(
                ARCHS[arch], tbase.INPUT_SHAPES[shape], devices, fed)
            want = jroofline.model_flops_per_device(
                JARCHS[arch], jbase.INPUT_SHAPES[shape], devices, fed)
            assert got == want, (arch, shape, devices)


def test_roofline_terms_and_consensus_bytes():
    stats = roofline.parse_collectives(HLO)
    jstats = jroofline.parse_collectives(HLO)
    r = roofline.Roofline(flops=4e14, hbm_bytes=2e12, wire_bytes=1e11,
                          collectives=stats, model_flops=3e14)
    jr = jroofline.Roofline(flops=4e14, hbm_bytes=2e12, wire_bytes=1e11,
                            collectives=jstats, model_flops=3e14)
    assert r.t_compute == 4e14 / 989e12
    assert r.t_memory == 2e12 / 3.35e12
    assert r.t_collective == 1e11 / 450e9
    assert r.bottleneck == "memory" and r.useful_ratio == jr.useful_ratio
    assert set(r.row()) == set(jr.row())
    assert roofline.format_row("x", r).split()[-2:] == \
        jroofline.format_row("x", jr).split()[-2:]
    adj = np.eye(6, k=1) + np.eye(6, k=-1)
    adj[0, -1] = adj[-1, 0] = 1.0
    tlayout = tflatten.make_layout({"w": torch.zeros((6, 300)),
                                    "b": torch.zeros((6, 7))})
    jlayout = jflatten.make_layout({"w": jnp.zeros((6, 300)),
                                    "b": jnp.zeros((6, 7))})
    for wire in ("f32", "bf16"):
        t = ttransport.DenseTransport(wire_dtype=wire)
        j = jtransport.DenseTransport(wire_dtype=wire)
        for a in (adj, torch.tensor(adj)):
            assert roofline.transport_consensus_bytes(t, tlayout, a) == \
                jroofline.transport_consensus_bytes(j, jlayout, adj)
        got = r.with_consensus(t, tlayout, adj, 4)
        want = jr.with_consensus(j, jlayout, adj, 4)
        assert got.wire_bytes == want.wire_bytes
