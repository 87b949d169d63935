"""The port's checkpointing (``repro_torch.checkpointing``): a FedState
round-trips exactly (flat buffer, Adam moments and step counters, CND
ratios and sizes, the int round, an empty ``tstate`` and a straggle
``fstate``), bf16 leaves survive the f32 storage, the write leaves no
``.tmp`` file, mismatched shapes, leaf counts and flat layouts raise clear
errors, ``latest_step`` reads the manifest, and ``Session.resume`` wraps
any failure in the reference's ``ValueError``. No JAX here."""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch import checkpointing
from repro_torch import experiment as texp
from repro_torch.configs import base as tbase
from repro_torch.core import flatten
from repro_torch.core.cdfl import FedState
from repro_torch.optim.adam import FlatAdamState


def _state(k=3, widths=(10, 6), fstate=True, seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {f"w{i}": torch.randn((k, w), generator=g)
              for i, w in enumerate(widths)}
    buf, layout = flatten.flatten(params)
    opt = FlatAdamState(step=torch.arange(k, dtype=torch.int32),
                        m=torch.randn(buf.shape, generator=g),
                        v=torch.rand(buf.shape, generator=g))
    return FedState(buf, layout, opt, torch.rand(k, generator=g),
                    torch.full((k,), 7.0), 5, (),
                    torch.randn(buf.shape, generator=g) if fstate else ())


def _zeros_like(state):
    return FedState(torch.zeros_like(state.buf), state.layout,
                    FlatAdamState(*(torch.zeros_like(t) for t in state.opt)),
                    torch.zeros_like(state.ratios),
                    torch.zeros_like(state.sizes), 0, state.tstate,
                    torch.zeros_like(state.fstate)
                    if isinstance(state.fstate, torch.Tensor) else ())


@pytest.mark.parametrize("fstate", [True, False])
def test_fed_state_round_trips_exactly(tmp_path, fstate):
    state = _state(fstate=fstate)
    path = str(tmp_path / "ck")
    checkpointing.save(path, state, step=5)
    got = checkpointing.restore(path, _zeros_like(state))
    assert isinstance(got, FedState) and isinstance(got.opt, FlatAdamState)
    assert got.layout == state.layout and got.round == 5
    assert isinstance(got.round, int) and got.tstate == ()
    for a, b in ((got.buf, state.buf), (got.opt.step, state.opt.step),
                 (got.opt.m, state.opt.m), (got.opt.v, state.opt.v),
                 (got.ratios, state.ratios), (got.sizes, state.sizes)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if fstate:
        assert torch.equal(got.fstate, state.fstate)
    else:
        assert got.fstate == ()
    manifest = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    assert manifest["step"] == 5
    assert manifest["keys"][:2] == ["buf", "opt/step"]
    assert list(manifest["layouts"]) == ["layout"]


def test_bf16_leaves_stored_as_f32_and_cast_back(tmp_path):
    tree = {"a": torch.randn(4, 5).to(torch.bfloat16),
            "b": [torch.arange(3, dtype=torch.int64), 2.5]}
    path = str(tmp_path / "bf")
    checkpointing.save(path, tree)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        assert data["a0"].dtype == np.float32
    manifest = json.loads(open(os.path.join(path, "manifest.json")).read())
    assert manifest["dtypes"] == ["torch.bfloat16", "torch.int64", "float"]
    like = {"a": torch.zeros(4, 5, dtype=torch.bfloat16),
            "b": [torch.zeros(3, dtype=torch.int64), 0.0]}
    got = checkpointing.restore(path, like)
    assert got["a"].dtype == torch.bfloat16 and torch.equal(got["a"],
                                                            tree["a"])
    assert torch.equal(got["b"][0], tree["b"][0]) and got["b"][1] == 2.5
    # restore casts to the target's dtype
    got = checkpointing.restore(path, {"a": torch.zeros(4, 5),
                                       "b": [torch.zeros(3), 0.0]})
    assert got["a"].dtype == torch.float32
    assert torch.equal(got["a"], tree["a"].float())


def test_save_is_atomic_and_leaves_no_tmp(tmp_path):
    path = tmp_path / "ck"
    checkpointing.save(str(path), _state(), step=1)
    checkpointing.save(str(path), _state(seed=1), step=2)
    assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.json"]
    got = checkpointing.restore(str(path), _zeros_like(_state()))
    assert torch.equal(got.buf, _state(seed=1).buf)


def test_mismatches_raise_clear_errors(tmp_path):
    path = str(tmp_path / "ck")
    checkpointing.save(path, _state(k=3))
    with pytest.raises(ValueError, match="checkpoint shape"):
        checkpointing.restore(path, _zeros_like(_state(k=4)))
    with pytest.raises(ValueError, match="checkpoint has 8 leaves, target "
                                         "structure has 7"):
        checkpointing.restore(path, _zeros_like(_state(fstate=False)))
    # the same (3, 128) buffer split into other leaves: the layouts differ
    other = _state(widths=(6, 10))
    assert other.buf.shape == _state().buf.shape
    with pytest.raises(ValueError, match="flat buffer layout at 'layout'"):
        checkpointing.restore(path, _zeros_like(other))


def test_latest_step(tmp_path):
    path = str(tmp_path / "ck")
    assert checkpointing.latest_step(path) is None
    checkpointing.save(path, {"a": torch.ones(2)}, step=3)
    assert checkpointing.latest_step(path) == 3
    checkpointing.save(path, {"a": torch.ones(2)}, step=7)
    assert checkpointing.latest_step(path) == 7
    checkpointing.save(path, {"a": torch.ones(2)})
    assert checkpointing.latest_step(path) is None


def _session(hidden):
    k = 3

    def init(g):
        return {"w": torch.randn((5, hidden), generator=g),
                "b": torch.zeros(hidden)}

    def loss(params, batch):
        out = torch.bmm(batch["x"], params["w"]) + params["b"][:, None]
        return (out ** 2).mean(dim=(1, 2))

    exp = texp.Experiment.from_parts(
        loss, init, fed=tbase.FedConfig(num_nodes=k, local_steps=2),
        train=tbase.TrainConfig(batch_size=4), device="cpu")
    rng = np.random.default_rng(0)
    data = {"x": rng.normal(size=(k, 8, 5)).astype(np.float32)}
    items = rng.integers(0, 50, size=(k, 8, 4)).astype(np.int32)
    return exp.compile(data, items)


def test_session_resume_wraps_failures(tmp_path):
    path = str(tmp_path / "ck")
    first = _session(hidden=4)
    first.run(3)
    assert first.save(path) == path
    assert checkpointing.latest_step(path) == 3
    resumed = _session(hidden=4).resume(path)
    assert resumed.rounds_completed == 3
    assert torch.equal(resumed.state.buf, first.state.buf)
    with pytest.raises(ValueError, match="cannot resume from .* layout"):
        _session(hidden=6).resume(path)
    with pytest.raises(ValueError, match="cannot resume from") as info:
        _session(hidden=4).resume(str(tmp_path / "missing"))
    assert isinstance(info.value.__cause__, FileNotFoundError)
