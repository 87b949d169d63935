"""The port's training CLI (``repro_torch.launch.train``) on the CPU at
``--quick --rounds 3``: both drivers, the ``FAULT_SMOKE`` and
``HIER_SMOKE`` verdicts (each line equal to the JAX package's CLI under
the same flags), a ``--checkpoint`` round trip, the flags of the ring and
gossip transports and of the redundancy-aware ingest (ROADMAP items 20 and
19, refused until they were ported), which parse and build their trainer,
and the refusal of what is not ported yet, naming its ROADMAP item."""
import re
import sys

import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro_torch import experiment as texp
from repro_torch.checkpointing import latest_step, restore
from repro_torch.core import flatten
from repro_torch.ingest.sketches import SketchState
from repro_torch.launch import train as ttrain


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The port's tensors here are a few nodes' small MLPs: one intra-op
    thread, so that the spinning threads of a machine loaded by several
    pytest-xdist workers do not dominate (an op on such a tensor took
    milliseconds there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


QUICK = ["--quick", "--rounds", "3"]
ROUND = re.compile(r"^round +(\d+) loss/node=\[.*\] mean=([0-9.]+) "
                   r"disagree=\S+ \(\S+s\)$")


def _port(capsys, *flags):
    state, losses = ttrain.main(QUICK + list(flags) + ["--device", "cpu"])
    assert losses.shape == (3, 4)
    return state, capsys.readouterr().out.splitlines(), losses


def _reference(capsys, monkeypatch, *flags):
    monkeypatch.setattr(sys, "argv", ["train"] + QUICK + list(flags))
    jtrain.main()
    return capsys.readouterr().out.splitlines()


def _round_means(lines):
    means = [float(m.group(2)) for m in map(ROUND.match, lines) if m]
    assert len(means) == 3, lines
    return np.array(means)


@pytest.mark.parametrize("driver", ["scan", "loop"])
def test_both_drivers_train(capsys, driver):
    state, lines, losses = _port(capsys, "--driver", driver)
    assert lines[0].startswith(
        f"arch=qwen3-1.7b-smoke nodes=4 alg=cdfl driver={driver} "
        f"transport=dense/f32 CND ratios=")
    means = _round_means(lines)
    np.testing.assert_allclose(means, losses.mean(axis=1), atol=1e-4)
    assert np.isfinite(means).all() and means[-1] < means[0]
    if driver == "scan":
        assert lines[-1].startswith("total ") and "ms/round" in lines[-1]
    assert state.round == 3 and torch.isfinite(state.buf).all()


@pytest.mark.parametrize("flags,verdict", [
    (("--faults", "crash,corrupt"), "FAULT_SMOKE"),
    (("--hierarchy",), "HIER_SMOKE"),
])
def test_smoke_verdicts_ok_and_equal_to_the_reference(capsys, monkeypatch,
                                                      flags, verdict):
    _, lines, _ = _port(capsys, *flags)
    mine = [ln for ln in lines if ln.startswith(verdict)]
    assert len(mine) == 1 and mine[0].startswith(f"{verdict} ok "), lines
    ref = [ln for ln in _reference(capsys, monkeypatch, *flags)
           if ln.startswith(verdict)]
    assert mine == ref


def test_checkpoint_round_trip(capsys, tmp_path):
    path = str(tmp_path / "ckpt")
    state, lines, _ = _port(capsys, "--driver", "loop", "--checkpoint",
                            path)
    assert lines[-1] == f"saved params to {path}"
    assert latest_step(path) == 3
    like = flatten.tree_map(torch.zeros_like, state.params)
    back = restore(path, like)
    want = dict(flatten.leaves_with_paths(state.params))
    got = dict(flatten.leaves_with_paths(back))
    assert set(got) == set(want) and len(got) == 14
    for path_, leaf in want.items():
        assert torch.equal(got[path_], leaf), path_


class _Built(Exception):
    """Raised in place of the first round: the trainer was built."""


# ROADMAP items ported after their flags were first refused here
_PORTED = {"item 19", "item 20", "item 23c"}


@pytest.mark.parametrize("flags,item", [
    (("--sweep", "seeds=2", "--transport", "gossip", "--staleness", "2"),
     "item 20"),
    (("--redundancy", "duplicate_heavy"), "item 19"),
    (("--transport", "ring"), "item 20"),
    (("--transport", "gossip", "--staleness", "2"), "item 20"),
    (("--arch", "mixtral-8x7b"), "item 23c"),
])
def test_unported_options_are_refused_naming_their_item(monkeypatch, flags,
                                                        item):
    """Ported flags build their trainer and state (the run stops before
    its first round); the others raise naming their ROADMAP item.
    ``--arch mixtral-8x7b`` builds since item 23c was ported."""
    argv = QUICK + list(flags) + ["--device", "cpu"]
    if item not in _PORTED:
        with pytest.raises(NotImplementedError, match=item):
            ttrain.main(argv)
        return
    built = []

    def stop(session, rounds, *args, **kw):
        built.append((session.experiment.fed,
                      session.experiment.trainer(session.data),
                      getattr(session, "state", None)
                      or session.states))
        raise _Built

    monkeypatch.setattr(texp.Session, "run", stop)
    monkeypatch.setattr(texp.BatchedSession, "run_batch", stop)
    with pytest.raises(_Built):
        ttrain.main(argv)
    (fed, trainer, state), = built
    assert trainer.device == torch.device("cpu")
    if "--arch" in flags:
        # mixtral (ROADMAP item 23c, refused until it was ported): the
        # MoE transformer's params, router and experts, in the buffer
        assert "layers/ffn/router" in state.layout.names
        assert state.layout.shapes[state.layout.names.index(
            "layers/ffn/w_gate")][:2] == (2, 4)
    elif "--redundancy" in flags:
        assert fed.ingest.scenario == "duplicate_heavy"
        assert fed.ingest.weighting == "both"
        assert isinstance(state.istate, SketchState)
    else:
        assert fed.transport == flags[flags.index("--transport") + 1]
    if "--staleness" in flags:
        assert fed.staleness == 2
        # the snapshots (s, K, P), with the sweep's variant axis in front
        lead = (2,) if "--sweep" in flags else ()
        assert tuple(state.tstate.shape) == lead + (2,) + tuple(
            state.buf.shape[-2:])


def test_argument_errors_match_the_reference(capsys):
    with pytest.raises(SystemExit):
        ttrain.main(QUICK + ["--sweep", "colour=1"])
    assert "unknown sweep axis 'colour'" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        ttrain.main(QUICK + ["--driver", "loop", "--faults", "crash"])
    assert "--faults needs --driver scan" in capsys.readouterr().err
    assert ttrain._parse_sweep("seeds=3:7,lr=1e-3") == jtrain._parse_sweep(
        "seeds=3:7,lr=1e-3")
