"""Public functions of the port keep the reference's signatures: an AST
comparison (no JAX import) of every top-level function and class method of
``src/repro/kernels/ops.py``, ``src/repro/core/cdfl.py``,
``src/repro/experiment.py``, ``src/repro/checkpointing/checkpoint.py``,
``src/repro/launch/train.py``, ``src/repro/data/pipeline.py`` and
``src/repro/data/synthetic.py`` with its twin in ``src/repro_torch`` (the
batched-sweep and ingest classes of ``experiment.py`` and the CLI's
``_run_sweep`` wait for ROADMAP queue A items 21 and 19). The
leading positional parameters and their defaults must match, after dropping the reference's switches that the port
does not have (``force_kernel``, ``block_*``, ``use_pallas``,
``interpret``, ``transport``, ``flat_local``); the reference's
keyword-only parameters must be keyword-only in the port with the same
defaults. Port-only parameters (``device``, ``s0``) come after. This check
found that ``ops.rwkv6_scan`` took ``s0`` where the reference takes
``chunk``, and ``build_trainer`` ``device`` where it takes ``eval_fn``."""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import ops, ref

ROOT = Path(__file__).resolve().parents[1] / "src"
PAIRS = [("repro/kernels/ops.py", "repro_torch/kernels/ops.py"),
         ("repro/core/cdfl.py", "repro_torch/core/cdfl.py"),
         ("repro/experiment.py", "repro_torch/experiment.py"),
         ("repro/checkpointing/checkpoint.py",
          "repro_torch/checkpointing/checkpoint.py"),
         ("repro/launch/train.py", "repro_torch/launch/train.py"),
         ("repro/data/pipeline.py", "repro_torch/data/pipeline.py"),
         ("repro/data/synthetic.py", "repro_torch/data/synthetic.py")]
# whole functions that are dispatch switches of the reference, and the
# classes and methods of the batched sweeps and ingest not ported yet
DROPPED_FUNCTIONS = {"use_pallas", "_interpret", "_run_sweep"}
DROPPED_CLASSES = {"SweepAxes", "BatchResult", "BatchedSession",
                   "IngestCallback"}
DROPPED_METHODS = {"Experiment.compile_batch"}
DROPPED_PARAMS = {"force_kernel", "use_pallas", "interpret", "transport",
                  "flat_local"}


def _functions(rel: str) -> dict[str, ast.arguments]:
    """Top-level functions by name, class methods as ``Class.method``."""
    tree = ast.parse((ROOT / rel).read_text())
    out = {n.name: n.args for n in tree.body
           if isinstance(n, ast.FunctionDef)}
    for cls in tree.body:
        if isinstance(cls, ast.ClassDef) and cls.name not in DROPPED_CLASSES:
            out.update({f"{cls.name}.{n.name}": n.args for n in cls.body
                        if isinstance(n, ast.FunctionDef)
                        and f"{cls.name}.{n.name}" not in DROPPED_METHODS})
    return out


def _kept(name: str) -> bool:
    return name not in DROPPED_PARAMS and not name.startswith("block_")


def _positional(args: ast.arguments) -> list[tuple[str, str | None]]:
    """(name, default source or None) of each positional parameter."""
    params = args.posonlyargs + args.args
    defaults = [None] * (len(params) - len(args.defaults)) + \
        [ast.unparse(d) for d in args.defaults]
    return [(p.arg, d) for p, d in zip(params, defaults)]


def _keyword_only(args: ast.arguments) -> dict[str, str | None]:
    return {p.arg: None if d is None else ast.unparse(d)
            for p, d in zip(args.kwonlyargs, args.kw_defaults)}


CASES = [(ref_rel, port_rel, name)
         for ref_rel, port_rel in PAIRS
         for name in _functions(ref_rel) if name not in DROPPED_FUNCTIONS]


def test_every_reference_function_is_compared():
    names = {name for _, _, name in CASES}
    assert {"rwkv6_scan", "flash_attention", "robust_agg",
            "build_trainer", "Experiment.compile", "Session.run",
            "Session.resume", "EvalCallback.__init__", "save", "restore",
            "latest_step", "run_experiment", "Experiment.__init__",
            "Experiment._model_fns", "Experiment.trainer", "main",
            "_parse_sweep", "_print_round", "lm_batches", "token_lm",
            "FederatedBatcher.node_items"} <= names
    assert len(CASES) == 62


@pytest.mark.parametrize("ref_rel,port_rel,name", CASES,
                         ids=[f"{Path(r).stem}.{n}" for r, _, n in CASES])
def test_port_twin_keeps_the_reference_signature(ref_rel, port_rel, name):
    port = _functions(port_rel)
    assert name in port, f"{port_rel} has no {name}"
    want = [(p, d) for p, d in _positional(_functions(ref_rel)[name])
            if _kept(p)]
    got = _positional(port[name])
    assert got[:len(want)] == want, (name, got, want)
    want_kw = {p: d for p, d in _keyword_only(_functions(ref_rel)[name])
               .items() if _kept(p)}
    got_kw = _keyword_only(port[name])
    assert {p: got_kw.get(p, "<missing>") for p in want_kw} == want_kw


@pytest.mark.parametrize("call", ["positional", "keyword"])
def test_rwkv6_scan_chunk_reaches_the_plain_scan_with_no_state(call,
                                                             monkeypatch):
    seen = {}

    def plain(r, k, v, w, u, s0=None, chunk=16):
        seen.update(s0=s0, chunk=chunk)
        return r, None

    monkeypatch.setattr(ref, "rwkv6_scan", plain)
    r = torch.zeros((1, 16, 2, 8))
    u = torch.zeros((2, 8))
    if call == "positional":
        ops.rwkv6_scan(r, r, r, r, u, 16)
    else:
        ops.rwkv6_scan(r, r, r, r, u, chunk=16)
    assert seen == {"s0": None, "chunk": 16}
    ops.rwkv6_scan(r, r, r, r, u)
    assert seen == {"s0": None, "chunk": 32}      # the reference's default
