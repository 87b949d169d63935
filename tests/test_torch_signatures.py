"""Public functions of the port keep the reference's signatures: an AST
comparison (no JAX import) of every top-level function and class method of
``src/repro/kernels/ops.py``, ``src/repro/core/cdfl.py``,
``src/repro/experiment.py``, ``src/repro/checkpointing/checkpoint.py``,
``src/repro/launch/train.py``, ``src/repro/data/pipeline.py``,
``src/repro/data/synthetic.py``, ``src/repro/mobility/mixing.py``,
``src/repro/core/transport.py``, ``src/repro/core/sketch.py``, the three
modules of ``src/repro/ingest/`` and ``src/repro/models/transformer.py``,
``moe.py``, ``mamba.py`` and ``stubs.py``, ``src/repro/launch/steps.py``,
``roofline.py``, ``mesh.py``, ``sharding.py`` and ``dryrun.py``,
``src/repro/models/pspec.py``, ``src/repro/core/consensus.py``,
``src/repro/optim/adam.py`` and ``schedules.py``, and
``src/repro/kernels/ref.py`` and ``src/repro/registry.py``
with its twin in ``src/repro_torch``, and of the trainer's batched driver
and stack builder nested in ``build_trainer``. The leading positional parameters and their
defaults must match, after dropping the reference's switches that the port
does not have (``force_kernel``, ``block_*``, ``use_pallas``,
``interpret``, ``transport`` but in the roofline, ``flat_local``,
``unroll``, ``use_flat``) and reading the
reference's ``rng`` as the port's ``generator``; the reference's
keyword-only parameters must be keyword-only in the port with the same
defaults. Port-only parameters (``device``, ``s0``) come after;
``transformer.init_params`` keeps its own pinned order. This check
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
         ("repro/data/synthetic.py", "repro_torch/data/synthetic.py"),
         ("repro/mobility/mixing.py", "repro_torch/mobility/mixing.py"),
         ("repro/core/transport.py", "repro_torch/core/transport.py"),
         ("repro/core/sketch.py", "repro_torch/core/sketch.py"),
         ("repro/ingest/scenarios.py", "repro_torch/ingest/scenarios.py"),
         ("repro/ingest/sketches.py", "repro_torch/ingest/sketches.py"),
         ("repro/ingest/weighting.py", "repro_torch/ingest/weighting.py"),
         ("repro/models/transformer.py",
          "repro_torch/models/transformer.py"),
         ("repro/models/moe.py", "repro_torch/models/moe.py"),
         ("repro/models/mamba.py", "repro_torch/models/mamba.py"),
         ("repro/models/stubs.py", "repro_torch/models/stubs.py"),
         ("repro/launch/steps.py", "repro_torch/launch/steps.py"),
         ("repro/optim/adam.py", "repro_torch/optim/adam.py"),
         ("repro/optim/schedules.py", "repro_torch/optim/schedules.py"),
         ("repro/launch/roofline.py", "repro_torch/launch/roofline.py"),
         ("repro/launch/mesh.py", "repro_torch/launch/mesh.py"),
         ("repro/launch/sharding.py", "repro_torch/launch/sharding.py"),
         ("repro/models/pspec.py", "repro_torch/models/pspec.py"),
         ("repro/launch/dryrun.py", "repro_torch/launch/dryrun.py"),
         ("repro/core/consensus.py", "repro_torch/core/consensus.py"),
         ("repro/kernels/ref.py", "repro_torch/kernels/ref.py"),
         ("repro/registry.py", "repro_torch/registry.py")]
# whole functions that are dispatch switches of the reference (its CPU
# wire-cast gate among them, and the one-shot consensus step's choice
# between a per-leaf and a virtual flat form)
DROPPED_FUNCTIONS = {"use_pallas", "_interpret", "_fused_wire",
                     "_cast_noops", "_prefer_flat",
                     "_consensus_step_perleaf",
                     "_consensus_step_virtual_flat"}
DROPPED_CLASSES: set = set()
DROPPED_METHODS: set = set()
# the same default in each package's spelling
SAME_DEFAULT = {"jnp.float32": "torch.float32"}
# ``unroll`` (the transformer's forward and decode step, the dry run):
# straight-line HLO so that XLA's cost analysis counts every layer of a
# scanned stack, a switch of the reference's dry-run with no meaning
# outside XLA; its dry run's ``--fast`` flag is the same switch (a layer
# scan), so the port's dry run has no such flag
# ``use_flat``: the one-shot consensus step's per-leaf/flat switch
DROPPED_PARAMS = {"force_kernel", "use_pallas", "interpret", "transport",
                  "flat_local", "unroll", "use_flat"}
# the same parameter in each package's spelling: a torch.Generator takes
# the place of a JAX PRNG key
SAME_NAME = {"rng": "generator"}
# the port's own positional order, pinned: ``transformer.init_params``
# takes the config first and the generator optional (a CPU generator
# seeded with 0), as every caller of the port has called it since the
# dense slice; the reference takes (rng, cfg, dtype=None)
REORDERED = {("repro/models/transformer.py", "init_params"): [
    ("cfg", None), ("generator", "None"), ("device", "None"),
    ("dtype", "None")]}


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


# a dropped name that is a real parameter in one reference file: the
# roofline prices a ``transport`` object (a trainer's switch elsewhere)
KEPT_PARAMS = {"repro/launch/roofline.py": {"transport"}}


def _kept(name: str, rel: str = "") -> bool:
    if name in KEPT_PARAMS.get(rel, ()):
        return True
    return name not in DROPPED_PARAMS and not name.startswith("block_")


def _positional(args: ast.arguments) -> list[tuple[str, str | None]]:
    """(name, default source or None) of each positional parameter."""
    params = args.posonlyargs + args.args
    defaults = [None] * (len(params) - len(args.defaults)) + \
        [SAME_DEFAULT.get(ast.unparse(d), ast.unparse(d))
         for d in args.defaults]
    return [(SAME_NAME.get(p.arg, p.arg), d)
            for p, d in zip(params, defaults)]


def _keyword_only(args: ast.arguments) -> dict[str, str | None]:
    return {p.arg: None if d is None else ast.unparse(d)
            for p, d in zip(args.kwonlyargs, args.kw_defaults)}


CASES = [(ref_rel, port_rel, name)
         for ref_rel, port_rel in PAIRS
         for name in _functions(ref_rel) if name not in DROPPED_FUNCTIONS]
# 62 before the batched sweeps: + SweepAxes (2), BatchResult (2),
# BatchedSession (7), Experiment.compile_batch, _run_sweep and the ten
# functions of mobility/mixing.py; then IngestCallback (2), the 22 of
# core/transport.py, the 15 of core/sketch.py and the 7 + 5 + 7 of
# ingest/scenarios.py, sketches.py and weighting.py; then the 11 of
# models/transformer.py, the 4 of moe.py, the 9 of mamba.py and the 2 of
# stubs.py; then the 9 of launch/steps.py, the 4 of optim/adam.py, the 3
# of optim/schedules.py and the 5 functions and 9 methods of
# launch/roofline.py; then the two functions core/transport.py's mesh
# path adds (ring_exchange_shard, _wire_dtype), the 7 of launch/mesh.py,
# the 12 of launch/sharding.py, the 2 of models/pspec.py, the 3 of
# launch/dryrun.py and the 8 of core/consensus.py; then the 11 of
# kernels/ref.py and the 6 functions and 18 methods of registry.py
CASE_COUNT = 62 + 2 + 2 + 7 + 1 + 1 + 10 + 2 + 22 + 15 + 7 + 5 + 7 + 11 + 4 \
    + 9 + 2 + 9 + 4 + 3 + 14 + 2 + 7 + 12 + 2 + 3 + 8 + 11 + 24


def test_every_reference_function_is_compared():
    names = {name for _, _, name in CASES}
    assert {"rwkv6_scan", "flash_attention", "robust_agg",
            "build_trainer", "Experiment.compile", "Session.run",
            "Session.resume", "EvalCallback.__init__", "save", "restore",
            "latest_step", "run_experiment", "Experiment.__init__",
            "Experiment._model_fns", "Experiment.trainer", "main",
            "_parse_sweep", "_print_round", "lm_batches", "token_lm",
            "FederatedBatcher.node_items", "SweepAxes.variants",
            "BatchResult.select", "BatchedSession.run_batch",
            "Experiment.compile_batch", "_run_sweep",
            "stack_variant_stacks", "IngestCallback.on_run_end",
            "GossipTransport.exchange", "RingShardTransport.exchange",
            "wire_codec", "simhash", "compile_plan", "slot_hashes",
            "weighted_indices", "reweight_eta", "init_params", "init_decode",
            "decode_forward", "chunked", "scan_reference",
            "vision_patch_embeddings", "make_fed_train_step",
            "ring_consensus_roll", "fed_state_struct", "decode_state_struct",
            "sgd", "global_norm", "cosine", "model_flops_per_device",
            "parse_collectives", "Roofline.with_consensus",
            "ring_exchange_shard", "_wire_dtype", "make_fed_mesh",
            "fed_param_spec", "with_sharding", "constrain", "dryrun_one",
            "ring_consensus_shard", "ring_sketch_exchange",
            "consensus_step_pytree", "partial_consensus_step_pytree",
            "Registry.register", "Registry.unregister", "Registry.view",
            "RegistryView.__contains__"} <= names
    assert len(CASES) == CASE_COUNT


@pytest.mark.parametrize("ref_rel,port_rel,name", CASES,
                         ids=[f"{Path(r).stem}.{n}" for r, _, n in CASES])
def test_port_twin_keeps_the_reference_signature(ref_rel, port_rel, name):
    port = _functions(port_rel)
    assert name in port, f"{port_rel} has no {name}"
    want = [(p, d) for p, d in _positional(_functions(ref_rel)[name])
            if _kept(p, ref_rel)]
    got = _positional(port[name])
    if (ref_rel, name) in REORDERED:
        want = REORDERED[ref_rel, name]
        assert got == want, (name, got, want)
    assert got[:len(want)] == want, (name, got, want)
    want_kw = {p: d for p, d in _keyword_only(_functions(ref_rel)[name])
               .items() if _kept(p, ref_rel)}
    got_kw = _keyword_only(port[name])
    assert {p: got_kw.get(p, "<missing>") for p in want_kw} == want_kw


def _nested(rel: str, outer: str) -> dict[str, ast.arguments]:
    """The functions defined directly in the body of ``outer``."""
    tree = ast.parse((ROOT / rel).read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == outer)
    return {n.name: n.args for n in fn.body
            if isinstance(n, ast.FunctionDef)}


@pytest.mark.parametrize("name", ["run_rounds_batch", "mixing_stack"])
def test_trainer_twin_keeps_the_reference_signature(name):
    """``Trainer.run_rounds_batch`` and ``Trainer.mixing_stack`` (defined
    inside ``build_trainer``): positional parameters and defaults, and the
    reference's keyword-only ones, keyword-only in the port with the same
    defaults (``idx`` is the port's own)."""
    want = _nested("repro/core/cdfl.py", "build_trainer")[name]
    got = _nested("repro_torch/core/cdfl.py", "build_trainer")[name]
    assert _positional(got)[:len(_positional(want))] == _positional(want)
    want_kw = _keyword_only(want)
    got_kw = _keyword_only(got)
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
