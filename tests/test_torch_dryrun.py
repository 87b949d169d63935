"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's specs and roofline, with nothing allocated:

* ``python -m repro_torch.launch.dryrun`` for qwen3-1.7b x decode_32k and
  x train_4k on the single-pod mesh, and for the one-pod combos that
  failed before the MoE dispatch and the rwkv6 scan ran on each rank's
  shards (mixtral-8x7b x train_4k and x prefill_32k, dbrx-132b x
  train_4k, rwkv6-7b x prefill_32k, musicgen-medium x long_500k), each in a subprocess, all at once, each under its own time
  limit (the reference's dry run is never imported here: it sets
  ``XLA_FLAGS`` when imported);
* each record has the reference's keys (``dryrun.py``'s record and
  ``Roofline.row()``), ``temps`` null;
* its ``arguments`` bytes equal the local shard bytes the reference's
  specs imply on the same mesh (every combo); its model FLOPs and
  consensus wire bytes equal the reference's functions' (qwen3); the
  per-arch policy is the reference's;
* a failing step goes to ``failures`` and exits 1, and the fake group is
  destroyed whatever happened.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist

from repro.configs import base as jbase
from repro.configs.registry import ARCHS as JARCHS
from repro.core import flatten as jflatten
from repro.core import topology as jtopology
from repro.core import transport as jtransport
from repro.launch import roofline as jroofline
from repro.launch import sharding as jsharding
from repro.launch import steps as jsteps

ROOT = Path(__file__).resolve().parents[1]
PROD = SimpleNamespace(axis_names=("data", "model"),
                       shape={"data": 16, "model": 16})
SHAPES = ("decode_32k", "train_4k")
# the one-pod combos that failed before each rank routed its own MoE
# groups and scanned its own rwkv6 rows and heads, each at full depth
FORMER_FAILURES = (("mixtral-8x7b", "train_4k"),
                   ("mixtral-8x7b", "prefill_32k"),
                   ("dbrx-132b", "train_4k"),
                   ("rwkv6-7b", "prefill_32k"),
                   ("musicgen-medium", "long_500k"))
COMBOS = tuple(("qwen3-1.7b", shape) for shape in SHAPES) \
    + FORMER_FAILURES
TIMEOUT = 600                 # seconds a dry-run subprocess may take


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Every combo's dry run as a subprocess, all at once, each waited for
    under its own time limit and killed on the way out: ``{(arch,
    shape): (exit code, output, JSON or None)}``."""
    out = tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = {}
    done = {}
    try:
        for arch, shape in COMBOS:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--out",
                   str(out / f"{arch}_{shape}.json")]
            procs[arch, shape] = subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        for (arch, shape), proc in procs.items():
            text, _ = proc.communicate(timeout=TIMEOUT)
            path = out / f"{arch}_{shape}.json"
            done[arch, shape] = (proc.returncode, text, json.loads(
                path.read_text()) if path.exists() else None)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return done


def _record(records, arch, shape):
    """The combo's one record, after its run printed ``1 ok, 0 failed``."""
    rc, text, data = records[arch, shape]
    assert rc == 0, text[-4000:]
    assert "1 ok, 0 failed" in text
    assert data["failures"] == []
    return data["records"][0]


def _reference_record_keys():
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "rec":
            keys = {k.value for k in node.value.keys if k is not None}
            inner = next(v for k, v in zip(node.value.keys,
                                           node.value.values)
                         if k is not None and k.value == "bytes_per_device")
            return keys, {k.value for k in inner.keys}
    raise AssertionError("no record in the reference's dry run")


def _local_bytes(tree, specs, mesh):
    total = 0
    leaves = jax.tree.leaves(tree)
    spec_l = jax.tree.leaves(specs, is_leaf=lambda s: isinstance(
        s, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_l)
    for leaf, spec in zip(leaves, spec_l):
        n = 1
        for dim, entry in zip(leaf.shape,
                              tuple(spec) + (None,) * leaf.ndim):
            axes = () if entry is None else \
                (entry,) if isinstance(entry, str) else entry
            n *= -(-dim // int(np.prod([mesh.shape[a] for a in axes])))
        total += n * jnp.dtype(leaf.dtype).itemsize
    return total


def _spec_tree(tree, fn, mesh):
    return jax.tree.map(lambda l: fn(tuple(l.shape), mesh) if l.shape
                        else jax.sharding.PartitionSpec(), tree)


def _reference_policy():
    """FED_NODES, DEFAULT_FED and LONG_WINDOW of the reference's dry run,
    read from its source (importing it sets ``XLA_FLAGS``)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    return {node.targets[0].id: ast.literal_eval(node.value)
            for node in tree.body if isinstance(node, ast.Assign)
            and getattr(node.targets[0], "id", None) in (
                "FED_NODES", "DEFAULT_FED", "LONG_WINDOW")}


def _reference_arguments(shape_name: str,
                         arch: str = "qwen3-1.7b") -> int:
    """The bytes of this rank's shards of the step's inputs, by the
    reference's structs and specs on the single-pod mesh."""
    policy = _reference_policy()
    cfg = JARCHS[arch]
    shape = jbase.INPUT_SHAPES[shape_name]
    if shape.mode == "train":
        f = policy["FED_NODES"].get(arch, policy["DEFAULT_FED"])
        fed = SimpleNamespace(axis_names=("fed", "dp", "tp"),
                              shape={"fed": f, "dp": 16 // f, "tp": 16})
        state = jsteps.fed_state_struct(cfg, f, jbase.TrainConfig(
            remat="full"))
        fsdp = cfg.param_count() * 10 / fed.shape["tp"] > 4e9
        specs = jsharding._tree_specs(state, jsharding.fed_param_spec, fed,
                                      fsdp=fsdp)
        batch = jsteps.input_specs(cfg, shape, f)
        return _local_bytes(state, specs, fed) + _local_bytes(
            batch, _spec_tree(batch, jsharding.fed_batch_spec, fed), fed)
    params = jsteps.serve_params_struct(cfg)
    fsdp = cfg.param_count() * 2 / PROD.shape["model"] > 8e9
    specs = jsharding._tree_specs(params, jsharding.serve_param_spec, PROD,
                                  fsdp=fsdp)
    total = _local_bytes(params, specs, PROD)
    if shape.mode == "prefill":
        batch = jsteps.input_specs(cfg, shape)
        return total + _local_bytes(batch, _spec_tree(
            batch, jsharding.serve_batch_spec, PROD), PROD)
    window = policy["LONG_WINDOW"] if shape_name == "long_500k" \
        and cfg.num_heads > 0 and cfg.sliding_window is None else None
    dstate = jsteps.decode_state_struct(cfg, shape, window_override=window)
    tokens = jsteps.input_specs(cfg, shape)["tokens"]
    return (total
            + _local_bytes(dstate, _spec_tree(dstate, jsharding.cache_spec,
                                              PROD), PROD)
            + _local_bytes(tokens, jsharding.serve_batch_spec(
                tuple(tokens.shape), PROD), PROD))


@pytest.mark.parametrize("shape_name", SHAPES)
def test_record_matches_the_reference(records, shape_name):
    rec = _record(records, "qwen3-1.7b", shape_name)
    keys, byte_keys = _reference_record_keys()
    row = jroofline.Roofline(1.0, 1.0, 1.0, jroofline.CollectiveStats(),
                             1.0).row()
    assert set(rec) == keys | set(row)
    assert set(rec["bytes_per_device"]) == byte_keys
    assert rec["bytes_per_device"]["temps"] is None
    assert rec["bytes_per_device"]["total_gb"] is None
    assert rec["devices"] == 256 and rec["multi_pod"] is False
    assert rec["bytes_per_device"]["arguments"] == \
        _reference_arguments(shape_name)
    assert rec["bytes_per_device"]["outputs"] > 0
    assert rec["hlo_gflops"] > 0 and rec["hbm_gb"] > 0
    assert rec["collective_counts"] and set(rec["collective_counts"]) == \
        set(rec["collective_bytes"])
    cfg = JARCHS["qwen3-1.7b"]
    shape = jbase.INPUT_SHAPES[shape_name]
    train = shape.mode == "train"
    want_mf = jroofline.model_flops_per_device(cfg, shape, 256,
                                               4 if train else 0)
    got_mf = rec["useful_flops_ratio"] * rec["hlo_gflops"] * 1e9
    np.testing.assert_allclose(got_mf, want_mf, rtol=1e-9)
    if train:
        assert rec["fed_nodes"] == 4 and rec["transport"] == "dense"
        fed = jbase.FedConfig(num_nodes=4)
        state = jsteps.fed_state_struct(cfg, 4, jbase.TrainConfig())
        want = jroofline.transport_consensus_bytes(
            jtransport.make_transport(fed), jflatten.make_layout(
                state.params), jtopology.adjacency(fed.topology, 4))
        assert rec["consensus_wire_bytes_per_node"] == want
        # the consensus ring's two permutes a dtype (params, ratios)
        assert rec["collective_counts"]["collective-permute"] == 4
    else:
        assert rec["consensus_wire_bytes_per_node"] == 0.0
        assert rec["fed_nodes"] == 0


@pytest.mark.parametrize("arch,shape_name", FORMER_FAILURES,
                         ids=[f"{a}-{s}" for a, s in FORMER_FAILURES])
def test_former_failure_runs_with_the_reference_arguments(records, arch,
                                                          shape_name):
    """The MoE's dispatch on each rank's groups (mixtral, dbrx), the rwkv6
    scan on each rank's rows and heads and musicgen's batch-1 decode with
    24 heads over 16 ranks run on the single-pod mesh; the step's
    arguments are the shards the reference's specs imply."""
    rec = _record(records, arch, shape_name)
    assert rec["arch"] == arch and rec["devices"] == 256
    assert rec["bytes_per_device"]["arguments"] == _reference_arguments(
        shape_name, arch)
    assert rec["bytes_per_device"]["outputs"] > 0
    assert rec["hlo_gflops"] > 0 and rec["hbm_gb"] > 0
    assert set(rec["collective_counts"]) == set(rec["collective_bytes"])


def test_policy_is_the_reference_policy():
    from repro_torch.launch import dryrun
    policy = _reference_policy()
    assert dryrun.FED_NODES == policy["FED_NODES"]
    assert dryrun.DEFAULT_FED == policy["DEFAULT_FED"]
    assert dryrun.LONG_WINDOW == policy["LONG_WINDOW"]


def test_failures_exit_one_and_the_fake_group_is_destroyed(monkeypatch,
                                                           capsys):
    from repro_torch.launch import dryrun, steps

    def broken(*args, **kw):
        raise RuntimeError("Sharding propagation failed for "
                           "aten.frobnicate.default(...) on DeviceMesh")

    monkeypatch.setattr(steps, "make_prefill_step", broken)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="frobnicate"):
        dryrun.dryrun_one("qwen3-1.7b", "prefill_32k", verbose=False)
    assert not dist.is_initialized()
    with pytest.raises(SystemExit) as exit_:
        dryrun.main(["--arch", "qwen3-1.7b", "--shape", "prefill_32k"])
    assert exit_.value.code == 1
    out = capsys.readouterr().out
    assert "0 ok, 1 failed" in out
    assert "FAIL qwen3-1.7b prefill_32k RuntimeError: aten.frobnicate" \
        ".default" in out
    assert not dist.is_initialized()
