"""The port stands alone: no import of JAX or of the JAX package, configs
that read the same as the reference's, entry points that run on the card
unless asked for the CPU, and refusals for what is not ported yet (and
builds of what has been ported since)."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import paper_models as jmodels
from repro.configs import registry as jregistry
from repro.data import pipeline as jpipeline
from repro.data import redundancy as jredundancy
from repro.data import synthetic as jsynthetic
from repro_torch import convert, experiment, registry
from repro_torch.configs import base as tbase
from repro_torch.configs import paper_models as tmodels
from repro_torch.configs import registry as tregistry
from repro_torch.configs.paper_models import MLP_CONFIG
from repro_torch.core import cdfl
from repro_torch.data import pipeline as tpipeline
from repro_torch.data import redundancy as tredundancy
from repro_torch.data import synthetic as tsynthetic
from repro_torch.launch import serve, steps
from repro_torch.models import simple, transformer
from repro_torch.optim import AdamState

ROOT = Path(__file__).resolve().parents[1]


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def test_port_never_imports_jax_or_the_reference():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro", "flax", "optax"):
                    bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert not bad, bad
    assert len(_port_files()) > 10
    walked = {str(path.relative_to(ROOT)) for path in _port_files()}
    assert {"src/repro_torch/experiment.py",
            "src/repro_torch/checkpointing/checkpoint.py",
            "src/repro_torch/checkpointing/__init__.py",
            "src/repro_torch/data/partition.py",
            "src/repro_torch/examples/quickstart.py",
            "src/repro_torch/examples/federated_llm.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/data/synthetic.py",
            "src/repro_torch/data/pipeline.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/launch/sharding.py",
            "src/repro_torch/launch/dryrun.py",
            "src/repro_torch/models/pspec.py"} <= walked


def _fields(cls):
    return [(f.name, f.default if f.default is not dataclasses.MISSING
             else f.default_factory().__class__.__name__
             if f.default_factory is not dataclasses.MISSING else None)
            for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["FedConfig", "TrainConfig", "MeshConfig",
                                  "MobilityConfig", "HierarchyConfig",
                                  "FaultConfig", "IngestConfig",
                                  "ModelConfig", "ShapeConfig"])
def test_config_fields_and_defaults_match_reference(name):
    assert _fields(getattr(tbase, name)) == _fields(getattr(jbase, name))


@pytest.mark.parametrize("name", ["MeshFedState", "AdamState"])
def test_state_fields_match_reference(name):
    """The mesh train step's state and the pytree Adam's read the same
    field names in the same order, so ``convert`` carries them across."""
    from repro.launch import steps as jsteps
    from repro.optim import AdamState as JAdamState
    port = {"MeshFedState": steps.MeshFedState, "AdamState": AdamState}
    ref = {"MeshFedState": jsteps.MeshFedState, "AdamState": JAdamState}
    assert port[name]._fields == ref[name]._fields


def test_run_config_and_mlp_config_match_reference():
    assert [f.name for f in dataclasses.fields(tbase.RunConfig)] == \
        [f.name for f in dataclasses.fields(jbase.RunConfig)]
    assert _fields(tmodels.MLPConfig) == _fields(jmodels.MLPConfig)


def test_vgg_config_matches_reference():
    assert _fields(tmodels.VGGConfig) == _fields(jmodels.VGGConfig)
    assert _values(tmodels.VGG_CONFIG) == _values(jmodels.VGG_CONFIG)


def _values(cfg):
    return [(f.name, getattr(cfg, f.name)) for f in dataclasses.fields(cfg)]


@pytest.mark.parametrize("arch", sorted(jregistry.ARCHS))
def test_arch_configs_match_reference_value_by_value(arch):
    mine, ref = tregistry.get_arch(arch), jregistry.get_arch(arch)
    assert _values(mine) == _values(ref)
    assert _values(tregistry.get_smoke_arch(arch)) == \
        _values(jregistry.get_smoke_arch(arch))
    assert _values(tbase.reduced(mine, layers=3, d_model=128, experts=2)) \
        == _values(jbase.reduced(ref, layers=3, d_model=128, experts=2))
    for method in ("resolved_head_dim", "blocks", "param_count",
                   "active_param_count"):
        assert getattr(mine, method)() == getattr(ref, method)()


def test_arch_registry_and_input_shapes_match_reference():
    assert list(tregistry.ARCHS) == list(jregistry.ARCHS)
    assert {k: _values(v) for k, v in tbase.INPUT_SHAPES.items()} == \
        {k: _values(v) for k, v in jbase.INPUT_SHAPES.items()}
    assert [s.is_decode for s in tbase.INPUT_SHAPES.values()] == \
        [s.is_decode for s in jbase.INPUT_SHAPES.values()]
    with pytest.raises(KeyError, match="unknown arch"):
        tregistry.get_arch("qwen9")


# ROADMAP items of model families ported after they were first refused
# here: every model entry point builds them, and no refusal names them
_PORTED_MODELS = {"item 23c"}


@pytest.mark.parametrize("arch,item", [
    ("mixtral-8x7b", "item 23c"), ("dbrx-132b", "item 23c"),
    ("zamba2-1.2b", "item 23c"),
    ("internvl2-26b", "item 23c"), ("musicgen-medium", "item 23c"),
])
def test_unported_model_families_are_refused(arch, item):
    """The MoE, hybrid, vision and audio families (ROADMAP item 23c,
    refused until it was ported) build through ``init_params``,
    ``init_decode``, ``forward`` and ``decode_step``, and ``serve.main``
    serves them, on the CPU; ``MODEL_NOT_PORTED`` is empty."""
    assert item in _PORTED_MODELS and registry.MODEL_NOT_PORTED == {}
    cfg = tregistry.get_smoke_arch(arch)
    params = transformer.init_params(cfg, device="cpu")
    batch = {"tokens": torch.zeros((1, 16), dtype=torch.int32)}
    if cfg.modality == "vision":
        batch["embeds"] = torch.zeros((1, cfg.num_patches, cfg.d_model))
    logits, aux = transformer.forward(params, cfg, batch)
    assert tuple(logits.shape) == (1, 16, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert (float(aux) > 0.0) == bool(cfg.num_experts)
    state = transformer.init_decode(cfg, 1, 4, device="cpu")
    step, state = transformer.decode_step(params, cfg, state,
                                          batch["tokens"][:, 0])
    assert tuple(step.shape) == (1, cfg.vocab_size) and int(state.pos) == 1
    out = serve.main(["--arch", arch, "--batch", "1", "--prompt-len", "2",
                      "--gen", "1", "--device", "cpu"])
    assert out.shape == (1, 1)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-8b",
                                  "codeqwen1.5-7b"])
def test_dense_families_build(arch):
    cfg = tregistry.get_smoke_arch(arch)
    params = transformer.init_params(cfg, device="cpu")
    assert params["layers"]["mix"]["wq"].shape[0] == cfg.num_layers
    logits, _ = transformer.forward(params, cfg, {"tokens": torch.zeros(
        (1, 4), dtype=torch.int32)})
    assert tuple(logits.shape) == (1, 4, cfg.vocab_size)


def test_ssm_family_builds_and_serves():
    """rwkv6-7b (ROADMAP item 23b, ported): every model entry point builds
    it, and ``serve.main`` runs it, on the CPU; no refusal names 23b."""
    cfg = tregistry.get_smoke_arch("rwkv6-7b")
    params = transformer.init_params(cfg, device="cpu")
    assert params["layers"]["mix"]["wr"].shape[0] == cfg.num_layers
    tokens = torch.zeros((1, 16), dtype=torch.int32)
    logits, _ = transformer.forward(params, cfg, {"tokens": tokens})
    assert tuple(logits.shape) == (1, 16, cfg.vocab_size)
    state = transformer.init_decode(cfg, 1, 4, device="cpu")
    assert tuple(state.states.s.shape) == (cfg.num_layers, 1, 4, 64, 64)
    step, _ = transformer.decode_step(params, cfg, state, tokens[:, 0])
    assert tuple(step.shape) == (1, cfg.vocab_size)
    out = serve.main(["--arch", "rwkv6-7b", "--batch", "1", "--prompt-len",
                      "2", "--gen", "1", "--device", "cpu"])
    assert out.shape == (1, 1)
    assert not any("item 23b" in v
                   for v in registry.MODEL_NOT_PORTED.values())


def _loss():
    return simple.make_mlp_loss(MLP_CONFIG)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cdfl.build_trainer(_loss(), tbase.FedConfig(), tbase.TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simple.mlp_init(torch.Generator(), MLP_CONFIG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simple.vgg_init(torch.Generator(), tmodels.VGG_CONFIG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        experiment.Experiment.from_parts(_loss(), lambda g: {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.params_from_numpy({"w": np.zeros((2, 3), np.float32)})
    cfg = tregistry.get_smoke_arch("qwen3-1.7b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer.init_decode(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.transformer_params_from_numpy(
            {"embed": {"table": np.zeros((4, 2), np.float32)}})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--batch", "1", "--prompt-len", "2", "--gen", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.mesh_state_from_numpy(steps.MeshFedState(
            {"w": np.zeros((2, 3), np.float32)},
            AdamState(np.zeros(2, np.int32),
                      {"w": np.zeros((2, 3), np.float32)},
                      {"w": np.zeros((2, 3), np.float32)}),
            np.ones(2, np.float32)))
    assert serve.main(["--batch", "1", "--prompt-len", "2", "--gen", "1",
                       "--device", "cpu"]).shape == (1, 1)
    tr = cdfl.build_trainer(_loss(), tbase.FedConfig(), tbase.TrainConfig(),
                            device="cpu")
    assert tr.device == torch.device("cpu")


# ROADMAP items ported after their options were first refused here: a
# config naming them now builds, and NOT_PORTED no longer lists them
_PORTED = {"item 14", "item 16", "item 19", "item 20"}
_CRASH = tbase.FaultConfig(kinds=("crash",), crash_rate=0.2)


@pytest.mark.parametrize("kw,item", [
    ({"algorithm": "dpsgd"}, "item 14"),
    ({"algorithm": "cdfa_m"}, "item 14"),
    ({"transport": "ring"}, "item 20"),
    ({"transport": "gossip"}, "item 20"),
    ({"mixing_format": "sparse", "transport": "gossip", "num_nodes": 16},
     "item 20"),
    ({"mixing_format": "hierarchical", "algorithm": "dpsgd"}, "item 14"),
    ({"faults": _CRASH, "mixing_format": "sparse", "num_nodes": 16},
     "item 16"),
    ({"faults": _CRASH}, "item 16"),
    ({"robust": "median"}, "item 16"),
    ({"ingest": tbase.IngestConfig(scenario="duplicate_heavy")}, "item 19"),
])
def test_unported_options_are_refused(kw, item):
    fed = tbase.FedConfig(**kw)
    listed = any(v.startswith(f"ROADMAP queue A {item}")
                 for v in registry.NOT_PORTED.values())
    if item in _PORTED:
        tr = cdfl.build_trainer(_loss(), fed, tbase.TrainConfig(),
                                device="cpu")
        assert tr.device == torch.device("cpu")
        assert not listed
        return
    with pytest.raises(NotImplementedError, match=item):
        cdfl.build_trainer(_loss(), fed, tbase.TrainConfig(), device="cpu")
    assert listed


def test_unknown_names_fail_at_construction():
    with pytest.raises(ValueError, match="unknown algorithm"):
        tbase.FedConfig(algorithm="nope")
    with pytest.raises(ValueError, match="unknown wire codec"):
        tbase.FedConfig(wire_dtype="int8")
    with pytest.raises(ValueError, match="unknown mixing_format"):
        tbase.FedConfig(mixing_format="banded")


def test_fedavg_rejects_transport_settings():
    fed = tbase.FedConfig(algorithm="fedavg", wire_dtype="bf16")
    with pytest.raises(ValueError, match="does not use the consensus"):
        cdfl.build_trainer(_loss(), fed, tbase.TrainConfig(), device="cpu")


def test_data_copies_produce_identical_arrays():
    nodes_j = [jredundancy.inject_duplicates(
        jsynthetic.synthetic_mnist(seed=i, n=50, noise=2.0,
                                   classes=[1, 3] if i else None),
        0.4 + 0.2 * i, seed=i) for i in range(3)]
    nodes_t = [tredundancy.inject_duplicates(
        tsynthetic.synthetic_mnist(seed=i, n=50, noise=2.0,
                                   classes=[1, 3] if i else None),
        0.4 + 0.2 * i, seed=i) for i in range(3)]
    for a, b in zip(nodes_j, nodes_t):
        for field in ("x", "y", "features"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))
        assert jredundancy.true_distinct_count(a.features) == \
            tredundancy.true_distinct_count(b.features)
    # unequal sizes: node_items pads by cycling
    nodes_j[1] = nodes_j[1]._replace(features=nodes_j[1].features[:17])
    nodes_t[1] = nodes_t[1]._replace(features=nodes_t[1].features[:17])
    bj = jpipeline.FederatedBatcher(nodes_j, 8, 3, seed=5)
    bt = tpipeline.FederatedBatcher(nodes_t, 8, 3, seed=5)
    np.testing.assert_array_equal(bt.node_items(), bj.node_items())
    assert bt.node_items().dtype == np.int32
