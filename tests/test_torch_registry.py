"""The port's plugin registries (``repro_torch.registry``) keep the JAX
package's ``Registry``/``RegistryView`` API: the cases of
``tests/test_registry.py`` that touch it, run on the port's registries —
registration in both forms, a duplicate refused unless ``overwrite``,
``unregister``, ``validate``, the listing ``ValueError``, ``in``,
iteration, ``len``, ``repr`` and live views with a transform; every
built-in registry holds the reference's names; a plugin registered at run
time validates in a config and dispatches, and is unregistered on the way
out."""
import numpy as np
import pytest

from repro import registry as jregistry
from repro.registry import Registry as JRegistry
from repro_torch import registry
from repro_torch.configs.base import FedConfig, MobilityConfig
from repro_torch.registry import Registry

REGISTRIES = ("transports", "wire_codecs", "mixing_policies",
              "mobility_traces", "leader_policies", "fault_models",
              "robust_rules", "algorithms", "redundancy_scenarios")


def test_register_get_and_decorator_forms():
    reg = Registry("widget")
    assert reg.register("a", 1) == 1

    @reg.register("b")
    def plug():
        return 2

    assert reg.get("a") == 1
    assert reg.get("b") is plug
    assert reg.names() == ("a", "b")
    assert "a" in reg and "zzz" not in reg
    assert list(reg) == ["a", "b"] and len(reg) == 2


def test_duplicate_registration_rejected_unless_overwrite():
    reg = Registry("widget")
    reg.register("a", 1)
    with pytest.raises(ValueError, match="already registered"):
        reg.register("a", 2)
    with pytest.raises(ValueError, match="overwrite=True"):
        reg.register("a")(lambda: 2)
    reg.register("a", 2, overwrite=True)
    assert reg.get("a") == 2

    @reg.register("a", overwrite=True)
    def replaced():
        return 3

    assert reg.get("a") is replaced
    with pytest.raises(ValueError, match="non-empty string"):
        reg.register("", 1)


def test_unregister_validate_and_the_listing_error():
    reg = Registry("widget")
    reg.register("alpha", 1)
    reg.register("beta", 2)
    with pytest.raises(ValueError, match="alpha, beta"):
        reg.get("gamma")
    with pytest.raises(ValueError, match=r"unknown widget 'gamma' "
                                         r"\(registered: alpha, beta\)"):
        reg.validate("gamma")
    assert reg.validate("beta") == "beta"
    reg.unregister("alpha")
    reg.unregister("never-there")              # a missing name: no error
    assert reg.names() == ("beta",) and "alpha" not in reg
    reg.unregister("beta")
    with pytest.raises(ValueError, match="registered: <none>"):
        reg.get("beta")


def test_repr_matches_the_reference():
    reg, jreg = Registry("widget"), JRegistry("widget")
    for r in (reg, jreg):
        r.register("b", 1)
        r.register("a", 2)
    assert repr(reg) == repr(jreg) == "Registry('widget': ['a', 'b'])"
    assert repr(reg.view()) == repr(jreg.view()) == \
        "RegistryView(Registry('widget': ['a', 'b']))"


def test_view_is_live_mapping():
    reg = Registry("widget")
    view = reg.view(lambda v: v * 10)
    reg.register("a", 1)
    assert dict(view) == {"a": 10}
    reg.register("b", 2)                  # registered AFTER view creation
    assert sorted(view) == ["a", "b"]
    assert view["b"] == 20
    assert len(view) == 2
    assert "a" in view and "c" not in view
    with pytest.raises(ValueError, match="registered: a, b"):
        view["c"]
    plain = reg.view()
    assert plain["a"] == 1 and list(plain) == ["a", "b"]


@pytest.mark.parametrize("name", REGISTRIES)
def test_builtin_registries_hold_the_reference_names(name):
    registry.ensure_plugins()
    jregistry.ensure_plugins()
    port, ref = getattr(registry, name), getattr(jregistry, name)
    assert port.names() == ref.names()
    assert port.kind == ref.kind
    assert len(port) == len(ref) and list(port) == list(ref)


def test_algorithm_specs_carry_mixing_and_transport_flags():
    registry.ensure_plugins()
    jregistry.ensure_plugins()
    for name in registry.algorithms:
        spec, jspec = registry.algorithms.get(name), jregistry.algorithms.get(
            name)
        assert (spec.name, spec.mixing, spec.uses_transport) == \
            (jspec.name, jspec.mixing, jspec.uses_transport)
        assert callable(spec.make)


@pytest.mark.parametrize("kw", [
    {"transport": "carrier-pigeon"},
    {"wire_dtype": "fp8"},
    {"mixing": "psychic"},
    {"algorithm": "sgdx"},
], ids=["transport", "wire_dtype", "mixing", "algorithm"])
def test_fed_config_validates_plugin_names_at_construction(kw):
    with pytest.raises(ValueError, match="registered:"):
        FedConfig(**kw)


def test_registered_plugin_becomes_config_and_dispatch_valid():
    """One decorator = the name works everywhere: config validation and
    trace dispatch; unregistered, it is refused again."""
    from repro_torch.mobility import traces

    @registry.mobility_traces.register("teleport")
    def teleport_trace(rounds, k, *, area=1000.0, seed=0, **kw):
        rng = np.random.default_rng(seed)
        return (area * rng.random((rounds, k, 2))).astype(np.float32)

    try:
        mob = MobilityConfig(kind="teleport")            # validates now
        pos = traces.trace("teleport", 5, 3, seed=1)
        assert pos.shape == (5, 3, 2)
        assert "teleport" in registry.mobility_traces
        assert mob.kind == "teleport"
    finally:
        registry.mobility_traces.unregister("teleport")
    with pytest.raises(ValueError):
        MobilityConfig(kind="teleport")
    assert "teleport" not in registry.mobility_traces
