"""Plugin registries of the port: every user-selectable scheme family is a
named plugin in a :class:`Registry` rather than a string branched on in a
caller.

* :data:`transports`      — how the flat ``(K, P)`` buffer moves
  (``fed -> Transport`` factories, :mod:`repro_torch.core.transport`);
* :data:`wire_codecs`     — the buffer's representation on the wire;
* :data:`mixing_policies` — eq. 6 weight rules
  (:mod:`repro_torch.core.topology`);
* :data:`mobility_traces` — kinematic trace generators
  (:mod:`repro_torch.mobility.traces`);
* :data:`leader_policies` — cluster-leader scores
  (:mod:`repro_torch.hierarchy.leaders`);
* :data:`fault_models`    — fault injectors compiled into per-round
  schedules (:mod:`repro_torch.faults.models`);
* :data:`robust_rules`    — Byzantine-robust aggregation rules replacing
  the eq. 5 mix (:mod:`repro_torch.faults.robust`);
* :data:`algorithms`      — trainer-level schemes
  (:class:`AlgorithmSpec`, registered by :mod:`repro_torch.core.baselines`);
* :data:`redundancy_scenarios` — data-redundancy generators compiled into
  per-node item streams on the ingest path
  (:mod:`repro_torch.ingest.scenarios`).

Every ``FedConfig`` option of the JAX package is ported, so
:data:`NOT_PORTED` is empty. So is its model-side twin,
:data:`MODEL_NOT_PORTED`: ``models/transformer.py`` builds every model
family, block kind and modality of ``ModelConfig``.
:func:`check_model_ported` stays as the mechanism that would refuse one,
naming the ROADMAP item that ports it.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any, Callable, Iterator, Optional


class Registry:
    """Name -> plugin mapping with decorator registration; a lookup miss
    lists the registered names."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: dict[str, Any] = {}

    def register(self, name: str, obj: Any = None, *,
                 overwrite: bool = False):
        """``register("x", obj)`` or the ``@register("x")`` decorator; a
        name already registered is refused unless ``overwrite``."""
        if obj is None:
            def deco(fn):
                self._add(name, fn, overwrite)
                return fn
            return deco
        self._add(name, obj, overwrite)
        return obj

    def _add(self, name: str, obj: Any, overwrite: bool) -> None:
        if not isinstance(name, str) or not name:
            raise ValueError(f"{self.kind} plugin name must be a non-empty "
                             f"string, got {name!r}")
        if name in self._entries and not overwrite:
            raise ValueError(
                f"{self.kind} {name!r} already registered "
                f"(pass overwrite=True to replace it)")
        self._entries[name] = obj

    def unregister(self, name: str) -> None:
        self._entries.pop(name, None)

    def get(self, name: str) -> Any:
        try:
            return self._entries[name]
        except KeyError:
            raise ValueError(
                f"unknown {self.kind} {name!r} "
                f"(registered: {', '.join(self.names()) or '<none>'})"
            ) from None

    def validate(self, name: str) -> str:
        """Raise the listing ValueError unless ``name`` is registered."""
        self.get(name)
        return name

    def names(self) -> tuple[str, ...]:
        return tuple(sorted(self._entries))

    def __contains__(self, name: object) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self.names())

    def __len__(self) -> int:
        return len(self._entries)

    def __repr__(self) -> str:
        return f"Registry({self.kind!r}: {list(self.names())})"

    def view(self, transform: Optional[Callable] = None) -> "RegistryView":
        """Live read-only Mapping over the registry (the reference's
        module-level views such as ``transport.TRANSPORTS``), each plugin
        passed through ``transform`` when one is given."""
        return RegistryView(self, transform)


class RegistryView(Mapping):
    """Read-only live Mapping over a :class:`Registry`: plugins registered
    after it was made show up in it."""

    def __init__(self, registry: Registry,
                 transform: Optional[Callable] = None):
        self._registry = registry
        self._transform = transform

    def __getitem__(self, name: str) -> Any:
        obj = self._registry.get(name)
        return self._transform(obj) if self._transform else obj

    def __iter__(self) -> Iterator[str]:
        return iter(self._registry)

    def __len__(self) -> int:
        return len(self._registry)

    def __contains__(self, name: object) -> bool:
        return name in self._registry

    def __repr__(self) -> str:
        return f"RegistryView({self._registry!r})"


@dataclasses.dataclass(frozen=True)
class AlgorithmSpec:
    """One trainer-level scheme: the mixing policy its exchange uses,
    whether it routes through a transport, and its trainer constructor
    ``(loss_fn, fed, train, **kw) -> Trainer``."""

    name: str
    mixing: str
    uses_transport: bool
    make: Callable


transports = Registry("transport")
wire_codecs = Registry("wire codec")
mixing_policies = Registry("mixing policy")
mobility_traces = Registry("mobility trace")
leader_policies = Registry("leader policy")
fault_models = Registry("fault model")
robust_rules = Registry("robust aggregation rule")
algorithms = Registry("algorithm")
redundancy_scenarios = Registry("redundancy scenario")

# (config field, value) -> the ROADMAP item that ports it: empty, every
# FedConfig option of the JAX package is ported
NOT_PORTED: dict = {}

# (ModelConfig field, value) -> the ROADMAP item that ports it: empty, the
# transformer builds every family, block kind and modality of the JAX
# package (dense, moe, ssm, hybrid, vlm, audio)
MODEL_NOT_PORTED: dict = {}


def check_model_ported(cfg) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for a
    ``ModelConfig`` the port's transformer does not build yet."""
    keys = [("family", cfg.family), ("modality", cfg.modality)]
    keys += [("block", kind) for kind in dict.fromkeys(cfg.blocks())]
    if cfg.num_experts:
        keys.append(("num_experts", None))
    for key in keys:
        if key in MODEL_NOT_PORTED:
            raise NotImplementedError(
                f"{cfg.name}: ModelConfig.{key[0]}"
                f"{'' if key[1] is None else '=' + repr(key[1])} is not "
                f"ported to repro_torch yet: {MODEL_NOT_PORTED[key]}")


_loaded = False


def ensure_plugins() -> None:
    """Import the built-in plugin modules (idempotent)."""
    global _loaded
    if _loaded:
        return
    import repro_torch.core.topology    # noqa: F401  (mixing policies)
    import repro_torch.core.transport   # noqa: F401  (transports, codecs)
    import repro_torch.mobility.traces  # noqa: F401  (mobility traces)
    import repro_torch.faults.models    # noqa: F401  (fault models)
    import repro_torch.faults.robust    # noqa: F401  (robust rules)
    import repro_torch.hierarchy.leaders  # noqa: F401  (leader policies)
    import repro_torch.ingest.scenarios  # noqa: F401  (redundancy scenarios)
    import repro_torch.ingest.weighting  # noqa: F401  ("redundancy" policy)
    import repro_torch.core.baselines   # noqa: F401  (algorithms)
    _loaded = True


def validate_fed_config(fed) -> None:
    """Every plugin name on a ``FedConfig`` must be registered."""
    ensure_plugins()
    transports.get(fed.transport)
    wire_codecs.get(fed.wire_dtype)
    mixing_policies.get(fed.mixing)
    algorithms.get(fed.algorithm)
    if fed.robust is not None:
        robust_rules.get(fed.robust)
    fmt = fed.mixing_format
    if fmt not in ("dense", "sparse", "hierarchical"):
        raise ValueError(f"unknown mixing_format {fmt!r} "
                         f"(choose from dense | sparse | hierarchical)")
    if fed.hierarchy is not None and fmt != "hierarchical":
        raise ValueError(
            "FedConfig.hierarchy is set but mixing_format is "
            f"{fmt!r} — hierarchy knobs only apply to "
            "mixing_format='hierarchical'")
    if fmt == "hierarchical":
        if fed.transport != "dense":
            raise ValueError(
                "mixing_format='hierarchical' requires the dense "
                "transport: the two-tier mix gathers arbitrary "
                "co-cluster and leader rows from the resident buffer "
                f"(got transport={fed.transport!r})")
        if fed.robust is not None:
            raise ValueError(
                "mixing_format='hierarchical' cannot combine with "
                "robust aggregation: robust rules rank the FULL dense "
                "neighbor column per coordinate "
                "(use mixing_format='dense')")
        if fed.algorithm in ("fedavg", "cdfa_m"):
            raise ValueError(
                f"mixing_format='hierarchical' does not apply to "
                f"algorithm={fed.algorithm!r}: fedavg has no "
                f"consensus exchange and cdfa_m mixes a dense layer "
                f"prefix (use cdfl | cfa | metropolis | dpsgd)")
    if fmt == "sparse":
        from repro_torch.core.topology import validate_degree
        validate_degree(fed.degree, fed.num_nodes)
        if fed.transport == "ring":
            raise ValueError(
                "mixing_format='sparse' needs a gather-capable transport "
                "(dense | gossip); the ring transport is physically "
                "degree-2 — its shifts ARE its topology")
        if fed.robust is not None:
            raise ValueError(
                "mixing_format='sparse' cannot combine with robust "
                "aggregation: robust rules rank the FULL dense neighbor "
                "column per coordinate (use mixing_format='dense')")


def validate_hierarchy_config(hier) -> None:
    ensure_plugins()
    leader_policies.get(hier.leader_policy)
    if hier.max_cluster_size < 2:
        raise ValueError(f"max_cluster_size must be >= 2, "
                         f"got {hier.max_cluster_size}")
    if hier.inter_degree < 1:
        raise ValueError(f"inter_degree must be >= 1, "
                         f"got {hier.inter_degree}")
    if hier.remerge_burst < 0:
        raise ValueError(f"remerge_burst must be >= 0, "
                         f"got {hier.remerge_burst}")
    if hier.intra_rule is not None:
        mixing_policies.get(hier.intra_rule)


def validate_fault_config(faults) -> None:
    ensure_plugins()
    for kind in faults.kinds:
        fault_models.get(kind)


def validate_ingest_config(ing) -> None:
    ensure_plugins()
    if ing.scenario != "none":
        redundancy_scenarios.get(ing.scenario)


def validate_mobility_config(mob) -> None:
    ensure_plugins()
    if mob.kind != "static":
        mobility_traces.get(mob.kind)
    from repro_torch.mobility.links import LINK_QUALITIES
    if mob.link_quality not in LINK_QUALITIES:
        raise ValueError(f"unknown link_quality {mob.link_quality!r} "
                         f"(choose from {LINK_QUALITIES})")
