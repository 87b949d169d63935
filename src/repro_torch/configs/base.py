"""Configuration dataclasses of the port.

``FedConfig``, ``MobilityConfig``, ``HierarchyConfig``, ``TrainConfig``,
``MeshConfig``, ``RunConfig`` and ``FaultConfig`` keep every field name
and default of the JAX package's configs, so a config reads the same in
both. The sub-config the port does not run yet (ingest) is kept as a
``FedConfig`` field, and ``build_trainer`` refuses a config that sets
it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

from repro_torch.configs.paper_models import MLPConfig


@dataclass(frozen=True)
class FedConfig:
    """C-DFL hyperparameters (paper Alg. 2 / eqs. 5-8)."""

    num_nodes: int = 4               # paper: 4 base stations
    topology: str = "ring"           # ring | full | chain | erdos
    gamma: float = 0.5               # consensus step size, in (0, 1/grad)
    mixing: str = "cnd"              # cnd | uniform | metropolis | datasize
    local_steps: int = 1             # local optimizer steps per round
    # CND sketch
    cnd_bits: int = 8_192            # bitmap size m (bits)
    cnd_hashes: int = 3              # paper uses 3 hash functions
    cnd_estimator: str = "paper_mean"  # paper_mean | linear_counting
    sig_bits: int = 64               # simhash signature width
    # a registered repro_torch.registry.algorithms name
    algorithm: str = "cdfl"
    cdfa_fraction: float = 1.0       # C-DFA(M): fraction of layers mixed
    mixing_format: str = "dense"     # dense | sparse | hierarchical
    degree: int = 8                  # sparse top-D neighbor cap
    hierarchy: Optional[Any] = None
    transport: str = "dense"         # registered transport plugin name
    wire_dtype: str = "f32"          # registered wire codec plugin name
    staleness: int = 0               # gossip bounded delay (0 = synchronous)
    # The JAX package skips a pure-cast wire roundtrip on its CPU backend
    # unless this is set. The port always casts, as the card's kernel
    # reads the wire at its own dtype; the field is kept for parity.
    simulate_wire: bool = False
    mobility: Optional[Any] = None
    faults: Optional[Any] = None
    robust: Optional[str] = None
    trim: int = 1                    # values trimmed per tail (trimmed_mean)
    ingest: Optional[Any] = None

    def __post_init__(self):
        from repro_torch.registry import validate_fed_config
        validate_fed_config(self)


@dataclass(frozen=True)
class MobilityConfig:
    """Vehicular mobility scenario: per-round radio-range topologies
    (:mod:`repro_torch.mobility`). ``kind="static"`` disables mobility
    (identical to ``FedConfig(mobility=None)``)."""

    kind: str = "static"         # "static" or a registered mobility trace
    radio_range: float = 250.0   # V2V radio range (m)
    speed: float = 20.0          # mean vehicle speed (m/s)
    speed_jitter: float = 0.3    # fractional per-vehicle speed spread
    area: float = 1000.0         # simulation square side / road length (m)
    dt: float = 1.0              # simulated seconds between rounds
    seed: int = 0                # trace RNG seed (deterministic)
    link_quality: str = "binary"  # binary | quadratic distance weighting
    min_quality: float = 0.05    # weighted links below this are dropped

    def __post_init__(self):
        from repro_torch.registry import validate_mobility_config
        validate_mobility_config(self)


@dataclass(frozen=True)
class FaultConfig:
    """Fault-injection scenario: per-round link/node/wire failures.

    ``kinds`` selects registered fault models (:mod:`repro_torch.faults.
    models`); each compiles on the host into per-round schedules that
    ``run_rounds`` reads one round at a time. All schedules are
    deterministic in ``seed`` and independent of segmentation (resuming at
    round r replays the same faults as an unbroken run).
    """

    kinds: Tuple[str, ...] = ()      # registered fault model names
    seed: int = 0                    # fault RNG seed (decorrelated per kind)
    # --- link_drop: i.i.d. undirected link erasures --------------------------
    drop_rate: float = 0.1           # per-link per-round drop probability
    # --- crash: per-node crash/recover Markov schedule -----------------------
    crash_rate: float = 0.05         # P(alive -> crashed) per round
    recover_rate: float = 0.3        # P(crashed -> alive) per round
    # --- corrupt: wire payload corruption ------------------------------------
    corrupt_rate: float = 0.05       # per-node per-round corruption prob
    corrupt_mode: str = "nan"        # nan | inf | bitflip
    # --- straggle: stale-buffer replay ---------------------------------------
    straggle_rate: float = 0.1       # per-node per-round stale-send prob
    # --- byzantine: adversarial senders --------------------------------------
    byzantine: Tuple[int, ...] = ()  # attacker node indices
    byzantine_mode: str = "sign_flip"  # sign_flip | scale
    byzantine_scale: float = 10.0    # wire multiplier for mode="scale"
    # wire guard: quarantine payloads with |value| above this (catches
    # bit-flip noise that stays finite); 0 disables the magnitude check
    guard_threshold: float = 1e12

    def __post_init__(self):
        from repro_torch.registry import validate_fault_config
        validate_fault_config(self)
        if self.corrupt_mode not in ("nan", "inf", "bitflip"):
            raise ValueError(f"unknown corrupt_mode {self.corrupt_mode!r} "
                             f"(choose from nan | inf | bitflip)")
        if self.byzantine_mode not in ("sign_flip", "scale"):
            raise ValueError(f"unknown byzantine_mode {self.byzantine_mode!r} "
                             f"(choose from sign_flip | scale)")
        for name in ("drop_rate", "crash_rate", "recover_rate",
                     "corrupt_rate", "straggle_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if any(b < 0 for b in self.byzantine):
            raise ValueError(f"byzantine node indices must be >= 0, "
                             f"got {self.byzantine}")

    @property
    def active(self) -> bool:
        """Whether any fault model is selected at all. Zero-rate kinds are
        detected by :func:`repro_torch.faults.models.config_active`, so an
        inactive config takes exactly the fault-free trainer path."""
        return bool(self.kinds)


@dataclass(frozen=True)
class HierarchyConfig:
    """Hierarchical cluster consensus knobs (:mod:`repro_torch.hierarchy`),
    selected by ``FedConfig(mixing_format="hierarchical")``."""

    max_cluster_size: int = 16       # proximity-split cap per cluster
    leader_policy: str = "degree"    # registered leader_policies name
    inter_degree: int = 4            # leader tier: top-D adjacent clusters
    hysteresis: bool = True          # sticky membership across rounds
    # intra-tier mixing rule; None -> FedConfig.mixing
    intra_rule: Optional[str] = None
    # extra intra passes on rounds where clusters re-merge (post-
    # partition consensus burst; 0 disables)
    remerge_burst: int = 1

    def __post_init__(self):
        from repro_torch.registry import validate_hierarchy_config
        validate_hierarchy_config(self)


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout. fed*dp*tp (*pods) must equal device count."""

    fed: int = 4
    dp: int = 4
    tp: int = 16
    pods: int = 1

    @property
    def devices(self) -> int:
        return self.pods * self.fed * self.dp * self.tp


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4      # paper MLP setting
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-7                # paper's delta
    weight_decay: float = 0.0
    grad_clip: float = 0.0
    batch_size: int = 32             # per-node minibatch (paper MLP)
    rounds: int = 100
    seed: int = 0
    remat: str = "none"              # none | full | selective
    param_dtype: str = "float32"


@dataclass(frozen=True)
class RunConfig:
    model: MLPConfig
    fed: FedConfig = field(default_factory=FedConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)
