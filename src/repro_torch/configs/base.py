"""Configuration dataclasses of the port.

``ModelConfig``, ``ShapeConfig``, ``FedConfig``, ``MobilityConfig``,
``HierarchyConfig``, ``TrainConfig``, ``MeshConfig``, ``RunConfig`` and
``FaultConfig`` keep every field name and default of the JAX package's
configs, and ``INPUT_SHAPES`` and ``reduced`` its values, so a config
reads the same in both. The sub-config the port does not run yet (ingest) is kept as a
``FedConfig`` field, and ``build_trainer`` refuses a config that sets
it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

from repro_torch.configs.paper_models import MLPConfig


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (one instance per assigned arch)."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                   # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    # --- attention options -------------------------------------------------
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None   # native SWA (e.g. mixtral)
    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- SSM / hybrid -------------------------------------------------------
    ssm_state: int = 0               # mamba2 state dim
    ssm_heads: int = 0               # rwkv / mamba head count (0 -> num_heads)
    # per-layer block kinds; empty -> homogeneous from family
    block_pattern: Tuple[str, ...] = ()    # entries: attn|mamba|rwkv|shared_attn
    # --- modality frontends (stubs per spec) --------------------------------
    modality: str = "text"           # text | vision | audio
    num_patches: int = 1024          # vlm: patch embeddings per image
    # --- misc ----------------------------------------------------------------
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "swiglu"              # swiglu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""                 # citation

    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    def blocks(self) -> Tuple[str, ...]:
        if self.block_pattern:
            assert len(self.block_pattern) == self.num_layers
            return self.block_pattern
        kind = {"ssm": "rwkv"}.get(self.family, "attn")
        return tuple(kind for _ in range(self.num_layers))

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim()
        total = v * d                                   # embed
        if not self.tie_embeddings:
            total += v * d                              # lm head
        for kind in self.blocks():
            if kind in ("attn", "shared_attn"):
                q = d * self.num_heads * hd
                kv = 2 * d * self.num_kv_heads * hd
                o = self.num_heads * hd * d
                total += q + kv + o
            elif kind == "rwkv":
                # r,k,v,g,o projections + data-dependent decay lora
                total += 5 * d * d + 2 * d * 64
            elif kind == "mamba":
                d_inner = 2 * d
                total += d * (2 * d_inner) + d_inner * d    # in/out proj
                total += d_inner * (2 * self.ssm_state)      # B,C
                total += d_inner                              # dt, A diag
            if self.num_experts:
                total += self.num_experts * 3 * d * f       # swiglu experts
                total += d * self.num_experts               # router
            else:
                mult = 3 if self.act == "swiglu" else 2
                total += mult * d * f
            total += 2 * d                                   # norms
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if not self.num_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_experts = self.num_layers * self.num_experts * 3 * d * f
        active_experts = self.num_layers * self.experts_per_token * 3 * d * f
        return self.param_count() - dense_experts + active_experts


@dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    mode: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.mode == "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


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
    ingest: Optional["IngestConfig"] = None

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
class IngestConfig:
    """Streaming-redundancy ingest scenario and its sketch/weighting knobs
    (:mod:`repro_torch.ingest`).

    ``scenario`` selects a registered redundancy generator that compiles on
    the host into per-node item streams, once per run. Per-node rolling
    count-min and HyperLogLog sketches then estimate effective cardinality
    and per-item multiplicity on the stream, one round at a time, and
    ``weighting`` selects what the estimates drive: redundancy-aware mixing
    weights, duplicate-corrected sampling, both, or telemetry only.
    ``scenario="none"`` disables the subsystem (identical to
    ``FedConfig(ingest=None)``).
    """

    scenario: str = "none"           # registered redundancy scenario name
    # nodes the scenario rewrites; () -> the scenario's default set
    affected: Tuple[int, ...] = ()
    duplicate_fraction: float = 0.8  # duplicate_heavy: copied-slot fraction
    overlap_window: int = 32         # sensor_overlap: shared sliding window
    zipf_alpha: float = 1.1          # skewed_multiset: frequency exponent
    seed: int = 0                    # scenario RNG seed (per-name decorrelated)
    # --- streaming sketch shapes ---------------------------------------------
    cm_hashes: int = 4               # count-min hash rows H
    cm_width: int = 1024             # count-min buckets per row W
    hll_registers: int = 256         # HLL registers M (power of two >= 16)
    decay: float = 1.0               # per-round count-min aging (1 = off)
    # --- what the estimates drive --------------------------------------------
    weighting: str = "mixing"        # none | mixing | sampling | both
    # mixing reweight dead-band: eta is rescaled only when the max/min
    # spread of the per-node distinct estimates exceeds this
    spread_gate: float = 1.5
    # --- drift detection on the rolling sketch -------------------------------
    # a node whose sampled slots are mostly absent from its decayed
    # count-min has its eta columns discounted ("reweight") or zeroed
    # ("reset") for that round; 0 disables
    drift_threshold: float = 0.0     # novel-slot fraction trigger (0 = off)
    drift_mode: str = "reweight"     # reweight | reset
    drift_discount: float = 0.5      # column scale under "reweight"

    def __post_init__(self):
        from repro_torch.registry import validate_ingest_config
        validate_ingest_config(self)
        if self.weighting not in ("none", "mixing", "sampling", "both"):
            raise ValueError(f"unknown weighting {self.weighting!r} "
                             f"(choose from none | mixing | sampling | "
                             f"both)")
        if not 0.0 <= self.duplicate_fraction <= 1.0:
            raise ValueError(f"duplicate_fraction must be in [0, 1], "
                             f"got {self.duplicate_fraction}")
        if self.cm_hashes < 1 or self.cm_width < 2:
            raise ValueError(f"count-min needs >= 1 hash row and >= 2 "
                             f"buckets, got H={self.cm_hashes} "
                             f"W={self.cm_width}")
        m = self.hll_registers
        if m < 16 or m & (m - 1):
            raise ValueError(f"hll_registers must be a power of two "
                             f">= 16, got {m}")
        if not 0.0 < self.decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {self.decay}")
        if self.spread_gate < 1.0:
            raise ValueError(f"spread_gate must be >= 1, "
                             f"got {self.spread_gate}")
        if self.overlap_window < 1:
            raise ValueError(f"overlap_window must be >= 1, "
                             f"got {self.overlap_window}")
        if self.zipf_alpha <= 0.0:
            raise ValueError(f"zipf_alpha must be > 0, "
                             f"got {self.zipf_alpha}")
        if not 0.0 <= self.drift_threshold <= 1.0:
            raise ValueError(f"drift_threshold must be in [0, 1], "
                             f"got {self.drift_threshold}")
        if self.drift_mode not in ("reweight", "reset"):
            raise ValueError(f"unknown drift_mode {self.drift_mode!r} "
                             f"(choose from reweight | reset)")
        if not 0.0 <= self.drift_discount <= 1.0:
            raise ValueError(f"drift_discount must be in [0, 1], "
                             f"got {self.drift_discount}")
        if self.drift_threshold > 0.0 and self.decay >= 1.0:
            raise ValueError(
                "drift detection needs a DECAYED count-min (decay < 1): "
                "with decay=1 old regimes never age out, so every "
                "sampled slot stays 'seen' and the novelty signal is "
                "identically zero")
        if any(i < 0 for i in self.affected):
            raise ValueError(f"affected node indices must be >= 0, "
                             f"got {self.affected}")

    @property
    def active(self) -> bool:
        """Whether a redundancy scenario is selected at all."""
        return self.scenario != "none"

    @property
    def reweight_mixing(self) -> bool:
        return self.weighting in ("mixing", "both")

    @property
    def correct_sampling(self) -> bool:
        return self.weighting in ("sampling", "both")

    @property
    def drift_on(self) -> bool:
        return self.drift_threshold > 0.0


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


def reduced(model: ModelConfig, *, layers: int = 2, d_model: int = 256,
            d_ff: int = 512, vocab: int = 512, experts: int = 0) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (spec: 2 layers,
    d_model<=512, <=4 experts)."""
    heads = max(1, min(model.num_heads, d_model // 64)) if model.num_heads else 0
    kv = max(1, min(model.num_kv_heads, heads)) if heads else 0
    n_exp = min(model.num_experts, experts or 4) if model.num_experts else 0
    top_k = min(model.experts_per_token, n_exp) if n_exp else 0
    pattern = ()
    if model.block_pattern:
        pattern = model.block_pattern[:layers]
    return dataclasses.replace(
        model,
        name=model.name + "-smoke",
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=0,
        d_ff=d_ff,
        vocab_size=vocab,
        num_experts=n_exp,
        experts_per_token=top_k,
        ssm_state=min(model.ssm_state, 16) if model.ssm_state else 0,
        block_pattern=pattern,
        sliding_window=min(model.sliding_window, 128) if model.sliding_window else None,
        num_patches=16,
        dtype="float32",
    )
