"""Roofline terms of a step on the NVIDIA H100.

    compute term    = FLOPs / peak_FLOP/s              (per device)
    memory term     = HBM bytes / HBM_bw               (per device)
    collective term = wire_bytes / link_bw             (per device)

The counterpart of the JAX package's ``repro.launch.roofline``: its
formulas, with the H100 SXM's published peaks for its constants (989
TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of HBM3, 450 GB/s each
way over NVLink). :func:`model_flops_per_device` is the analytic useful
work of a step (6*N*D train, 2*N*D inference), which the mesh train
step's lines on the card hold against its time and the bf16 peak.
:func:`parse_collectives` reads the collectives of a compiled XLA HLO
text (pure text, kept for the mesh code, ROADMAP queue A item 24).

The CONSENSUS share of the collective term is transport-aware:
:func:`transport_consensus_bytes` prices the exchange from the selected
transport's own ``wire_bytes(layout)`` (bf16 halves it), see
``Roofline.with_consensus``.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from dataclasses import replace as dataclass_replace

PEAK_FLOPS = 989e12          # dense bf16 per device (H100 SXM)
HBM_BW = 3.35e12             # bytes/s per device (HBM3)
NVLINK_BW = 450e9            # bytes/s per device, each way (NVLink 4)

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter",
                "all-to-all", "collective-permute")
_WIRE_FACTOR = {"all-reduce": 2.0}          # ring AR ~2x; others ~1x

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
# result shape(s) precede ` <opname>(`; ops may be fused names like
# `all-gather-start`; match the base op.
_OP_RE = re.compile(
    r"=\s*((?:\([^)]*\))|(?:\w+\[[\d,]*\][^ ]*))\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")


def _shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclass
class CollectiveStats:
    bytes_by_op: dict = field(default_factory=dict)
    count_by_op: dict = field(default_factory=dict)

    @property
    def wire_bytes(self) -> float:
        return sum(_WIRE_FACTOR.get(op, 1.0) * b
                   for op, b in self.bytes_by_op.items())

    @property
    def total(self) -> int:
        return sum(self.count_by_op.values())


def parse_collectives(hlo_text: str) -> CollectiveStats:
    stats = CollectiveStats()
    for m in _OP_RE.finditer(hlo_text):
        shape_txt, op = m.group(1), m.group(2)
        b = _shape_bytes(shape_txt)
        stats.bytes_by_op[op] = stats.bytes_by_op.get(op, 0) + b
        stats.count_by_op[op] = stats.count_by_op.get(op, 0) + 1
    return stats


def transport_consensus_bytes(transport, layout, adj) -> float:
    """Per-NODE per-round bytes the eq. 5 exchange puts on the wire for
    the selected transport backend.

    ``transport.wire_bytes(layout)`` is the per-link payload at the wire
    dtype (bf16 halves it; the ring transport's shifted-copy exchange
    and the dense matmul both move one payload per link); the graph's
    worst-node degree gives the link count. This replaces the dense-f32
    assumption baked into the compiled HLO's collective-permute bytes.
    """
    import numpy as np
    if hasattr(adj, "cpu"):             # a tensor, on any device
        adj = adj.cpu()
    degree = float(np.asarray(adj).sum(axis=1).max())
    return degree * transport.wire_bytes(layout)


@dataclass
class Roofline:
    flops: float                 # per device
    hbm_bytes: float             # per device
    wire_bytes: float            # per device
    collectives: CollectiveStats
    model_flops: float           # analytic useful flops per device

    def with_consensus(self, transport, layout, adj,
                       devices_per_node: int) -> "Roofline":
        """Re-price the consensus share of the collective term for the
        selected transport backend.

        The measured collective-permute bytes (the lowered dense f32
        ring roll — the only collective-permute in the fed train HLO)
        are swapped for :func:`transport_consensus_bytes` spread over
        the node's device group. Non-consensus collectives (TP
        all-reduce/all-gather) are untouched.
        """
        measured = self.collectives.bytes_by_op.get("collective-permute", 0)
        analytic = (transport_consensus_bytes(transport, layout, adj)
                    / max(devices_per_node, 1))
        return dataclass_replace(
            self, wire_bytes=self.wire_bytes - measured + analytic)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.wire_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def row(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "hlo_gflops": self.flops / 1e9,
            "hbm_gb": self.hbm_bytes / 1e9,
            "wire_gb": self.wire_bytes / 1e9,
            "useful_flops_ratio": self.useful_ratio,
            "n_collectives": self.collectives.total,
        }


def model_flops_per_device(cfg, shape, num_devices: int,
                           fed_nodes: int = 0) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train (fwd+bwd), 2*N*D inference, with
    N = active params (MoE: top-k only). D = tokens processed globally.
    Federated: every node trains its own replica -> multiply by F."""
    n_active = cfg.active_param_count()
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        total = 6.0 * n_active * tokens
    elif shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        total = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        total = 2.0 * n_active * shape.global_batch
    return total / num_devices


def format_row(name: str, r: Roofline) -> str:
    d = r.row()
    return (f"{name:42s} {d['t_compute_s']:>10.3e} {d['t_memory_s']:>10.3e} "
            f"{d['t_collective_s']:>10.3e} {d['bottleneck']:>10s} "
            f"{d['useful_flops_ratio']:>6.2f} {d['n_collectives']:>4d}")
