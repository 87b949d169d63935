#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases: the device; the build of every CUDA kernel from
``src/repro_torch/csrc``, with each library's digest (the hash of its
source and flags it is keyed on) and ptxas's registers and spills for each
instantiation of B1/B2/B8, of B10, of B5/B6 and of B7 (B5/B6 and B7 must
not spill); the
per-round mixing stacks of the K=1024 vehicular fleet (Manhattan
mobility, sparse top-8 and hierarchical), built once on the host and
timed on their own line; each kernel held
against its plain PyTorch version at the shapes of the main path, with
CUDA-event timings (B5/B6 on the fleet's own neighbor tables: B6 without
a plan at the faulted sparse exchange's shape, then staged by the
hierarchical stack's plan, held bit for bit to its walk and with a NaN
behind a zero-weight slot, each staged row with its staged rows a tile
and the plan's build time; B1/B2 also
at the K=1024 fleet's dense exchange, and held over a sweep of K, P and
unaligned views that reaches every path of their tiled kernel); the
launch floor (a one-element ``add_`` timed the same way); the
paper's C-DFL path at K=4 (cdfl), checked against the same run of the
port on the CPU; the twin of ``examples/quickstart.py``
(``repro_torch.examples.quickstart``, through ``Experiment`` and
``Session``) on the card against the CPU, and run(10) + save + resume +
run(10) against run(20) on the card, bit for bit; fedavg at K=4 against
the CPU; a K=256 bf16-wire fleet, with one round
under the profiler; the twin of ``examples/mobility_platoon.py`` (K=8,
dense format, checked against the CPU); the sparse and the hierarchical
K=1024 fleets (1 warm-up round, then 3 repeats of 5 timed rounds, one
profiled round, the exchange timed alone), each format also checked
against the CPU at K=64; then the fault and robust-mixing path: B7 held
against its plain version at K=8, 64 and 256 (median, trimmed mean with
trim 1 and 2), at K=100 with live non-finite payloads, and at K=1, 33 and
1024 (P=1,024) and the fleet's K=256 with all-live masks and a W of
random position weights, the Byzantine
platoon (K=8, one sign-flip attacker, eq. 5 against the trimmed mean,
gated on the honest nodes' accuracy), the faulted robust K=256 Manhattan
fleet (every fault kind, trimmed mean; B7 also held against its plain
version on the fleet's own mask of its first round) and the faulted
K=1024 sparse and
hierarchical fleets (link drops, crashes, bit flips, stragglers), each
with telemetry held against the compiled fault plan and checked against
the CPU at K=64 (K=8 for the platoon); the paper's remaining baselines:
B8 held against its plain version (rows 8,192 with N=8 in f32 and bf16,
and the paper MLP's (187, 128) rows with N=2), B8 driven through
``ops.consensus_mix`` on the K=4 ring's trained buffers, the
``core/consensus.py`` one-shots, dpsgd and cdfa_m (prefixes 40 and
23,860, f32 and bf16 wire) at K=4, cdfa_m on a K=256 ring (prefix
23,560), dpsgd on the K=1024 fleet's stacks (sparse and hierarchical),
each checked against the CPU, and the paper's Tables 1-4 comparison of
cdfl, cfa, cdfa_m and dpsgd through ``Experiment`` and ``EvalCallback``
over 60 rounds, MLP and VGG halves (rounds to 80% test accuracy per
station, reported, not gated; the first 3 rounds checked against the CPU,
the VGG's with TF32 switched as a process starts; one profiled VGG round;
one VGG local step against f64 within 1e-4, with its f32 guard bypassed
as a control that must miss; the VGG's run(10) + save + resume + run(10)
against run(20) bit for bit); then LLM serving: the count
of tensor-core (HGMMA) instructions in B9's library, B9 held against its
plain version (tests/test_kernels.py's sweep, windows, cross attention,
ragged lengths and rows with no live key, each in f32 and bf16; both
kernels' tile edges at every head dim; f32 and bf16 views off a 16-byte
boundary through ``ops.flash_attention``; and the path's shapes up to
qwen3's prefill of B=4 S=2048, f32 at the f32 serving path's B=4
S=128 with and without its 64-token window timed against SDPA in f32), qwen3-1.7b at full width in bf16 (4
requests of 512 prompt tokens through the prefill step, the same prompts
teacher-forced through the serve step, 16 generated tokens; prefill
logits held against the decode's) and in f32 (128 prompt tokens, with and without a
64-token window), ``serve.main`` at smoke width on the card against the
CPU (and a GQA variant), and one decode step under the profiler; then
the rwkv6 slice: B10 held against its plain version (tests/test_kernels.py's
sweep, tests/test_ssm.py's shapes from a non-zero state, every instantiation
of the kernel (head sizes 16-128 x chunks 16-64 x f32/bf16) from a state,
one chunk, decays that underflow, inputs not 16-byte aligned; and the
path's shapes: f32 S=128, bf16 S=512 and rwkv6's prefill of B=4 S=2048,
each timed), rwkv6-7b at full width in bf16 (4 requests of 512 prompt
tokens through the prefill step, once under the profiler for B10's share
of its device time, held to the plain-scan prefill with the
sequential-scan prefill as the measure of what bf16 allows, and block
by block from the same input; teacher-forced decode, 16 generated tokens,
one profiled decode step) and in f32 (128
prompt tokens through B10 and a ragged 120 through the sequential scan,
each against teacher-forced decode), and ``serve.main --arch rwkv6-7b``
at smoke width on the card against the CPU; then federated LLM training:
qwen3-1.7b at its published widths, cut to two layers, in f32 (723,003,904
params a node) on a K=2 ring through ``Experiment`` and ``Session`` (init
drawn on the card, 3 rounds of 2 local steps of 4 x 128 tokens timed
round by round, one round under the profiler, peak memory, B9 in every
training forward; one local step's loss and flat gradient with B9 in the
forward against autograd of B9's plain version), the training CLI
(``repro_torch.launch.train --quick``: qwen3 with both drivers, rwkv6-7b
through B10, ``--faults crash,corrupt`` and ``--hierarchy`` with their
``*_SMOKE ok`` verdicts, the qwen3 run's losses against the CPU's) and
the twin of ``examples/federated_llm.py`` at qwen3-100m on K=4 for 5
timed rounds and one under the profiler. Batched fleet sweeps (after the
Tables): B1 and B2 with their variant axis held against their plain
versions and, variant by variant, bit for bit against V = 1 launches
(timed against V single launches, ``torch.baddbmm`` and batched
``torch.matmul``); the paper's mobility sweep (four scenarios, cdfl and
cfa, one ``compile_batch`` each, rounds to 80%), rounds to 80% over 4
seeds for the MLP and the VGG, a K=1024 sparse Manhattan fleet over 4
seeds, a K=256 bf16 ring over gamma x seeds and a crashed K=256 ring over
2 seeds, each with 2 variants against their single Sessions, the batch
against the CPU's, its ms/round against the loop of its single runs in
turns and a profiled batched round; and the CLI's ``--sweep`` with its
``SWEEP_SMOKE ok``. Then the transports and the redundancy-aware ingest:
the ring at K=4 (the roll form, no kernel) against the CPU and against the
dense transport on the ring, and at K=256 with a bf16 wire in turns with
dense; gossip with snapshots 2 rounds old, dense at K=4 (B2), on the
K=1024 Manhattan sparse bf16 fleet (B6, in turns with the dense
transport's B5; at K=64 against the CPU) and on the crashed K=256 ring
(B2), ``staleness=0`` bit for bit the dense transport, a Session resumed
with its bf16 snapshots bit for bit, the CLI's gossip ``--sweep``; ingest
on the paper K=4 MLP (duplicate-heavy, sampling and mixing, drift; the
card's weighted indices and sketches equal to the CPU's) and on the
K=1024 sparse fleet (sensor overlap, B5), each in turns with its
ingest-free run, with the ``IngestCallback`` line. Then the model
families: B9 at each family's prefill shape (zamba2's and musicgen's G = 1
at D = 64, internvl2's G = 6 at D = 128 over 1,024 patch embeddings and
512 tokens, mixtral's 4,096-token window), f32 and bf16, against its plain
version and timed against SDPA; zamba2-1.2b, musicgen-medium and
internvl2-26b at full width and depth and mixtral-8x7b at full width and
16 of 32 layers, in bf16 (4 x 512 prompt tokens through the prefill step,
B9 in every attention layer, the MoE's dropped (token, choice) pairs at
capacity 1.25, 16 decode tokens, one profiled prefill and decode step);
the f32 gates (128-token prefill against teacher-forced decode, internvl2
at 8 and mixtral at 4 layers, mixtral at capacity 8.0, zamba2 also through
the sequential scan), bf16 against f32 on the same weights (3e-2 of max
|logit|, or twice a plain-attention control's drift where larger; mixtral
on the positions with no flipped expert at or before them) and the five
smoke arches (mixtral, dbrx, zamba2, internvl2, musicgen) through
``serve.main`` on the card against the CPU. Then the mesh train step
(``launch/steps.py::make_fed_train_step``, the reference's step for
full-size LLM training) at full width: mixtral-8x7b (1 layer),
internvl2-26b (1 layer, + 1,024 stub patch embeddings), zamba2-1.2b (30
layers), musicgen-medium (48) and rwkv6-7b (2), bf16 params with f32
moments on an F=2 ring, remat "full", 2 x 512 text tokens a node, a
learning rate warmed up over 3 timed steps and 1 profiled step (each
family's state bytes reckoned by ``fed_state_struct`` before it is
allocated, peak memory, B9/B10 launches as counted, the busy share and a
model-FLOPs share of the bf16 peak; falling losses; mixtral's router
moved); internvl2's loss and gradient with B9 in the forward against its
plain version (a bf16-vs-f32 control); each family's smoke width on F=3
nodes in f32, card against CPU; the mesh code: three dry runs
(``python -m repro_torch.launch.dryrun``, qwen3-1.7b x train_4k on one
and two pods, mixtral-8x7b x decode_32k) as subprocesses on the host's
cores, the ring helpers on one node of qwen3-1.7b over a one-rank NCCL
world against the CPU, the serving prefill and one mesh train step with
DTensor state on one-device meshes bit for bit against the plain steps.
Then the loaded libraries by digest; the kernel
table (ten kernels, B1 and B2 also with their variant axis) as one JSON
line; and the verdict as the last line. Every path
phase zeroes the kernels' launch counts before it runs and checks them
after. Exits non-zero, with no verdict, when CUDA is absent or any check
fails.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import functools
import io
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
import unittest.mock
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the CUDA-core
# f32 rate. Hopper issues INT32 at half its FP32 rate (64 against 128
# lanes per SM), so integer work is held to half the f32 rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = F32_OPS_PER_S / 2
BF16_OPS_PER_S = 989e12       # dense tensor-core bf16

P = 23_936                    # the paper MLP's lane-padded buffer width
FLEET_K = 1024                # the vehicular fleet phases
# 1 warm-up round, 3 repeats of 5 timed rounds, 1 profiled round
FLEET_ROUNDS = 17
# benchmarks/paper_tables.py MOBILITY_SCENARIOS["manhattan"]
MANHATTAN = dict(kind="manhattan", speed=10.0, radio_range=500.0,
                 area=800.0, dt=2.0, seed=0)
# examples/mobility_platoon.py
PLATOON = dict(kind="platoon", speed=25.0, speed_jitter=0.4,
               radio_range=300.0, dt=5.0, seed=3, link_quality="quadratic")
RTOL, ATOL = 1e-5, 1e-6       # f32 kernels against their plain versions
ROBUST_K = 256                # the faulted robust fleet
FAULT_ROUNDS = 5              # timed rounds of each faulted fleet
# the fault cocktail of the faulted robust fleet: every kind at once
ROBUST_FAULTS = dict(kinds=("link_drop", "crash", "corrupt", "straggle",
                            "byzantine"), drop_rate=0.1, crash_rate=0.05,
                     recover_rate=0.3, corrupt_rate=0.05, corrupt_mode="nan",
                     straggle_rate=0.1, byzantine=(3, 77, 150),
                     byzantine_mode="sign_flip", seed=0)
# the faulted K=1024 fleets: every non-adversarial kind at default rates
FLEET_FAULTS = dict(kinds=("link_drop", "crash", "corrupt", "straggle"),
                    corrupt_mode="bitflip")
# tests/test_faults.py:375, the Byzantine platoon
BYZ_PLATOON = dict(kind="platoon", speed=20.0, speed_jitter=0.3,
                   radio_range=250.0, dt=2.0, seed=0)
# benchmarks/paper_tables.py:24-32, the paper's Tables 1-4 (MLP and VGG)
TABLE_ALGS = ["cdfl", "cfa", "cdfa_m", "dpsgd"]
TABLE_RATIOS = [0.1, 0.2, 0.4, 0.8]
TABLE_NOISE = 2.5
VGG_NOISE = 1.5
TABLE_ROUNDS = 60
# LLM serving: qwen3-1.7b at full width (src/repro/configs/qwen3_1_7b.py)
SERVE_ARCH = "qwen3-1.7b"
SERVE_PARAMS = 2_031_739_904  # every leaf, q/k norms and final norm included
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 512, 16
F32_PROMPT, F32_WINDOW = 128, 64
PREFILL_S = 2048              # the prefill shape of B9's and B10's timing rows
B9_TOL = 2e-5                 # f32 B9 against its plain version
# rwkv6-7b at full width (src/repro/configs/rwkv6_7b.py)
RWKV_ARCH = "rwkv6-7b"
RWKV_PARAMS = 8_876_199_936   # every leaf: decay LoRA, bonus, norms included
RWKV_F32_PROMPT, RWKV_RAGGED = 128, 120
# the federated LLM training path: qwen3-1.7b at its published widths, two
# layers, f32, on K=2 (a K=2 ring is the single edge {0, 1})
TRAIN_ARCH = "qwen3-1.7b"
TRAIN_PARAMS = 723_003_904    # a node: every leaf, untied head included
TRAIN_K, TRAIN_LAYERS, TRAIN_ROUNDS = 2, 2, 3
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 128, 2
CLI_ROUNDS = 3                # each training CLI run at --quick
FLLM_ROUNDS = 5               # the federated_llm twin at qwen3-100m, K=4,
                              # then one profiled round
# batched fleet sweeps: benchmarks/paper_tables.py:168-184, the mobility
# study's scenarios (None: the static ring)
MOBILITY_SCENARIOS = {
    "static_ring": None,
    "platoon": dict(kind="platoon", speed=20.0, speed_jitter=0.15,
                    radio_range=250.0, dt=2.0, seed=0),
    "platoon_split": dict(kind="platoon", speed=20.0, speed_jitter=0.3,
                          radio_range=250.0, dt=2.0, seed=0),
    "manhattan": dict(MANHATTAN)}
SWEEP_SEEDS = 4               # SweepAxes(seeds=4)
SWEEP_RING_K = 256            # the dense fleet sweeps' ring
SWEEP_CHECK_ROUNDS = 3        # variants against their single Sessions
SWEEP_TOL = 1e-5              # of max |param|, batched against single
SWEEP_BLOCKS, SWEEP_TURN = 2, 3   # ABBA: blocks of 4 turns of 3 rounds
SWEEP_CRASH = dict(kinds=("crash",), seed=3)   # default rates
B10_TOL = 2e-5                # B10 against its plain version, of max |value|
# the transports and ingest phase: gossip snapshots 2 rounds old; timed
# rounds of each fleet run; the paper MLP's duplicate-heavy ingest with
# duplicate-corrected sampling, the eta reweight and drift detection on a
# decayed count-min; the fleet's sensor-overlap ingest (eta reweight)
GOSSIP_S = 2
TI_ROUNDS = 5
INGEST_K4 = dict(scenario="duplicate_heavy", weighting="both", decay=0.8,
                 drift_threshold=0.3)
INGEST_FLEET = dict(scenario="sensor_overlap")
# bf16 rwkv6-7b, each block from the same input: B10 against its plain
# version, of max |output| (two bf16 ulps at the top of a binade)
RWKV_LAYER_TOL = 2.0 ** -6
# the model families (MoE, hybrid, vision, audio): bf16 serving at full
# width, every leaf counted; mixtral cut to 16 of its 32 layers (93.4 GB
# whole does not fit the card's 80 GB), the others at full depth. The f32
# gates cut depth only where the card forces it (internvl2 8 layers,
# mixtral 4, about 24 GB)
FAMILY_SERVE = {"zamba2-1.2b": (None, 2_879_311_872),
                "musicgen-medium": (None, 1_365_543_936),
                "internvl2-26b": (None, 19_861_260_288),
                "mixtral-8x7b": (16, 23_482_470_400)}
FAMILY_F32_LAYERS = {"internvl2-26b": 8, "mixtral-8x7b": 4}
FAMILY_SMOKE = ("mixtral-8x7b", "dbrx-132b", "zamba2-1.2b", "internvl2-26b",
                "musicgen-medium")
FAMILY_BF16_TOL = 3e-2        # bf16 against f32, of max |logit| (qwen3's)
WIDE_CAPACITY = 8.0           # tests/test_models.py:65: no token dropped
# the mesh train step (launch/steps.py::make_fed_train_step) at full width:
# bf16 params, f32 moments, remat="full", a learning rate warmed up to
# MESH_LR over the steps, an F=2 ring, 2 sequences of 512
# text tokens a node (internvl2: + 1,024 stub patch embeddings), 3 timed
# steps and 1 profiled step; depth cut so that F=2 nodes' state fits the
# card: arch -> layers (None: every layer)
MESH_F, MESH_BATCH, MESH_SEQ = 2, 2, 512
MESH_STEPS, MESH_LR = 3, 1e-4
MESH_DEPTH = {"mixtral-8x7b": 1, "internvl2-26b": 1, "zamba2-1.2b": 30,
              "musicgen-medium": None, "rwkv6-7b": 2}
MESH_RATIOS = (0.4, 0.8)      # the nodes' CND distinct ratios
MESH_SMOKE_F = 3              # the smoke-width check: F=3, f32, 2 steps
MESH_SMOKE_TOL = 1e-4         # card against CPU, of max |value| a tree
MESH_LOSS_TOL = 1e-2          # internvl2 B9 forward against plain, relative
MESH_GRAD_TOL = 3e-2          # its gradient, of max |value| a leaf
# the mesh code (launch/mesh.py, sharding.py, models/pspec.py, dryrun.py
# and the ring helpers): dry runs as subprocesses (arch, shape, two pods);
# the ring helpers on one node of qwen3-1.7b at full width, 2 of 28
# layers, over a one-rank NCCL world, against the CPU; the serving prefill
# and one mesh train step on one-device meshes, against the plain steps
MESH_DRYRUNS = (("qwen3-1.7b", "train_4k", False),
                ("qwen3-1.7b", "train_4k", True),
                ("mixtral-8x7b", "decode_32k", False),
                # the combos that need each rank's own MoE groups and
                # rwkv6 rows and heads, and a batch-1 decode with 24
                # heads over 16 ranks
                ("mixtral-8x7b", "train_4k", False),
                ("rwkv6-7b", "prefill_32k", False),
                ("musicgen-medium", "long_500k", False))
DRYRUN_TIMEOUT = 600          # seconds a dry-run subprocess may take
RING_LAYERS = 2
RING_RTOL, RING_ATOL = 1e-5, 1e-6
RING_GAMMA = 0.4
MESH_STEP_ARCH = ("rwkv6-7b", 2)   # the mesh train phase's rwkv6: 2 layers
# bf16 prefills of SERVE_BATCH x SERVE_PROMPT tokens on the one-device
# (data, model) mesh: (arch, layers as the serving cell cuts them, the
# kernel launched once a layer)
MESH_PREFILLS = (("rwkv6-7b", None, "rwkv6_scan"),
                 ("mixtral-8x7b", 16, "flash_attention"))
MESH_CODE_TIMED = 3                # mesh code: steps timed after the first


def fail(msg: str) -> None:
    print(f"FAIL {msg}", flush=True)
    sys.exit(1)


def bound(nbytes: float, ops: float, ops_rate: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def timing(fn, launches: int = 20, reps: int = 20,
           graph: bool = True) -> tuple[float, float | None]:
    """Milliseconds per call of ``fn``: (1) ``launches`` calls issued back
    to back by the host between two CUDA events, what a caller pays; (2)
    the same calls captured in one CUDA graph and replayed, the device
    time without host launch gaps (None with ``graph=False``). Each is the
    median of ``reps`` runs."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def run(call) -> float:
        out = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / launches)
        return statistics.median(out)

    def burst():
        for _ in range(launches):
            fn()

    eager = run(burst)
    if not graph:
        return eager, None
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        burst()
    return eager, run(g.replay)


def paper_nodes(k: int, n: int = 320):
    """The quickstart's stations: synthetic MNIST with 10-80% distinct
    items, cycled over ``k`` stations, ``n`` items each."""
    from repro_torch.data import redundancy, synthetic
    ratios = [0.1, 0.3, 0.5, 0.8]
    return [redundancy.inject_duplicates(
        synthetic.synthetic_mnist(seed=i, n=n, noise=2.0),
        ratios[i % 4], seed=i) for i in range(k)]


def synthetic_classes(i: int):
    """A vehicle of the Byzantine platoon (tests/test_faults.py:375): 160
    synthetic-MNIST items of the classes {3i, 3i+1, 3i+2} mod 10."""
    from repro_torch.data import synthetic
    return synthetic.synthetic_mnist(
        seed=i, n=160, classes=[(3 * i + c) % 10 for c in range(3)])


def synthetic_nodes(i: int):
    """A vehicle of examples/mobility_platoon.py: 256 synthetic-MNIST
    items, no injected duplicates."""
    from repro_torch.data import synthetic
    return synthetic.synthetic_mnist(seed=i, n=256, noise=2.0)


def node_arrays(nodes, local_steps: int = 10):
    from repro_torch.data import pipeline
    data = {"x": np.stack([d.x for d in nodes]),
            "y": np.stack([d.y for d in nodes])}
    items = pipeline.FederatedBatcher(nodes, 32, local_steps,
                                      seed=0).node_items()
    return data, items


def counted():
    """Every kernel wrapper with a launch count, by kernel name."""
    from repro_torch.kernels import cluster_mix, cnd_sketch, consensus_mix
    from repro_torch.kernels import flash_attention, robust_agg, rwkv6_scan
    from repro_torch.kernels import sparse_mix
    return {"flat_mix": consensus_mix.flat_mix,
            "flat_consensus": consensus_mix.flat_consensus,
            "consensus_mix": consensus_mix.consensus_mix,
            "cnd_bitmaps": cnd_sketch.cnd_bitmaps,
            "cnd_popcount": cnd_sketch.cnd_popcount,
            "sparse_mix": sparse_mix.sparse_mix,
            "cluster_mix": cluster_mix.cluster_mix,
            "robust_agg": robust_agg.robust_agg,
            "flash_attention": flash_attention.flash_attention,
            "rwkv6_scan": rwkv6_scan.rwkv6_scan}


# B9's launches split by dtype (the wrapper counts them apart; its
# ``launches`` is their sum)
B9_SPLIT = ("f32", "bf16")
# B1's and B2's launches with a variant axis (counted apart too, and
# included in ``launches``)
VARIANT_AXIS = ("flat_mix", "flat_consensus")


def reset_counts() -> None:
    for fn in counted().values():
        fn.launches = 0
    fa = counted()["flash_attention"]
    for dt in B9_SPLIT:
        setattr(fa, f"launches_{dt}", 0)
    for name in VARIANT_AXIS:
        counted()[name].launches_variants = 0


def read_counts() -> dict:
    """Launches by kernel name, B9's by dtype under
    ``flash_attention_<dtype>``, and B1's and B2's with a variant axis
    under ``<name>_variants``."""
    fa = counted()["flash_attention"]
    return {**{name: fn.launches for name, fn in counted().items()},
            **{f"flash_attention_{dt}": getattr(fa, f"launches_{dt}")
               for dt in B9_SPLIT},
            **{f"{name}_variants": counted()[name].launches_variants
               for name in VARIANT_AXIS}}


# B1's CUDA kernels (csrc/consensus_mix.cu): the small-K kernel and the
# tiled one, each instantiated per tile and wire type
B1_KERNELS = ("flat_mix_kernel", "flat_mix_tiled")


def b1_ms(busy: dict) -> float:
    """Device ms of B1's kernels in a ``device_profile`` map: a kernel's
    name, up to its template arguments, is one of ``B1_KERNELS``."""
    return sum(v for n, v in busy.items() if n.split("<")[0] in B1_KERNELS)


def b6_ms(busy: dict) -> float:
    """Device ms of B6's kernels in a ``device_profile`` map: the staged
    walk, and the walk with a per-node step size (``gather_mix_kernel``'s
    last template argument ``true``; B5 instantiates it ``false``)."""
    return sum(v for n, v in busy.items()
               if n.startswith("staged_mix_kernel")
               or (n.startswith("gather_mix_kernel") and "true>" in n))


def ptxas_kernels(log: str) -> list[tuple[str, int, int, int]]:
    """(mangled kernel name, registers, spill-store bytes, spill-load
    bytes) for each kernel in an ``nvcc -Xptxas -v`` log."""
    found, name, spill = [], None, (0, 0)
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = ln.split("Function properties for")[1].strip()
        elif "spill stores" in ln:
            st, ld = (int(w) for w in
                      re.findall(r"(\d+) bytes spill (?:stores|loads)", ln))
            spill = (st, ld)
        elif "Used" in ln and "registers" in ln and name:
            regs = int(re.search(r"Used (\d+) registers", ln).group(1))
            found.append((name, regs) + spill)
            name, spill = None, (0, 0)
    return found


def walk_loop(sass: str) -> tuple[int, int]:
    """(instructions, walk steps) of the innermost loop of B7's group walk
    that reads the most sorted pairs with LDS.128 (two steps a read), in a
    ``cuobjdump -sass`` listing: the SASS cost of the walk's steps."""
    funcs, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", ln)
        if name and m:
            funcs[name].append((int(m.group(1), 16), m.group(2)))
    walk = next(v for n, v in funcs.items() if "robust_agg_group_walk" in n)
    loops = []                                    # backward branches
    for addr, ins in walk:
        m = re.search(r"BRA (0x[0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < addr:
            loops.append((int(m.group(1), 16), addr))
    best = (0, 0)
    for lo, hi in loops:
        if any(lo <= a < hi and (a, b) != (lo, hi) for a, b in loops
               if lo <= b < hi):
            continue                              # not innermost
        loop = [i for a, i in walk if lo <= a <= hi]
        reads = sum("LDS.128" in i for i in loop)
        if 2 * reads > best[1]:
            best = (len(loop), 2 * reads)
    return best


def device_profile(prof) -> tuple[dict, int]:
    """Device busy milliseconds by kernel name, and the event count."""
    busy, n_dev = {}, 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.name.replace("(anonymous namespace)::", "")
            name = name.replace("void ", "").split("(")[0][:70]
            busy[name] = busy.get(name, 0.0) + \
                ev.time_range.elapsed_us() / 1e3
            n_dev += 1
    return busy, n_dev


def paired_ms(run_a, run_b, blocks: int, rounds: int) -> tuple:
    """ms per round of two runners timed in turns a, b, b, a (``blocks``
    times, ``rounds`` rounds a turn) within one call, so that host noise
    falls on both alike: (median a, median b, every turn of a, of b)."""
    times = ([], [])
    for _ in range(blocks):
        for side in (0, 1, 1, 0):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (run_a, run_b)[side](rounds)
            torch.cuda.synchronize()
            times[side].append(1e3 * (time.perf_counter() - t0) / rounds)
    return (statistics.median(times[0]), statistics.median(times[1])) + times


def live_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs that attention with these masks computes, q at
    position 0: the work B9 must do."""
    qp = np.arange(sq)
    lo = np.maximum(0, qp - window + 1) if window else np.zeros_like(qp)
    hi = np.minimum(qp, sk - 1) if causal else np.full_like(qp, sk - 1)
    return int(np.maximum(0, hi - lo + 1).sum())


def rel_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max()).item()


def b9_agrees(label, out, q, k, v, causal, window, rows,
              bf16_ulp) -> tuple[float, float]:
    """Hold B9's output against its plain version at the script's gates:
    f32 within rtol = atol = B9_TOL of the plain version; bf16 within one
    bf16 ulp of the f32 plain version where |value| >= 2**-7 (one ulp +
    B9_TOL below) and within 2e-2 of the bf16 plain version. Prints the
    ``check flash_attention`` line, adds to B9's max_abs_err and returns
    (max |diff| from the f32 plain version, the worst bf16 distance in
    ulps: 0 in f32)."""
    from repro_torch.kernels import ref
    want = ref.flash_attention(q.float(), k.float(), v.float(),
                               causal=causal, window=window)
    torch.cuda.synchronize()
    diff = (out.float() - want).abs()
    err = diff.max().item()
    worst = 0.0
    if out.dtype == torch.float32:
        if not torch.allclose(out, want, rtol=B9_TOL, atol=B9_TOL):
            fail(f"flash_attention {label} disagrees with its plain "
                 f"version: max |diff| {err:.3e} > {B9_TOL}")
        more = f"(rtol=atol={B9_TOL})"
    else:
        ulp = bf16_ulp(want)
        big = want.abs() >= 2 ** -7
        over = int((diff[big] > ulp[big]).sum().item())
        if over or not bool((diff <= ulp + B9_TOL).all()):
            fail(f"flash_attention {label}: {over} outputs with |value| "
                 f">= 2**-7 differ from the f32 plain version by more "
                 f"than one bf16 ulp; max |diff| {err:.3e}")
        worst = (diff / ulp)[big].max().item() if big.any() else 0.0
        plain = ref.flash_attention(q, k, v, causal=causal, window=window)
        err16 = (out.float() - plain.float()).abs().max().item()
        if not torch.allclose(out.float(), plain.float(), rtol=2e-2,
                              atol=2e-2):
            fail(f"flash_attention {label} differs from its bf16 plain "
                 f"version by {err16:.3e} > 2e-2")
        more = (f"(f32 plain: max {worst:.3f} ulp where |value| >= 2**-7;"
                f" bf16 plain: max |diff| {err16:.3e}, tol 2e-2)")
    print(f"check flash_attention {label} max_abs_err={err:.3e} {more}",
          flush=True)
    row = rows.setdefault("flash_attention", {"max_abs_err": 0.0})
    row["max_abs_err"] = max(row["max_abs_err"], err)
    return err, worst


def serving(dev, rows, record, add, expect_counts, bf16_ulp) -> None:
    """Kernel B9 and the qwen3-1.7b serving path: B9 against its plain
    version over tests/test_kernels.py's sweep and the path's shapes; the
    full-width model in bf16 (prefill, teacher-forced decode, generation)
    and in f32 (prefill against decode, with and without a window); the
    card against the port's CPU run of ``serve.main``; one decode step
    under the profiler."""
    from repro_torch.configs.registry import get_arch, get_smoke_arch
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    from repro_torch.launch import serve, steps
    from repro_torch.models import transformer

    gen = torch.Generator(device=dev).manual_seed(16)

    # -- 9a. B9 against its plain version ---------------------------------
    # bf16 runs on the tensor cores: its products take p as two bf16 terms,
    # p_hi + p_lo, which carry about 16 bits of p into an f32 accumulator.
    # So the plain version computed in f32 from the same bf16 inputs
    # differs from B9 by the output's rounding: one bf16 ulp where |value|
    # >= 2**-7, whose ulp (>= 6.1e-5) dwarfs the f32 summation-order noise;
    # below that, one ulp plus B9_TOL, the f32 gate. The 2e-2 gate against
    # the plain version in bf16 (which rounds p to bf16 first) stays as
    # well. First, the proof that the bf16 kernel was compiled to tensor-
    # core instructions: HGMMA is Hopper's wgmma in the machine code.
    cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(_build.library_path("flash_attention"))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    hgmma = sum("HGMMA" in ln for ln in sass.splitlines())
    print(f"sass flash_attention HGMMA instructions={hgmma}", flush=True)
    if hgmma == 0:
        fail("libflash_attention.so has no HGMMA instruction: bf16 B9 does "
             "not run on the tensor cores")
    worst_ulp = {"ulp": 0.0, "case": None}

    def check_b9(b, sq, sk, h, kv, d, dtype, causal=True, window=None,
                 off=0):
        """``off`` > 0: q, k and v are contiguous views that start ``off``
        elements into their buffers, called through ``ops.flash_attention``
        (which hands B9 aligned copies of unaligned bf16 views)."""
        def view(t):
            flat = torch.empty(t.numel() + off, dtype=t.dtype, device=dev)
            flat[off:] = t.flatten()
            return flat[off:].view(t.shape)

        q = torch.randn((b, sq, h, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, sk, kv, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, sk, kv, d), generator=gen, device=dev).to(dtype)
        if off:
            q, k, v = view(q), view(k), view(v)
            split = f"launches_{str(dtype)[6:].replace('float', 'f')}"
            before = (fa.flash_attention.launches,
                      getattr(fa.flash_attention, split))
            out = ops.flash_attention(q, k, v, causal=causal, window=window)
            if (fa.flash_attention.launches,
                    getattr(fa.flash_attention, split)) != (before[0] + 1,
                                                            before[1] + 1):
                fail(f"ops.flash_attention on unaligned {dtype} views did "
                     f"not launch B9")
        else:
            out = fa.flash_attention(q, k, v, causal=causal, window=window)
        label = (f"B={b} Sq={sq} Sk={sk} H={h} KV={kv} D={d} causal={causal}"
                 f" window={window} {str(dtype)[6:]}"
                 f"{f' offset={off} (ops)' if off else ''}")
        _, worst = b9_agrees(label, out, q, k, v, causal, window, rows,
                             bf16_ulp)
        if worst > worst_ulp["ulp"]:
            worst_ulp.update(ulp=worst, case=label)
        return q, k, v

    for b, sq, sk, h, kv, d in ((1, 128, 128, 2, 2, 64),   # MHA
                                (2, 256, 256, 4, 2, 64),   # GQA 2:1
                                (1, 128, 128, 8, 1, 32),   # MQA
                                (1, 512, 512, 2, 2, 128)):  # wide head
        for dtype in (torch.float32, torch.bfloat16):
            check_b9(b, sq, sk, h, kv, d, dtype)
    both = (torch.float32, torch.bfloat16)
    for window in (32, 64, 128):
        for dtype in both:
            check_b9(1, 256, 256, 2, 2, 64, dtype, window=window)
    for dtype in both:
        check_b9(1, 128, 256, 2, 2, 64, dtype, causal=False)
    for dtype in both:                                          # ragged
        check_b9(1, 500, 500, 4, 2, 64, dtype)
    # rows 79.. have no live key: the uniform average of v, as attend
    for dtype in both:
        check_b9(1, 128, 64, 2, 1, 32, dtype, window=16)
    # the tile edges of the bf16 kernel (128 query rows, 64-key tiles):
    # one key short of a tile, one past, one past two; GQA 4:1 at every
    # head dim; Sq not a multiple of 128, causal and not. f32 runs them
    # too, and the edges of its own tiles: F32_KEYS keys, and F32_ROWS
    # flattened rows, F32_ROWS / 4 positions at GQA 4:1
    f32_edges = {fa.F32_KEYS + e for e in (-1, 1)} | {
        fa.F32_ROWS // 4 + e for e in (-1, 1)} | {2 * fa.F32_KEYS + 1}
    for s_len in (63, 65, 129):
        for d in HEAD_DIMS:
            check_b9(1, s_len, s_len, 8, 2, d, torch.bfloat16)
    for s_len in sorted({63, 65, 129} | f32_edges):
        for d in HEAD_DIMS:
            check_b9(1, s_len, s_len, 8, 2, d, torch.float32)
    for sq, sk in ((fa.F32_KEYS - 1, 2 * fa.F32_KEYS + 1),
                   (fa.F32_ROWS // 4 + 1, fa.F32_KEYS + 1)):
        check_b9(1, sq, sk, 8, 2, 64, torch.float32, causal=False)
    # a window that starts inside a key tile; G = 3; three q tiles, so that
    # the middle one rides alone in its block
    check_b9(1, 100, 100, 8, 2, 64, torch.float32,
             window=fa.F32_KEYS // 2 + 3)
    check_b9(1, 100, 100, 6, 2, 128, torch.float32)
    check_b9(2, 3 * fa.F32_ROWS // 4, 3 * fa.F32_ROWS // 4, 8, 2, 128,
             torch.float32)
    check_b9(2, 200, 200, 8, 2, 128, torch.bfloat16)
    check_b9(1, 200, 333, 8, 2, 64, torch.bfloat16, causal=False)
    # views 1 and 3 elements past a 16-byte boundary, through ops (the
    # reference's ops.flash_attention takes any array): bf16 B9 gets
    # aligned copies, f32 B9 reads them as they are, with plain loads
    for dtype in both:
        check_b9(2, 128, 128, 8, 2, 64, dtype, off=1)
        check_b9(1, 200, 200, 8, 2, 128, dtype, window=64, off=3)
    # the path's shapes: the prefill of 128 tokens (and its window run;
    # f32 on the path, bf16 as the twin), the bf16 serving prefill of
    # 512, then qwen3's prefill shape
    check_b9(4, F32_PROMPT, F32_PROMPT, 16, 8, 128, torch.bfloat16)
    check_b9(4, F32_PROMPT, F32_PROMPT, 16, 8, 128, torch.bfloat16,
             window=F32_WINDOW)
    # f32 B9 at 9c's shape, timed (every layer of the f32 serving path
    # launches it), with and without the 64-token window; SDPA in f32 with
    # TF32 off, the window as a boolean band mask
    for window in (None, F32_WINDOW):
        q, k, v = check_b9(4, F32_PROMPT, F32_PROMPT, 16, 8, 128,
                           torch.float32, window=window)
        kr = k.repeat_interleave(2, dim=2).transpose(1, 2).contiguous()
        vr = v.repeat_interleave(2, dim=2).transpose(1, 2).contiguous()
        qt = q.transpose(1, 2).contiguous()
        pos = torch.arange(F32_PROMPT, device=dev)
        band = ((pos[None, :] <= pos[:, None])
                & (pos[None, :] > pos[:, None] - (window or F32_PROMPT)))
        pairs = 4 * 16 * live_pairs(F32_PROMPT, F32_PROMPT, True, window)
        record("flash_attention", f"B=4 S={F32_PROMPT} H=16 KV=8 D=128 f32 "
               f"causal window={window}",
               rows["flash_attention"]["max_abs_err"],
               lambda: fa.flash_attention(q, k, v, causal=True,
                                          window=window),
               lambda: ref.flash_attention(q, k, v, causal=True,
                                           window=window),
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   qt, kr, vr, attn_mask=band),
               2 * (q.numel() * 4 + k.numel() * 4), 4 * 128 * pairs,
               F32_OPS_PER_S,
               extra={"live_pairs": pairs,
                      "library": "torch.nn.functional.scaled_dot_product_"
                                 "attention(attn_mask=causal band) in f32, "
                                 "TF32 off, on (B, H, S, D), k/v repeated "
                                 "to H outside the timing"})
        del q, k, v, kr, vr, qt
    for s_len in (SERVE_PROMPT, PREFILL_S):
        q, k, v = check_b9(4, s_len, s_len, 16, 8, 128, torch.bfloat16)
        kr = k.repeat_interleave(2, dim=2).transpose(1, 2).contiguous()
        vr = v.repeat_interleave(2, dim=2).transpose(1, 2).contiguous()
        qt = q.transpose(1, 2).contiguous()
        pairs = 4 * 16 * live_pairs(s_len, s_len, True, None)
        record("flash_attention", f"B=4 S={s_len} H=16 KV=8 D=128 bf16 "
               f"causal", rows["flash_attention"]["max_abs_err"],
               lambda: fa.flash_attention(q, k, v, causal=True),
               lambda: ref.flash_attention(q, k, v, causal=True),
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   qt, kr, vr, is_causal=True),
               2 * (q.numel() * 2 + k.numel() * 2), 4 * 128 * pairs,
               BF16_OPS_PER_S, slow=s_len == PREFILL_S,
               extra={"live_pairs": pairs,
                      "library": "torch.nn.functional.scaled_dot_product_"
                                 "attention(is_causal=True) on (B, H, S, D), "
                                 "k/v repeated to H outside the timing"})
        del q, k, v, kr, vr, qt
    print("kernels B9 agrees with its plain version (f32 rtol=atol="
          f"{B9_TOL}; bf16 within one bf16 ulp of the f32 plain version "
          f"where |value| >= 2**-7, one ulp + {B9_TOL} below, and 2e-2 of "
          f"the bf16 plain version; worst bf16 case {worst_ulp['ulp']:.3f} "
          f"ulp at {worst_ulp['case']})", flush=True)

    # the model path with B9 swapped for its plain version: the control
    # that shows B9's share of a difference
    plain_attention = unittest.mock.patch.object(ops, "flash_attention",
                                                 ref.flash_attention)

    def counts_only(label, counts, b9):
        expect_counts(label, counts, {name: (b9 if name == "flash_attention"
                                             else 0) for name in counted()})
        add(counts)

    # -- 9b. qwen3-1.7b at full width, bf16 -------------------------------
    cfg = get_arch(SERVE_ARCH)
    gen_m = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()   # tensors of earlier phases
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, gen_m, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    if n_params != SERVE_PARAMS:
        fail(f"{SERVE_ARCH} has {n_params} params, expected {SERVE_PARAMS}")
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen_m, device=dev, dtype=torch.int32)
    batch = {"tokens": prompts}
    prefill = steps.make_prefill_step(cfg)
    prefill(params, batch)                       # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    tok_prefill = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts = read_counts()
    counts_only("prefill step", counts, cfg.num_layers)
    reset_counts()
    logits_pf = transformer.forward(params, cfg, batch, last_only=True)[0]
    counts_only("prefill logits", read_counts(), cfg.num_layers)
    with plain_attention:
        logits_plain = transformer.forward(params, cfg, batch,
                                           last_only=True)[0]
    serve_step = steps.make_serve_step(cfg)
    # one slot more than the run needs: the profiled step of 9e
    state = transformer.init_decode(cfg, SERVE_BATCH,
                                    SERVE_PROMPT + SERVE_GEN + 1, device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(SERVE_PROMPT - 1):
        tok, state = serve_step(params, state, prompts[:, t])
    # the last prompt token twice on the same state (the cache write is
    # the same): once for the logits, once through the serve step
    logits_tf = transformer.decode_step(params, cfg, state,
                                        prompts[:, -1])[0]
    tok, state = serve_step(params, state, prompts[:, -1])
    torch.cuda.synchronize()
    forced_s = time.perf_counter() - t0
    generated = []
    t0 = time.perf_counter()
    for _ in range(SERVE_GEN):
        generated.append(tok)
        tok, state = serve_step(params, state, tok)
    torch.cuda.synchronize()
    decode_ms = 1e3 * (time.perf_counter() - t0) / SERVE_GEN
    counts_only("decode", read_counts(), 0)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    if not torch.equal(torch.argmax(logits_tf, dim=-1).to(torch.int32),
                       generated[0]):
        fail("the serve step's token is not the argmax of its logits")
    rel_kernel = rel_diff(logits_pf[:, 0], logits_tf)
    rel_plain = rel_diff(logits_plain[:, 0], logits_tf)
    rel_kp = rel_diff(logits_pf, logits_plain)
    if not (torch.isfinite(logits_pf).all() and rel_kernel <= 3e-2):
        fail(f"{SERVE_ARCH} bf16: prefill logits differ from the teacher-"
             f"forced decode's by {rel_kernel:.3e} of max |logit| > 3e-2")
    agree = (tok_prefill == generated[0]).sum().item()
    gen_tokens = torch.stack(generated, dim=1).cpu()
    print(f"path serve {SERVE_ARCH} bf16 params={n_params} layers="
          f"{cfg.num_layers} batch={SERVE_BATCH} prompt={SERVE_PROMPT} gen="
          f"{SERVE_GEN} init_s={init_s:.2f} prefill_ms={1e3 * prefill_s:.3f} "
          f"prefill_tokens/s={SERVE_BATCH * SERVE_PROMPT / prefill_s:.1f} "
          f"teacher-forced_ms/token={1e3 * forced_s / SERVE_PROMPT:.3f} "
          f"decode_ms/token={decode_ms:.3f} decode_tokens/s="
          f"{SERVE_BATCH * 1e3 / decode_ms:.1f} peak_mem_GB={peak_gb:.3f} "
          f"(params, caches and activations above the phase's start) "
          f"launches={counts} prefill token == forced token for {agree}/"
          f"{SERVE_BATCH} requests sample={gen_tokens[0, :8].tolist()}",
          flush=True)
    print(f"check prefill-vs-teacher-forced {SERVE_ARCH} bf16 max|logit "
          f"diff|/max|logit|: B9 prefill {rel_kernel:.3e} (<= 3e-2), plain-"
          f"attention prefill {rel_plain:.3e}, B9 against plain prefill "
          f"{rel_kp:.3e}", flush=True)
    del logits_plain

    # -- 9c. the same model in f32, 128 prompt tokens ---------------------
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = transformer.init_params(
        cfg32, torch.Generator(device=dev).manual_seed(0), device=dev)
    p32 = {"tokens": prompts[:, :F32_PROMPT].contiguous()}
    for window in (None, F32_WINDOW):
        reset_counts()
        t0 = time.perf_counter()
        tok_pf = steps.make_prefill_step(cfg32, window)(params32, p32)
        torch.cuda.synchronize()
        pf_ms = 1e3 * (time.perf_counter() - t0)
        lg_pf = transformer.forward(params32, cfg32, p32,
                                    window_override=window,
                                    last_only=True)[0][:, 0]
        counts_only(f"f32 prefill window={window}", read_counts(),
                    2 * cfg.num_layers)
        state32 = transformer.init_decode(cfg32, SERVE_BATCH, F32_PROMPT,
                                          window_override=window, device=dev)
        step32 = steps.make_serve_step(cfg32, window)
        reset_counts()
        t0 = time.perf_counter()
        for t in range(F32_PROMPT - 1):
            _, state32 = step32(params32, state32, p32["tokens"][:, t])
        lg_tf = transformer.decode_step(params32, cfg32, state32,
                                        p32["tokens"][:, -1],
                                        window_override=window)[0]
        torch.cuda.synchronize()
        tf_s = time.perf_counter() - t0
        counts_only(f"f32 decode window={window}", read_counts(), 0)
        rel = rel_diff(lg_pf, lg_tf)
        tok_tf = torch.argmax(lg_tf, dim=-1).to(torch.int32)
        if not (rel <= 1e-4 and torch.equal(tok_pf, tok_tf)):
            fail(f"{SERVE_ARCH} f32 window={window}: prefill against "
                 f"teacher-forced decode {rel:.3e} of max |logit| (<= 1e-4), "
                 f"tokens {tok_pf.tolist()} against {tok_tf.tolist()}")
        print(f"check prefill-vs-teacher-forced {SERVE_ARCH} f32 prompt="
              f"{F32_PROMPT} window={window} cache="
              f"{state32.states.k.shape[2]} max|logit diff|/max|logit|="
              f"{rel:.3e} (<= 1e-4) tokens equal {tok_pf.tolist()} "
              f"B9 prefill_ms={pf_ms:.3f} teacher-forced {F32_PROMPT} steps "
              f"in {tf_s:.2f}s", flush=True)
    del params32, state32

    # -- 9d. the card against the port's CPU run, smoke width, f32 --------
    argv = ["--batch", "4", "--prompt-len", "32", "--gen", "16"]
    out_card = serve.main(argv + ["--device", "cuda"])
    out_cpu = serve.main(argv + ["--device", "cpu"])
    smoke = get_smoke_arch(SERVE_ARCH)
    variants = {"smoke": smoke, "smoke-gqa": dataclasses.replace(
        smoke, num_heads=4, num_kv_heads=2, head_dim=128)}
    for name, scfg in variants.items():
        p_card, pr_card = serve.init_inputs(scfg, 4, 32, dev)
        p_cpu, pr_cpu = serve.init_inputs(scfg, 4, 32, "cpu")
        reset_counts()
        lg_card = transformer.forward(p_card, scfg, {"tokens": pr_card},
                                      last_only=True)[0]
        counts_only(f"serve {name} prefill", read_counts(), scfg.num_layers)
        lg_cpu = transformer.forward(p_cpu, scfg, {"tokens": pr_cpu},
                                     last_only=True)[0]
        rel = rel_diff(lg_card.cpu(), lg_cpu)
        if name == "smoke":
            tok_card, tok_cpu = out_card, out_cpu
        else:
            tok_card = serve.generate(p_card, scfg, pr_card, 16)[0].cpu()
            tok_cpu = serve.generate(p_cpu, scfg, pr_cpu, 16)[0]
        if not (rel <= 1e-4 and np.array_equal(np.asarray(tok_card),
                                                np.asarray(tok_cpu))):
            fail(f"serve {name}: card against CPU prefill logits {rel:.3e} "
                 f"of max |logit| (<= 1e-4), tokens equal "
                 f"{np.array_equal(np.asarray(tok_card), np.asarray(tok_cpu))}")
        print(f"path serve {name} ({scfg.num_heads} heads over "
              f"{scfg.num_kv_heads}, head dim {scfg.resolved_head_dim()}) f32 "
              f"card-vs-cpu prefill max|logit diff|/max|logit|={rel:.3e} "
              f"(<= 1e-4) generated tokens equal "
              f"({tuple(np.asarray(tok_cpu).shape)})", flush=True)

    # -- 9e. one full-width bf16 decode step under the profiler -----------
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tok, state = serve_step(params, state, tok)
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    busy, n_dev = device_profile(prof)
    busy_ms = sum(busy.values())
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:5]
    print(f"profile serve {SERVE_ARCH} bf16 decode step (batch "
          f"{SERVE_BATCH}, token {SERVE_PROMPT + SERVE_GEN + 1}): wall_ms="
          f"{prof_ms:.3f} device_busy_ms={busy_ms:.3f} busy_share="
          f"{busy_ms / prof_ms:.4f} device_events={n_dev} top="
          f"{[(n, round(v, 4)) for n, v in top]} (reported, not gated)",
          flush=True)
    del params, state


def b10_work(b: int, s: int, h: int, d: int, c: int,
             in_bytes: int) -> tuple[int, int]:
    """(bytes, f32 operations) of one B10 call from a zero state: r/k/v
    read once in their dtype, w read and y written in f32, u read, the
    final state written. Per chunk and (batch, head): 7 operations per
    channel for each of the C(C-1)/2 causal pairs (the exponent's
    difference and exponential, the r.k product and its sum, and the
    score's multiply-add into y), 2 D^2 a token each for the state read
    and the state update, D^2 for the state's decay, and 8 a channel and
    token for the logs, sums, bonus and decay scales."""
    n = b * s * h * d
    nbytes = n * (3 * in_bytes + 4 + 4) + 4 * h * d + 4 * b * h * d * d
    pairs = c * (c - 1) // 2
    ops = b * h * (s // c) * (7 * pairs * d + 4 * c * d * d + d * d
                              + 8 * c * d)
    return nbytes, ops


def rwkv_serving(dev, rows, record, add, expect_counts) -> None:
    """Kernel B10 and the rwkv6-7b serving path: B10 against its plain
    version over tests/test_kernels.py's sweep, tests/test_ssm.py's shapes
    from a non-zero state and the path's shapes; the full-width model in
    bf16 (prefill through B10 against the plain-scan prefill, teacher-
    forced decode, generation, one profiled decode step) and in f32
    (prefill against decode at 128 tokens and at a ragged 120, which runs
    the sequential scan); the card against the port's CPU run of
    ``serve.main --arch rwkv6-7b`` at smoke width."""
    from repro_torch.configs.registry import get_arch, get_smoke_arch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.launch import serve, steps
    from repro_torch.models import layers, rwkv, transformer

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(17)

    # -- 11a. B10 against its plain version ------------------------------
    # Both compute the scan in f32 from the same values (bf16 r/k/v are
    # upcast by both); they differ in f32 summation order over S/C chunks
    # and in exp2/log2 against exp/log, a few f32 ulps of partial sums of
    # up to C + D terms: 1e-6 to 6e-6 of max |value|, the most at chunk 64
    # (on an H100 80GB HBM3, 700 W). B10_TOL leaves a margin of 3x or
    # more, on y and on the final state alike.
    def check_b10(b, s, h, d, chunk, dtype, decay, with_s0, off=0):
        """``off`` > 0: r, k, v and w are contiguous views that start
        ``off`` elements into their buffers (not 16-byte aligned)."""
        def view(t):
            flat = torch.empty(t.numel() + off, dtype=t.dtype, device=dev)
            flat[off:] = t.flatten()
            return flat[off:].view(t.shape)

        r, k, v = (torch.randn((b, s, h, d), generator=gen,
                               device=dev).to(dtype) for _ in range(3))
        z = torch.randn((b, s, h, d), generator=gen, device=dev)
        if decay == "kernel":     # tests/test_kernels.py's w in (0.05, 0.95)
            w = torch.sigmoid(z) * 0.9 + 0.05
        elif decay == "underflow":   # w within 1% of e^-4: a chunk's decay
            w = torch.exp(-rwkv.MAX_LOG_DECAY + 0.01 * torch.sigmoid(z))
        else:                     # the model's clamp, w >= e^-4
            w = torch.exp(-torch.clamp(torch.exp(z), 1e-6,
                                       rwkv.MAX_LOG_DECAY))
        if off:
            r, k, v, w = view(r), view(k), view(v), view(w)
        u = torch.randn((h, d), generator=gen, device=dev) * 0.1
        s0 = (torch.randn((b, h, d, d), generator=gen, device=dev) * 0.3
              if with_s0 else None)
        y, sf = rw.rwkv6_scan(r, k, v, w, u, s0, chunk)
        want_y, want_s = ref.rwkv6_scan(r, k, v, w, u, s0, chunk)
        torch.cuda.synchronize()
        label = (f"B={b} S={s} H={h} D={d} chunk={chunk} {str(dtype)[6:]} "
                 f"w={decay} s0={'yes' if with_s0 else 'zero'}"
                 f"{f' offset={off}' if off else ''}")
        err = 0.0
        for name, got, want in (("y", y, want_y), ("state", sf, want_s)):
            diff = (got - want).abs().max().item()
            scale = want.abs().max().item()
            err = max(err, diff)
            if not diff <= B10_TOL * scale:
                fail(f"rwkv6_scan {label}: {name} differs from its plain "
                     f"version by {diff:.3e} > {B10_TOL} x max |{name}| "
                     f"{scale:.3e}")
        print(f"check rwkv6_scan {label} max_abs_err={err:.3e} "
              f"(y max {want_y.abs().max().item():.3e}; tol {B10_TOL} of "
              f"max |value|)", flush=True)
        row = rows.setdefault("rwkv6_scan", {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        return r, k, v, w, u

    for b, s, h, d, chunk in ((1, 64, 1, 64, 16), (2, 128, 3, 64, 32),
                              (1, 256, 2, 128, 64)):
        check_b10(b, s, h, d, chunk, torch.float32, "kernel", False)
    for b, s, h, d in ((1, 16, 1, 32), (2, 64, 3, 64), (1, 128, 2, 16)):
        check_b10(b, s, h, d, 16, torch.float32, "model", True)
    check_b10(2, 64, 3, 64, 16, torch.bfloat16, "model", True)
    # every instantiation of the kernel (head size x chunk x dtype: its
    # shared-memory plan, stages and value split differ between them),
    # two chunks from a state; one chunk only; decays whose products
    # underflow over a 64-token chunk; inputs that are not 16-byte aligned
    # (staged with plain loads)
    for d in rw.HEAD_SIZES:
        for chunk in rw.CHUNKS:
            for dtype in (torch.float32, torch.bfloat16):
                check_b10(2, 2 * chunk, 3, d, chunk, dtype, "model", True)
    check_b10(2, 16, 3, 64, 16, torch.float32, "model", True)
    check_b10(2, 64, 3, 64, 64, torch.bfloat16, "model", True)
    check_b10(1, 128, 2, 64, 64, torch.float32, "underflow", True)
    check_b10(1, 128, 2, 128, 64, torch.float32, "underflow", False)
    for dtype in (torch.float32, torch.bfloat16):
        check_b10(2, 64, 3, 64, 16, dtype, "model", True, off=1)
    # the path's shapes: the f32 prefill of 128 tokens (timed), the bf16
    # serving prefill of 512 (timed), then rwkv6's prefill of 2048 (timed;
    # the kernel table keeps this last row)
    for s_len, dtype in ((RWKV_F32_PROMPT, torch.float32),
                         (SERVE_PROMPT, torch.bfloat16),
                         (PREFILL_S, torch.bfloat16)):
        r, k, v, w, u = check_b10(SERVE_BATCH, s_len, 64, 64, 16, dtype,
                                  "model", False)
        nbytes, flops = b10_work(SERVE_BATCH, s_len, 64, 64, 16,
                                 r.element_size())
        record("rwkv6_scan", f"B={SERVE_BATCH} S={s_len} H=64 D=64 chunk=16 "
               f"r/k/v {str(dtype)[6:]} w f32",
               rows["rwkv6_scan"]["max_abs_err"],
               lambda: rw.rwkv6_scan(r, k, v, w, u),
               lambda: ref.rwkv6_scan(r, k, v, w, u), None, nbytes, flops,
               F32_OPS_PER_S, slow=True,
               extra={"flop": flops, "library": "none: no single PyTorch "
                                                "call computes the wkv scan"})
        del r, k, v, w, u
    print(f"kernels B10 agrees with its plain version (y and state within "
          f"{B10_TOL} of max |value|)", flush=True)

    # the model path with B10 swapped for its plain version (the control,
    # as plain attention is for B9), and with the chunked form swapped for
    # the sequential scan (the same function in another f32 order)
    plain_b10 = unittest.mock.patch.object(ops, "rwkv6_scan",
                                           ref.rwkv6_scan)
    seq_scan = unittest.mock.patch.object(
        rwkv, "chunked", lambda r, k, v, w, u, s0=None:
        rwkv.scan_reference(r, k, v, w, u, s0))

    def counts_only(label, counts, b10):
        expect_counts(label, counts, {name: (b10 if name == "rwkv6_scan"
                                             else 0) for name in counted()})
        add(counts)

    # -- 11b. rwkv6-7b at full width, bf16 -------------------------------
    cfg = get_arch(RWKV_ARCH)
    gen_m = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, gen_m, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    if n_params != RWKV_PARAMS:
        fail(f"{RWKV_ARCH} has {n_params} params, expected {RWKV_PARAMS}")
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen_m, device=dev, dtype=torch.int32)
    batch = {"tokens": prompts}
    prefill = steps.make_prefill_step(cfg)
    prefill(params, batch)                       # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    tok_prefill = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts = read_counts()
    counts_only("rwkv prefill step", counts, cfg.num_layers)
    reset_counts()
    logits_pf = transformer.forward(params, cfg, batch, last_only=True)[0]
    counts_only("rwkv prefill logits", read_counts(), cfg.num_layers)
    # the same prefill step under the profiler: B10's share of its device
    # time (the kernel's name, up to its template arguments, is
    # rwkv6_kernel)
    reset_counts()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    # checked, and left out of the launch totals: a measurement, not a
    # path run
    expect_counts("rwkv profiled prefill", read_counts(),
                  {name: (cfg.num_layers if name == "rwkv6_scan" else 0)
                   for name in counted()})
    busy, n_dev = device_profile(prof)
    busy_ms = sum(busy.values())
    b10_ms = sum(v for n, v in busy.items() if n.startswith("rwkv6_kernel"))
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:5]
    print(f"profile serve {RWKV_ARCH} bf16 prefill (batch {SERVE_BATCH} x "
          f"{SERVE_PROMPT} tokens): wall_ms={prof_ms:.3f} device_busy_ms="
          f"{busy_ms:.3f} B10_ms={b10_ms:.3f} B10_share_of_device_time="
          f"{b10_ms / busy_ms:.4f} busy_share={busy_ms / prof_ms:.4f} "
          f"device_events={n_dev} top="
          f"{[(n, round(v, 4)) for n, v in top]} (the share reported, not "
          f"gated)", flush=True)
    if not b10_ms > 0:
        fail(f"{RWKV_ARCH} profiled prefill launched B10 but no kernel named "
             f"rwkv6_kernel shows device time")
    with plain_b10:
        logits_plain = transformer.forward(params, cfg, batch,
                                           last_only=True)[0]
    t0 = time.perf_counter()
    with seq_scan:
        logits_seq = transformer.forward(params, cfg, batch,
                                         last_only=True)[0]
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    serve_step = steps.make_serve_step(cfg)
    state = transformer.init_decode(cfg, SERVE_BATCH, SERVE_PROMPT,
                                    device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(SERVE_PROMPT - 1):
        tok, state = serve_step(params, state, prompts[:, t])
    # the last prompt token twice from the same state (rwkv states are not
    # updated in place): once for the logits, once through the serve step
    logits_tf = transformer.decode_step(params, cfg, state,
                                        prompts[:, -1])[0]
    tok, state = serve_step(params, state, prompts[:, -1])
    torch.cuda.synchronize()
    forced_s = time.perf_counter() - t0
    generated = []
    t0 = time.perf_counter()
    for _ in range(SERVE_GEN):
        generated.append(tok)
        tok, state = serve_step(params, state, tok)
    torch.cuda.synchronize()
    decode_ms = 1e3 * (time.perf_counter() - t0) / SERVE_GEN
    counts_only("rwkv decode", read_counts(), 0)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    if not torch.equal(torch.argmax(logits_tf, dim=-1).to(torch.int32),
                       generated[0]):
        fail("the rwkv serve step's token is not the argmax of its logits")
    rel_kernel = rel_diff(logits_pf[:, 0], logits_tf)
    rel_plain = rel_diff(logits_plain[:, 0], logits_tf)
    rel_seq = rel_diff(logits_seq[:, 0], logits_tf)
    rel_kp = rel_diff(logits_pf, logits_plain)
    rel_ps = rel_diff(logits_plain, logits_seq)
    agree = (tok_prefill == generated[0]).sum().item()
    gen_tokens = torch.stack(generated, dim=1).cpu()
    print(f"path serve {RWKV_ARCH} bf16 params={n_params} layers="
          f"{cfg.num_layers} batch={SERVE_BATCH} prompt={SERVE_PROMPT} gen="
          f"{SERVE_GEN} init_s={init_s:.2f} prefill_ms={1e3 * prefill_s:.3f} "
          f"prefill_tokens/s={SERVE_BATCH * SERVE_PROMPT / prefill_s:.1f} "
          f"sequential-scan prefill_ms={1e3 * seq_s:.3f} "
          f"teacher-forced_ms/token={1e3 * forced_s / SERVE_PROMPT:.3f} "
          f"decode_ms/token={decode_ms:.3f} decode_tokens/s="
          f"{SERVE_BATCH * 1e3 / decode_ms:.1f} peak_mem_GB={peak_gb:.3f} "
          f"(params, states and activations above the phase's start) "
          f"launches={counts} prefill token == forced token for {agree}/"
          f"{SERVE_BATCH} requests sample={gen_tokens[0, :8].tolist()}",
          flush=True)
    # What bf16 rounding of the layer outputs allows: the plain path with
    # its chunked scan swapped for the sequential scan computes the same
    # function, differing below bf16's resolution only (f32 order); how
    # far its logits move through 32 bf16 layers is the margin. B10
    # against the plain version is a difference of the same kind, so it
    # is held to twice that margin, and its drift from teacher-forced
    # decode to the plain path's plus the same margin.
    limit = 2 * rel_ps
    print(f"check prefill-vs-teacher-forced {RWKV_ARCH} bf16 max|logit "
          f"diff|/max|logit|: B10 prefill {rel_kernel:.3e} (<= plain's + "
          f"{limit:.3e}), plain-scan prefill {rel_plain:.3e}, sequential-"
          f"scan prefill {rel_seq:.3e}; B10 against plain prefill "
          f"{rel_kp:.3e} (<= {limit:.3e}, twice the plain against "
          f"sequential-scan prefill's {rel_ps:.3e}: the same function in "
          f"another f32 order)", flush=True)
    if not (torch.isfinite(logits_pf).all() and rel_kp <= limit):
        fail(f"{RWKV_ARCH} bf16: B10 prefill logits differ from the plain-"
             f"scan prefill's by {rel_kp:.3e} of max |logit| > {limit:.3e}")
    if not rel_kernel <= rel_plain + limit:
        fail(f"{RWKV_ARCH} bf16: B10 prefill drifts {rel_kernel:.3e} from "
             f"teacher-forced decode, more than the plain-scan prefill's "
             f"{rel_plain:.3e} + {limit:.3e}")
    del logits_plain, logits_seq

    # Block by block: B10 and its plain version from the same bf16 input
    # (the plain path's residual stream) differ by the rounding of y only;
    # run apart, the two paths show how that grows with depth.
    x_p = x_k = layers.embed(params["embed"], prompts).to(
        transformer._dtype(cfg))
    same, apart = [], []
    for i in range(cfg.num_layers):
        p_i = transformer._layer(params["layers"], i)
        with plain_b10:
            out_p = transformer._apply_block(p_i, cfg, "rwkv", x_p)[0]
        same.append(rel_diff(
            transformer._apply_block(p_i, cfg, "rwkv", x_p)[0], out_p))
        x_k = transformer._apply_block(p_i, cfg, "rwkv", x_k)[0]
        apart.append(rel_diff(x_k, out_p))
        x_p = out_p
    del x_p, x_k, out_p, p_i
    depths = [d for d in (1, 2, 4, 8, 16, 32) if d <= cfg.num_layers]
    print(f"check rwkv layers {RWKV_ARCH} bf16 B10 against plain block "
          f"output, max|diff|/max|output|: from the same input, worst "
          f"{max(same):.3e} (<= {RWKV_LAYER_TOL:.3e}) at layer "
          f"{same.index(max(same)) + 1}; run apart, after layers "
          f"{depths}: {[f'{apart[d - 1]:.3e}' for d in depths]}",
          flush=True)
    if not max(same) <= RWKV_LAYER_TOL:
        fail(f"{RWKV_ARCH} bf16: a block's output through B10 differs from "
             f"the plain version's from the same input by {max(same):.3e} "
             f"> {RWKV_LAYER_TOL:.3e} of max |output|")

    # one full-width bf16 decode step under the profiler
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tok, state = serve_step(params, state, tok)
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    busy, n_dev = device_profile(prof)
    busy_ms = sum(busy.values())
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:5]
    print(f"profile serve {RWKV_ARCH} bf16 decode step (batch "
          f"{SERVE_BATCH}, token {SERVE_PROMPT + SERVE_GEN + 1}): wall_ms="
          f"{prof_ms:.3f} device_busy_ms={busy_ms:.3f} busy_share="
          f"{busy_ms / prof_ms:.4f} device_events={n_dev} top="
          f"{[(n, round(v, 4)) for n, v in top]} (reported, not gated)",
          flush=True)
    del params, state
    torch.cuda.empty_cache()

    # -- 11c. the same model in f32: 128 prompt tokens (B10) and a ragged
    # 120 (the sequential scan), each against teacher-forced decode -----
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = transformer.init_params(
        cfg32, torch.Generator(device=dev).manual_seed(0), device=dev)
    p32 = prompts[:, :RWKV_F32_PROMPT].contiguous()
    pf = {}
    for n_tok, b10 in ((RWKV_F32_PROMPT, cfg.num_layers), (RWKV_RAGGED, 0)):
        reset_counts()
        t0 = time.perf_counter()
        tok_pf = steps.make_prefill_step(cfg32)(params32,
                                                {"tokens": p32[:, :n_tok]})
        torch.cuda.synchronize()
        pf_ms = 1e3 * (time.perf_counter() - t0)
        lg = transformer.forward(params32, cfg32, {"tokens": p32[:, :n_tok]},
                                 last_only=True)[0][:, 0]
        counts_only(f"rwkv f32 prefill {n_tok} tokens", read_counts(),
                    2 * b10)
        pf[n_tok] = (tok_pf, lg, pf_ms)
    state32 = transformer.init_decode(cfg32, SERVE_BATCH, RWKV_F32_PROMPT,
                                      device=dev)
    step32 = steps.make_serve_step(cfg32)
    reset_counts()
    t0 = time.perf_counter()
    for t in range(RWKV_F32_PROMPT):
        if t + 1 in pf:
            lg_tf = transformer.decode_step(params32, cfg32, state32,
                                            p32[:, t])[0]
            tok_pf, lg_pf, pf_ms = pf[t + 1]
            rel = rel_diff(lg_pf, lg_tf)
            tok_tf = torch.argmax(lg_tf, dim=-1).to(torch.int32)
            via = "B10" if t + 1 == RWKV_F32_PROMPT else "sequential scan"
            if not (rel <= 1e-4 and torch.equal(tok_pf, tok_tf)):
                fail(f"{RWKV_ARCH} f32 prompt={t + 1}: prefill ({via}) "
                     f"against teacher-forced decode {rel:.3e} of max "
                     f"|logit| (<= 1e-4), tokens {tok_pf.tolist()} against "
                     f"{tok_tf.tolist()}")
            print(f"check prefill-vs-teacher-forced {RWKV_ARCH} f32 prompt="
                  f"{t + 1} prefill via {via} max|logit diff|/max|logit|="
                  f"{rel:.3e} (<= 1e-4) tokens equal {tok_pf.tolist()} "
                  f"prefill_ms={pf_ms:.3f}", flush=True)
        _, state32 = step32(params32, state32, p32[:, t])
    torch.cuda.synchronize()
    tf_s = time.perf_counter() - t0
    counts_only("rwkv f32 decode", read_counts(), 0)
    print(f"path serve {RWKV_ARCH} f32 teacher-forced {RWKV_F32_PROMPT} "
          f"steps in {tf_s:.2f}s", flush=True)
    del params32, state32
    torch.cuda.empty_cache()

    # -- 11d. the card against the port's CPU run, smoke width, f32 -------
    argv = ["--arch", RWKV_ARCH, "--batch", "4", "--prompt-len", "32",
            "--gen", "16"]
    reset_counts()
    out_card = serve.main(argv + ["--device", "cuda"])
    counts_only("serve.main rwkv", read_counts(), 0)
    out_cpu = serve.main(argv + ["--device", "cpu"])
    smoke = get_smoke_arch(RWKV_ARCH)
    p_card, pr_card = serve.init_inputs(smoke, 4, 32, dev)
    p_cpu, pr_cpu = serve.init_inputs(smoke, 4, 32, "cpu")
    reset_counts()
    lg_card = transformer.forward(p_card, smoke, {"tokens": pr_card},
                                  last_only=True)[0]
    counts_only("serve rwkv smoke prefill", read_counts(), smoke.num_layers)
    lg_cpu = transformer.forward(p_cpu, smoke, {"tokens": pr_cpu},
                                 last_only=True)[0]
    rel = rel_diff(lg_card.cpu(), lg_cpu)
    same = np.array_equal(np.asarray(out_card), np.asarray(out_cpu))
    if not (rel <= 1e-4 and same):
        fail(f"serve {RWKV_ARCH} smoke: card against CPU prefill logits "
             f"{rel:.3e} of max |logit| (<= 1e-4), tokens equal {same}")
    print(f"path serve {RWKV_ARCH} smoke ({smoke.num_layers} layers, "
          f"d_model {smoke.d_model}) f32 card-vs-cpu prefill max|logit "
          f"diff|/max|logit|={rel:.3e} (<= 1e-4, {smoke.num_layers} B10 "
          f"launches) serve.main generated tokens equal "
          f"({tuple(np.asarray(out_cpu).shape)})", flush=True)
    print(f"phase rwkv6 serving {time.perf_counter() - t_phase:.1f}s",
          flush=True)


def quickstart_and_resume(add, expect_counts, dense_only, loss, train, fed_k4,
                          data4, items4) -> None:
    """The quickstart's twin through Experiment on the card against the
    CPU, then run(10) + save + resume + run(10) against run(20) on the
    card."""
    from repro_torch import experiment
    from repro_torch.configs.paper_models import MLP_CONFIG
    from repro_torch.examples import quickstart
    from repro_torch.models import simple

    # -- 4a. the quickstart's twin through Experiment; resume -------------
    # src/repro_torch/examples/quickstart.py makes examples/quickstart.py's
    # calls through the port's Experiment and Session: on the card, then on
    # the CPU. Then, on the card, run(10) + save + resume in a fresh Session
    # + run(10) against a straight run(20) of the same experiment: round r
    # draws its batches from a generator keyed on (seed, r), so the two
    # must agree bit for bit, Adam moments and step counters included.
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out_card:
        qs = quickstart.main([])
    torch.cuda.synchronize()
    qs_s = time.perf_counter() - t0
    counts = read_counts()
    expect_counts("quickstart", counts, {
        "flat_mix": 10, "flat_consensus": 0, "cnd_bitmaps": 1,
        "cnd_popcount": 1, **dense_only})
    add(counts)
    with contextlib.redirect_stdout(io.StringIO()) as out_cpu:
        qs_cpu = quickstart.main(["--device", "cpu"])
    diff = (qs.state.buf.cpu() - qs_cpu.state.buf).abs().max().item()
    if not diff <= 1e-4:
        fail(f"quickstart: card params differ from the CPU run by "
             f"{diff:.3e} > 1e-4")
    lossr = qs.metrics["loss"].mean(dim=1).cpu()
    if not torch.isfinite(lossr).all() or not lossr[-1] < lossr[0]:
        fail(f"quickstart: loss did not fall: {lossr.tolist()}")
    card_lines = out_card.getvalue().splitlines()
    if card_lines[-1] != out_cpu.getvalue().splitlines()[-1] or \
            "consensus model" not in card_lines[-1]:
        fail(f"quickstart: unexpected last line {card_lines[-1]!r}")
    print(f"path quickstart K=4 (Experiment, Session.run(10)) "
          f"{card_lines[0]} loss/round="
          f"{[round(v, 4) for v in lossr.tolist()]} launches={counts} "
          f"card-vs-cpu max|param diff|={diff:.3e} wall_s={qs_s:.3f}",
          flush=True)
    qs_exp = experiment.Experiment.from_parts(
        loss, lambda g: simple.mlp_init(g, MLP_CONFIG), fed=fed_k4,
        train=train)
    check_resume("K=4", qs_exp, data4, items4, add, expect_counts,
                 dense_only)


def check_resume(label, exp, data, items, add, expect_counts, dense_only,
                 n_items=None, expect=None) -> None:
    """run(10) + save + resume in a fresh Session + run(10) against a
    straight run(20) of ``exp`` on the card, bit for bit: params, Adam
    moments and step counters, the transport's snapshots and the ingest
    sketches when the run keeps them, and every metric. ``expect``: the
    launches of the three runs (default: the dense exchange's B1)."""
    ckpt = ROOT / "build" / "chip_smoke_checkpoint"
    shutil.rmtree(ckpt, ignore_errors=True)
    steps = 20 * exp.fed.local_steps
    reset_counts()
    straight = exp.compile(data, items, n_items=n_items).run(20)
    first = exp.compile(data, items, n_items=n_items)
    part1 = first.run(10)
    first.save(str(ckpt))
    resumed = exp.compile(data, items, n_items=n_items).resume(str(ckpt))
    part2 = resumed.run(10)
    counts = read_counts()
    expect_counts(f"resume {label}", counts, expect or {
        "flat_mix": 40, "flat_consensus": 0, "cnd_bitmaps": 3,
        "cnd_popcount": 3, **dense_only})
    add(counts)
    shutil.rmtree(ckpt)
    pairs = [("buf", straight.state.buf, part2.state.buf),
             ("m", straight.state.opt.m, part2.state.opt.m),
             ("v", straight.state.opt.v, part2.state.opt.v),
             ("step", straight.state.opt.step, part2.state.opt.step)]
    if isinstance(straight.state.tstate, torch.Tensor):
        pairs.append(("snapshots", straight.state.tstate,
                      part2.state.tstate))
    for name, a in getattr(straight.state.istate, "_asdict",
                           dict)().items():
        pairs.append((f"sketch {name}", a, getattr(part2.state.istate,
                                                   name)))
    pairs += [(f"metrics {n}", v, torch.cat([part1.metrics[n],
                                             part2.metrics[n]]))
              for n, v in straight.metrics.items()]
    unequal = [n for n, a, b in pairs if not torch.equal(a, b)]
    if unequal or resumed.rounds_completed != 20 or \
            not bool((part2.state.opt.step == steps).all()):
        worst = (straight.state.buf - part2.state.buf).abs().max().item()
        fail(f"resume {label}: run(10) + save + resume + run(10) differs "
             f"from run(20) in {unequal} (max |buf diff| {worst:.3e})")
    print(f"check resume {label} on the card: run(10) + save + resume + "
          f"run(10) equals run(20) bit for bit "
          f"({', '.join(n for n, _, _ in pairs)}; Adam steps {steps} a "
          f"node) launches={counts}", flush=True)


def pad_cycle(a, n):
    return np.concatenate([a] * int(np.ceil(n / a.shape[0])))[:n]


def table_setup(model, alg):
    """paper_tables._alg_setup through the port: (loss, init, eval_fn
    of a device, train config, local steps, raw items, data,
    n_items)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.paper_models import MLP_CONFIG, VGG_CONFIG
    from repro_torch.data import pipeline, redundancy, synthetic
    from repro_torch.models import simple
    if model == "mlp":
        cfg, steps = MLP_CONFIG, 10
        raw = [redundancy.inject_duplicates(
            synthetic.synthetic_mnist(seed=i, n=cfg.train_per_node,
                                      noise=TABLE_NOISE),
            TABLE_RATIOS[i], seed=i) for i in range(4)]
        test = synthetic.synthetic_mnist(seed=99, n=cfg.test_per_node * 4,
                                         noise=TABLE_NOISE)
        fwd, tloss = simple.mlp_forward, simple.make_mlp_loss(cfg)
        init = lambda g: simple.mlp_init(g, cfg)
    else:
        cfg, steps = VGG_CONFIG, 6
        raw = [redundancy.inject_duplicates(
            synthetic.synthetic_bird(
                seed=i, n=cfg.train_per_node, num_classes=cfg.num_classes,
                image_size=cfg.image_size, noise=VGG_NOISE),
            TABLE_RATIOS[i], seed=i) for i in range(4)]
        test = synthetic.synthetic_bird(
            seed=99, n=cfg.test_per_node * 4, num_classes=cfg.num_classes,
            image_size=cfg.image_size, noise=VGG_NOISE)
        fwd, tloss = simple.vgg_forward, simple.make_vgg_loss(cfg)
        init = lambda g: simple.vgg_init(g, cfg)
    nodes = ([redundancy.cnd_dedup(d) for d in raw] if alg == "cdfl"
             else raw)
    n_per = np.asarray([d.x.shape[0] for d in nodes])
    n_max = int(n_per.max())
    data = {"x": np.stack([pad_cycle(d.x, n_max) for d in nodes]),
            "y": np.stack([pad_cycle(d.y, n_max) for d in nodes])}
    n_items = None if (n_per == n_max).all() else n_per
    raw_items = pipeline.FederatedBatcher(raw, cfg.batch_size,
                                          steps).node_items()
    train_cfg = TrainConfig(learning_rate=cfg.learning_rate,
                            batch_size=cfg.batch_size, beta1=cfg.beta1,
                            beta2=cfg.beta2, eps=cfg.eps)

    def eval_fn(device):
        x = torch.as_tensor(test.x, device=device).expand(
            (4,) + test.x.shape)
        y = torch.as_tensor(test.y, device=device).expand(
            (4,) + test.y.shape)
        return lambda params: simple.accuracy(fwd(params, x), y)

    return (tloss, init, eval_fn, train_cfg, steps, raw_items, data,
            n_items)


def rounds_to_80(acc):
    """Per station of an (R, K) accuracy series: the first round at 80%
    (TABLE_ROUNDS where never reached), and whether it was reached."""
    hit = acc >= 0.8
    return np.where(hit.any(axis=0), hit.argmax(axis=0) + 1,
                    TABLE_ROUNDS), hit.any(axis=0)


def paper_tables(dev, add, expect_counts, dense_only) -> None:
    """The paper's Tables 1-4, MLP and VGG halves, through Experiment and
    EvalCallback; a profiled VGG round; the VGG's f32 guard; the VGG's
    resume."""
    from repro_torch import experiment
    from repro_torch.configs.base import FedConfig, TrainConfig
    from repro_torch.configs.paper_models import MLP_CONFIG, VGG_CONFIG
    from repro_torch.core import flatten
    from repro_torch.data import pipeline, redundancy, synthetic
    from repro_torch.models import simple

    # -- 8. the paper's Tables 1-4 (benchmarks/paper_tables.py:24-140) ----
    # Through Experiment and EvalCallback, as the table driver runs them:
    # K=4 ring; NODE_RATIOS through inject_duplicates; the MLP on synthetic
    # MNIST (noise 2.5, 320 items a station, 10 local steps) and the VGG on
    # synthetic BIRD (noise 1.5, 120 items a station, 6 local steps), each
    # with its config's lr, batch, betas and eps and a test set from seed
    # 99; 60 rounds with per-round test accuracy. cdfl trains on the CND-
    # deduplicated (ragged) nodes through n_items; its sketches, like every
    # algorithm's, come from the raw data. compile(rng=0, sample_rng=0).
    # The run is two Session.run calls (3 + 57 rounds); the card is checked
    # against the CPU over the first 3. The VGG's 3 rounds run with cuDNN's
    # and cuBLAS's TF32 switches as a process starts (cuDNN allows TF32):
    # the package's convolutions must hold f32 on their own. Rounds to 80%
    # are reported, not gated.

    @contextlib.contextmanager
    def process_tf32():
        """TF32 switches as a process starts (cuBLAS off, cuDNN on), the
        script's restored after."""
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved

    def vgg_checks(exp, exp_cpu, data, raw_items, n_items, tloss, diff,
                   cpu_buf3):
        """One local step of the VGG from the same params and batch: the
        logits, per-node losses and flat gradient on the card (TF32
        switched as a process starts, twice: the two must agree bit for
        bit; then with the package's f32 guard bypassed, the control) and
        on the CPU in f32, each against the CPU in f64. The card's are
        gated within 1e-4 of max |value|, and the control must miss that
        gate (TF32 convolutions miss it by about 10x). And the 3-round
        drift beside the CPU's own: its 3 rounds from the input moved by
        one ulp (reported)."""
        session = exp.compile(data, raw_items, rng=0, sample_rng=0,
                              n_items=n_items)
        state = session.state
        sel = session.batch_indices(0, 1)[0][:, 0]
        rows_k = torch.arange(4)[:, None]
        batch = {n: torch.as_tensor(v)[rows_k, sel] for n, v in data.items()}

        def step(device, dtype=torch.float32):
            buf = state.buf.to(device, dtype).detach().requires_grad_(True)
            layout = state.layout._replace(
                dtypes=(dtype,) * len(state.layout.dtypes))
            params = flatten.unflatten(buf, layout)
            b = {"x": batch["x"].to(device, dtype), "y": batch["y"].to(device)}
            logits = simple.vgg_forward(params, b["x"])
            losses = tloss(params, b)
            (grad,) = torch.autograd.grad(losses.sum(), buf)
            return [t.detach().cpu().double() for t in (logits, losses, grad)]

        want = step("cpu", torch.float64)
        runs = {"cpu f32": step("cpu")}
        with process_tf32():
            runs["card"] = step(dev)
            again = step(dev)
            with unittest.mock.patch.object(simple, "_exact_conv",
                                            contextlib.nullcontext):
                runs["card, guard bypassed"] = step(dev)
        repeat = all(torch.equal(a, b) for a, b in zip(runs["card"], again))
        names = ("logits", "losses", "grad")
        errs = {label: {n: rel_diff(g, w) for n, g, w in zip(names, got, want)}
                for label, got in runs.items()}
        shown = "; ".join(
            f"{label}: " + " ".join(f"{n}={v:.3e}" for n, v in e.items())
            for label, e in errs.items())
        if not (max(errs["card"].values()) <= 1e-4 and repeat):
            fail(f"vgg one step on the card (TF32 as a process starts) "
                 f"against f64 (max |diff| / max |value| <= 1e-4, two runs "
                 f"equal {repeat}): {shown}")
        if not max(errs["card, guard bypassed"].values()) > 1e-4:
            fail(f"vgg one step with the f32 guard bypassed passes the "
                 f"1e-4 gate, which so cannot see TF32: {shown}")
        x1 = dict(data, x=np.nextafter(data["x"], np.float32(np.inf)))
        ulp3 = exp_cpu.compile(x1, raw_items, rng=0, sample_rng=0,
                               n_items=n_items).run(3)
        floor = (ulp3.state.buf - cpu_buf3).abs().max().item()
        print(f"check vgg one step against f64 on the CPU (max |diff| / "
              f"max |value|; the card's with TF32 switched as a process "
              f"starts gated <= 1e-4 and equal over two runs; the bypassed "
              f"guard must miss): {shown}; 3 rounds card-vs-cpu max|param "
              f"diff|={diff:.3e} against the CPU's own 3 rounds from its "
              f"input moved by one ulp {floor:.3e} (reported)", flush=True)

    vgg_note = " (TF32 switches as a process starts)"
    for model in ("mlp", "vgg"):
        table = {}
        for alg in TABLE_ALGS:
            (tloss, init, eval_fn, train_cfg, steps, raw_items, data,
             n_items) = table_setup(model, alg)
            fed = FedConfig(num_nodes=4, local_steps=steps, algorithm=alg)
            exp = experiment.Experiment.from_parts(tloss, init, fed=fed,
                                                   train=train_cfg)
            ev = experiment.EvalCallback(eval_fn(dev))
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            session = exp.compile(data, raw_items, rng=0, sample_rng=0,
                                  n_items=n_items)
            flags = (process_tf32() if model == "vgg"
                     else contextlib.nullcontext())
            with flags:
                r3 = session.run(3, callbacks=[ev])
                buf3 = session.state.buf.clone()
            r57 = session.run(TABLE_ROUNDS - 3, callbacks=[ev])
            torch.cuda.synchronize()
            round_ms = 1e3 * (time.perf_counter() - t0) / TABLE_ROUNDS
            counts = read_counts()
            mixes = TABLE_ROUNDS * (steps if alg == "dpsgd" else 1)
            expect_counts(f"table {model} {alg}", counts, {
                "flat_mix": mixes, "flat_consensus": 0, "cnd_bitmaps": 1,
                "cnd_popcount": 1, **dense_only})
            add(counts)
            exp_cpu = experiment.Experiment.from_parts(
                tloss, init, fed=fed, train=train_cfg, device="cpu")
            cpu3 = exp_cpu.compile(data, raw_items, rng=0, sample_rng=0,
                                   n_items=n_items).run(
                3, callbacks=[experiment.EvalCallback(eval_fn("cpu"))])
            diff = (buf3.cpu() - cpu3.state.buf).abs().max().item()
            # the VGG's 18 Adam steps amplify f32 rounding to about 1e-2
            # (ReLU gates decided by rounding flip): the CPU alone moves as
            # far from a one-ulp change of its input, so its gate is the
            # one-step check below
            if model == "mlp" and not diff <= 1e-4:
                fail(f"table {model} {alg}: card params after 3 rounds "
                     f"differ from the CPU run by {diff:.3e} > 1e-4")
            acc = torch.cat([r3.metrics["eval"],
                             r57.metrics["eval"]]).cpu().numpy()   # (R, K)
            to_80, reached = rounds_to_80(acc)
            table[alg] = to_80.tolist()
            eval_diff = np.abs(acc[:3] - cpu3.metrics["eval"].numpy()).max()
            curve = [round(float(acc[r - 1].mean()), 4)
                     for r in (10, 20, 30, 60) if r <= TABLE_ROUNDS]
            print(f"table {model} {alg} rounds_to_80/node={to_80.tolist()} "
                  f"(mean {float(np.mean(to_80)):.2f}; reached="
                  f"{reached.tolist()}; {TABLE_ROUNDS} where never reached) "
                  f"final_acc/node={[round(float(a), 4) for a in acc[-1]]} "
                  f"mean acc at rounds 10/20/30/60={curve} "
                  f"ms/round={round_ms:.3f} n_items="
                  f"{None if n_items is None else n_items.tolist()} "
                  f"launches={counts} card-vs-cpu 3 rounds max|param diff|="
                  f"{diff:.3e} max|eval diff|={eval_diff:.4f}"
                  f"{vgg_note if model == 'vgg' else ''}",
                  flush=True)
            if model == "vgg" and alg == "cdfl":
                # one more round under the profiler: busy share and the top
                # device ops of a VGG round
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    session.run(1, callbacks=[ev])
                    torch.cuda.synchronize()
                    prof_ms = 1e3 * (time.perf_counter() - t0)
                busy, n_dev = device_profile(prof)
                busy_ms = sum(busy.values())
                if busy_ms <= 0:
                    fail("profile vgg: the round shows no device time")
                top = sorted(busy.items(), key=lambda kv: -kv[1])[:8]
                conv_ms = sum(v for n, v in busy.items()
                              if "conv" in n.lower() or "cudnn" in n.lower()
                              or "implicit" in n.lower())
                print(f"profile vgg cdfl round: wall_ms={prof_ms:.3f} "
                      f"device_busy_ms={busy_ms:.3f} busy_share="
                      f"{busy_ms / prof_ms:.4f} B1_ms={b1_ms(busy):.4f} "
                      f"conv_ms={conv_ms:.4f} device_events={n_dev} top="
                      f"{[(n, round(v, 4)) for n, v in top]}", flush=True)
                vgg_checks(exp, exp_cpu, data, raw_items, n_items, tloss,
                           diff, cpu3.state.buf)
                with process_tf32():
                    check_resume("vgg cdfl", exp, data, raw_items, add,
                                 expect_counts, dense_only, n_items=n_items)
        ranking = sorted((round(float(np.mean(v)), 2), a)
                         for a, v in table.items())
        print(f"table {model} ranking (mean rounds to 80% over the 4 "
              f"stations, lower is faster; reported, not gated): {ranking}",
              flush=True)


def variant_kernel_rows(dev, gen, record) -> None:
    """B1 and B2 with a variant axis (blockIdx.z = variant): each held
    against its plain version, each variant against a V = 1 launch on its
    own inputs bit for bit, and timed against V single launches and the
    batched library call (``torch.baddbmm`` for B1, ``torch.matmul`` for
    B2). The path's shapes: B1 V=4 K=4 f32 with one shared eta (the paper
    MLP's seeds sweep), B1 V=4 K=256 bf16 with an eta a variant (the ring
    fleet's gamma x seeds sweep), B2 V=2 K=256 (the crashed ring fleet's
    `sent` branch, an eta a variant after the wire guard)."""
    from repro_torch.kernels import consensus_mix as cm
    from repro_torch.kernels import ref

    for name, v, k, wdt, shared in (
            ("flat_mix_variants", 4, 4, torch.float32, True),
            ("flat_mix_variants", 4, 256, torch.bfloat16, False),
            ("flat_consensus_variants", 2, 256, None, False)):
        master = torch.randn((v, k, P), generator=gen, device=dev)
        eta = torch.rand(((1 if shared else v), k, k), generator=gen,
                         device=dev)
        eta.diagonal(dim1=-2, dim2=-1).zero_()
        eta = eta / eta.sum(dim=-1, keepdim=True)
        eta = (eta[0] if shared else eta).contiguous()
        gamma = torch.rand((v,), generator=gen, device=dev) * 0.5 + 0.25
        eta_v = eta.expand(v, k, k)
        if name == "flat_mix_variants":
            wire = master if wdt == torch.float32 else master.to(wdt)
            w32 = wire.float()
            a_pre = (gamma[:, None, None] * (
                eta_v - torch.diag_embed(eta_v.sum(dim=-1)))).contiguous()

            def run(eta=eta, master=master, wire=wire, gamma=gamma):
                return cm.flat_mix(eta, master, wire, gamma)

            def plain(eta=eta, master=master, wire=wire, gamma=gamma):
                return ref.flat_mix(eta, master, wire, gamma)

            def one(i, eta=eta, master=master, wire=wire, gamma=gamma,
                    shared=shared):
                return cm.flat_mix(eta if shared else eta[i], master[i],
                                   wire[i], gamma[i:i + 1])

            def lib(master=master, a_pre=a_pre, w32=w32):
                return torch.baddbmm(master, a_pre, w32)

            nbytes = (4 * eta.numel() + v * (8 + wire.element_size()) * k * P
                      + 4 * v)
            ops = v * (2 * k * k * P + 4 * k * P)
            shape = f"V={v} K={k} P={P} wire={str(wdt)[6:]}"
            library = "torch.baddbmm(master, gamma (eta - diag rowsum), wire)"
        else:
            def run(eta=eta, master=master):
                return cm.flat_consensus(eta, master)

            def plain(eta=eta, master=master):
                return ref.flat_consensus(eta, master)

            def one(i, eta=eta, master=master):
                return cm.flat_consensus(eta[i], master[i])

            def lib(eta=eta, master=master):
                return torch.matmul(eta, master)

            nbytes = 4 * eta.numel() + 8 * v * k * P
            ops = v * 2 * k * k * P
            shape = f"V={v} K={k} P={P}"
            library = "torch.matmul (V, K, K) @ (V, K, P)"
        shape += " eta " + ("shared (stride 0)" if shared
                            else "a variant (stride K*K)")
        out, want = run(), plain()
        torch.cuda.synchronize()
        err = (out - want).abs().max().item()
        if not torch.allclose(out, want, rtol=RTOL, atol=ATOL):
            fail(f"{name} {shape} disagrees with its plain version: max "
                 f"|diff| {err:.3e}")
        for i in range(v):
            single = one(i)
            torch.cuda.synchronize()
            if not torch.equal(out[i], single):
                fail(f"{name} {shape}: variant {i} differs from its V = 1 "
                     f"launch in {(out[i] != single).sum().item()} places")
        loop_ms, loop_graph_ms = timing(lambda v=v, one=one: [
            one(i) for i in range(v)])
        record(name, shape, err, run, plain, lib, nbytes, ops, F32_OPS_PER_S,
               extra={"variants": v, "loop_ms": loop_ms,
                      "loop_graph_ms": loop_graph_ms, "library": library})
    print(f"check variant axis: B1 (f32 shared eta, bf16 an eta a variant) "
          f"and B2 within rtol={RTOL} atol={ATOL} of their plain versions, "
          f"every variant bit for bit its V = 1 launch", flush=True)


def batched_sweeps(dev, add, expect_counts, dense_only, fleet, fleet_feds,
                   loss, train, data_by_k) -> None:
    """Batched fleet sweeps (``SweepAxes``, ``compile_batch``,
    ``BatchedSession``, ``Trainer.run_rounds_batch``): the paper's mobility
    sweep (benchmarks/paper_tables.py:185-240) and rounds to 80% over 4
    seeds for the MLP and the VGG, cdfl and cfa, 60 rounds each; the K=1024
    sparse Manhattan fleet over 4 seeds (B6 on the (4096, P) rows), the
    K=256 bf16 ring over gamma x seeds (B1 with an eta a variant) and the
    crashed K=256 ring over 2 seeds (B2 through the `sent` branch). Each
    sweep: 2 variants against their single Sessions on the card (within
    SWEEP_TOL of max |param|), the batched run on the card against the
    batched run on the CPU (K=64 for the fleets, within 1e-4); the fleets
    and the K=4 MLP: ms/round of the batch against the loop of its V
    single runs in turns (ABBA, one call), and one profiled batched round.
    Then the training CLI's ``--sweep`` on the card."""
    from repro_torch import experiment
    from repro_torch.configs.base import FaultConfig, FedConfig
    from repro_torch.configs.base import MobilityConfig
    from repro_torch.configs.paper_models import MLP_CONFIG
    from repro_torch.core import cdfl, flatten
    from repro_torch.core.cdfl import round_slice
    from repro_torch.launch import train as train_cli
    from repro_torch.mobility import mixing as mob_mixing
    from repro_torch.models import simple

    def make(fed, train_cfg, tloss, init, device=None):
        def build(var=None, swept=(), device=device):
            f, t = fed, train_cfg
            if var is not None and "gamma" in swept:
                f = dataclasses.replace(f, gamma=var["gamma"])
            if var is not None and "mobility" in swept:
                f = dataclasses.replace(f, mobility=var["mobility"])
            if var is not None and "lr" in swept:
                t = dataclasses.replace(t, learning_rate=var["lr"])
            return experiment.Experiment.from_parts(tloss, init, fed=f,
                                                    train=t, device=device)
        return build

    def swept(axes):
        return tuple(n for n in ("seeds", "lr", "gamma", "mobility")
                     if getattr(axes, n) is not None)

    def check_variants(label, build, data, items, axes, compile_kw,
                       expect, rounds=SWEEP_CHECK_ROUNDS, gated=True):
        """run_batch on the card (the path: counts zeroed before, read
        after) and 2 variants against their single Sessions: params within
        SWEEP_TOL of max |param|, metrics within rtol 1e-4 / atol 1e-5
        (``gated`` False: the params' difference is reported only)."""
        reset_counts()
        bs = build().compile_batch(data, items, axes, **compile_kw)
        res = bs.run_batch(rounds)
        torch.cuda.synchronize()
        counts = read_counts()
        expect_counts(f"sweep {label}", counts, expect)
        add(counts)
        worst = 0.0
        v = res.num_variants
        for i in (0, v - 1):
            var = res.variants[i]
            kw = dict(compile_kw)
            if var["seed"] is not None:
                kw.update(rng=var["seed"], sample_rng=var["seed"] + 1)
            single = build(var, swept(axes)).compile(data, items, **kw).run(
                rounds)
            want = single.state.buf
            worst = max(worst, ((res.state.buf[i] - want).abs().max()
                                / want.abs().max()).item())
            for name, series in single.metrics.items():
                if gated and not torch.allclose(res.metrics[name][i], series,
                                                rtol=1e-4, atol=1e-5):
                    fail(f"sweep {label}: variant {i}'s {name} differs from "
                         f"its single Session's")
        if gated and not worst <= SWEEP_TOL:
            fail(f"sweep {label}: a variant differs from its single Session "
                 f"by {worst:.3e} of max |param| > {SWEEP_TOL}")
        return res, counts, worst

    def check_step(label, build, data, items, axes, compile_kw):
        """One local step's per-node losses and flat gradient of the V
        variants as V·K node rows (what the batched forward and backward
        compute) against each variant's K rows alone, from the batch's
        initial params and round 0's first batch: max |diff| / max |value|
        <= SWEEP_TOL."""
        exp = build()
        bs = exp.compile_batch(data, items, axes, **compile_kw)
        v, k, p = bs.states.buf.shape
        sel = bs.batch_indices(0, 1)[:, 0, :, 0].to(dev)     # (V, K, B)
        node = torch.arange(k, device=dev)[:, None]

        def step(buf, sel):
            buf = buf.reshape(-1, p).detach().requires_grad_(True)
            batch = {n: x[node, sel].flatten(0, sel.dim() - 2)
                     for n, x in bs.data.items()}
            losses = exp.loss_fn(flatten.unflatten(buf, bs.states.layout),
                                 batch)
            (grad,) = torch.autograd.grad(losses.sum(), buf)
            return losses.detach(), grad

        losses, grad = step(bs.states.buf, sel)
        one = [step(bs.states.buf[i], sel[i]) for i in range(v)]
        want_l = torch.cat([o[0] for o in one])
        want_g = torch.cat([o[1] for o in one])
        errs = (rel_diff(losses, want_l), rel_diff(grad, want_g))
        if not max(errs) <= SWEEP_TOL:
            fail(f"sweep {label}: one step of {v * k} node rows differs from "
                 f"its variants' steps alone: losses {errs[0]:.3e}, gradient "
                 f"{errs[1]:.3e} of max |value| > {SWEEP_TOL}")
        return errs

    def check_cpu(label, build, data, items, axes, compile_kw):
        """The batched run on the card against the batched run on the CPU,
        3 rounds, within 1e-4."""
        runs = [build(device=d).compile_batch(data, items, axes,
                                              **compile_kw).run_batch(3)
                for d in (None, "cpu")]
        diff = (runs[0].state.buf.cpu() - runs[1].state.buf).abs().max()
        if not diff.item() <= 1e-4:
            fail(f"sweep {label}: the card's batched run differs from the "
                 f"CPU's by {diff.item():.3e} > 1e-4")
        return diff.item()

    def paired(label, tr, stacked, data_dev, etas, gammas, shared, idx,
               n_items=None):
        """ms/round of the batch (run_rounds_batch) against the loop of
        its V single runs (run_rounds), on the same stacks and indices
        keyed on the absolute round, in turns batch, loop, loop, batch;
        then one batched round under the profiler."""
        v = stacked.buf.shape[0]
        box = [stacked]
        singles = [cdfl.select_state(stacked, i) for i in range(v)]

        def batched(n):
            r = int(box[0].round[0])
            sl = slice(r, r + n)
            box[0], _ = tr.run_rounds_batch(
                box[0], data_dev, n, idx=idx[:, sl], n_items=n_items,
                eta_stacks=round_slice(etas, sl if shared
                                       else (slice(None), sl)),
                gamma_stacks=gammas[:, sl])

        def loop(n):
            for i in range(v):
                r = singles[i].round
                sl = slice(r, r + n)
                singles[i], _ = tr.run_rounds(
                    singles[i], data_dev, n, idx=idx[i, sl], n_items=n_items,
                    eta_stack=round_slice(etas, sl if shared else (i, sl)),
                    gamma_stack=gammas[i, sl])

        batched(1)
        loop(1)                                  # warm-up rounds
        b_ms, l_ms, b_all, l_all = paired_ms(batched, loop, SWEEP_BLOCKS,
                                             SWEEP_TURN)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            batched(1)
            torch.cuda.synchronize()
            prof_ms = 1e3 * (time.perf_counter() - t0)
        busy, n_dev = device_profile(prof)
        busy_ms = sum(busy.values())
        if busy_ms <= 0:
            fail(f"profile sweep {label}: the batched round shows no device "
                 f"time")
        top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
        print(f"paired sweep {label} V={v} ms/round (turns batch, loop, "
              f"loop, batch, {SWEEP_BLOCKS}x, {SWEEP_TURN} rounds a turn): "
              f"batch={b_ms:.3f} loop of {v} runs={l_ms:.3f} "
              f"speedup={l_ms / b_ms:.2f}x turns batch="
              f"{[round(t, 3) for t in b_all]} loop="
              f"{[round(t, 3) for t in l_all]}", flush=True)
        print(f"profile sweep {label} batched round: wall_ms={prof_ms:.3f} "
              f"device_busy_ms={busy_ms:.3f} busy_share="
              f"{busy_ms / prof_ms:.4f} device_events={n_dev} top="
              f"{[(n, round(t, 4)) for n, t in top]}", flush=True)

    t_phase = time.perf_counter()
    # -- 13a. the paper's mobility sweep (paper_tables.mobility_sweep) ----
    # MLP 784-30-10, K=4, the four scenarios, 60 rounds, one compile_batch
    # over the mobility axis per algorithm, compile(rng=0, sample_rng=0)
    scens = list(MOBILITY_SCENARIOS)
    mob_axis = [None if m is None else MobilityConfig(**m)
                for m in MOBILITY_SCENARIOS.values()]
    for alg in ("cdfl", "cfa"):
        (tloss, init, eval_fn, train_cfg, steps, raw_items, data,
         n_items) = table_setup("mlp", alg)
        build = make(FedConfig(num_nodes=4, local_steps=steps,
                               algorithm=alg), train_cfg, tloss, init)
        axes = experiment.SweepAxes(mobility=mob_axis)
        kw = dict(rng=0, sample_rng=0, n_items=n_items)
        reset_counts()
        t0 = time.perf_counter()
        res = build().compile_batch(data, raw_items, axes, **kw).run_batch(
            TABLE_ROUNDS, callbacks=[experiment.EvalCallback(eval_fn(dev))])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        expect_counts(f"sweep mobility {alg}", counts, {
            "flat_mix": TABLE_ROUNDS, "flat_mix_variants": TABLE_ROUNDS,
            "flat_consensus": 0, "cnd_bitmaps": 1, "cnd_popcount": 1,
            **dense_only})
        add(counts)
        acc = res.metrics["eval"].cpu().numpy()            # (V, R, K)
        for i, scen in enumerate(scens):
            to_80, reached = rounds_to_80(acc[i])
            print(f"sweep mobility mlp {alg} {scen}: rounds_to_80/node="
                  f"{to_80.tolist()} mean={float(np.mean(to_80)):.2f} "
                  f"reached={reached.tolist()} final_acc/node="
                  f"{[round(float(a), 4) for a in acc[i, -1]]}", flush=True)
        _, _, worst = check_variants(f"mobility {alg}", build, data,
                                     raw_items, axes, kw, {
                                         "flat_mix": SWEEP_CHECK_ROUNDS})
        print(f"path sweep mobility mlp {alg}: V={len(scens)} K=4 "
              f"R={TABLE_ROUNDS} wall_s={wall:.2f} ms/round="
              f"{1e3 * wall / TABLE_ROUNDS:.3f} launches={counts} variants "
              f"0 and 3 against their single Sessions over "
              f"{SWEEP_CHECK_ROUNDS} rounds max|diff|/max|param|="
              f"{worst:.3e} (<= {SWEEP_TOL})", flush=True)

    # -- 13b. rounds to 80% over 4 seeds: MLP and VGG, cdfl and cfa -------
    for model in ("mlp", "vgg"):
        for alg in ("cdfl", "cfa"):
            (tloss, init, eval_fn, train_cfg, steps, raw_items, data,
             n_items) = table_setup(model, alg)
            build = make(FedConfig(num_nodes=4, local_steps=steps,
                                   algorithm=alg), train_cfg, tloss, init)
            axes = experiment.SweepAxes(seeds=SWEEP_SEEDS)
            kw = dict(n_items=n_items)
            reset_counts()
            t0 = time.perf_counter()
            res = build().compile_batch(data, raw_items, axes,
                                        **kw).run_batch(
                TABLE_ROUNDS,
                callbacks=[experiment.EvalCallback(eval_fn(dev))])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            expect_counts(f"sweep seeds {model} {alg}", counts, {
                "flat_mix": TABLE_ROUNDS, "flat_mix_variants": TABLE_ROUNDS,
                "flat_consensus": 0, "cnd_bitmaps": SWEEP_SEEDS,
                "cnd_popcount": SWEEP_SEEDS, **dense_only})
            add(counts)
            acc = res.metrics["eval"].cpu().numpy()        # (V, R, K)
            per_seed = [float(np.mean(rounds_to_80(acc[i])[0]))
                        for i in range(SWEEP_SEEDS)]
            # the VGG's ReLU gates flip on f32 rounding within a round
            # (ROADMAP C): its variants are gated one step at a time, and
            # their drift from the single Sessions is reported
            vgg = model == "vgg"
            _, _, worst = check_variants(
                f"seeds {model} {alg}", build, data, raw_items, axes, kw,
                {"flat_mix": SWEEP_CHECK_ROUNDS}, gated=not vgg)
            step_errs = (check_step(f"seeds {model} {alg}", build, data,
                                    raw_items, axes, kw) if vgg else None)
            print(f"sweep seeds {model} {alg}: rounds_to_80 mean over "
                  f"stations per seed={per_seed} mean={np.mean(per_seed):.2f}"
                  f" std={np.std(per_seed):.2f} min={min(per_seed):.2f} "
                  f"max={max(per_seed):.2f} final_acc mean per seed="
                  f"{[round(float(a), 4) for a in acc[:, -1].mean(axis=-1)]} "
                  f"wall_s={wall:.2f} ms/round={1e3 * wall / TABLE_ROUNDS:.3f}"
                  f" launches={counts} seeds 0 and 3 against their single "
                  f"Sessions over {SWEEP_CHECK_ROUNDS} rounds "
                  f"max|diff|/max|param|={worst:.3e} "
                  + (f"(reported; one step of the {SWEEP_SEEDS * 4} node "
                     f"rows against each seed's 4: losses "
                     f"{step_errs[0]:.3e} gradient {step_errs[1]:.3e} <= "
                     f"{SWEEP_TOL})" if vgg else f"(<= {SWEEP_TOL})"),
                  flush=True)
            if model == "mlp" and alg == "cdfl":
                diff = check_cpu("seeds mlp cdfl", build, data, raw_items,
                                 axes, kw)
                print(f"check sweep seeds mlp cdfl 3 rounds card-vs-cpu "
                      f"max|param diff|={diff:.3e} (<= 1e-4)", flush=True)
                # the K=4 MLP's batch against its loop of 4 runs
                bs = build().compile_batch(data, raw_items, axes, **kw)
                tr = build().trainer(bs.data)
                etas, gammas = tr.mixing_stack(
                    cdfl.select_state(bs.states, 0), 40)
                paired("mlp K=4 seeds", tr, bs.states, bs.data, etas,
                       gammas.expand(SWEEP_SEEDS, 40), True,
                       bs.batch_indices(0, 40), n_items=n_items)

    # -- 13c. the fleets ---------------------------------------------------
    fleet_cases = [
        # label, FedConfig, axes, data key, expected exchange launches a
        # round (kernel, variant-axis name or None)
        (f"fleet sparse K={FLEET_K} Manhattan bf16", fleet_feds["sparse"],
         experiment.SweepAxes(seeds=SWEEP_SEEDS), FLEET_K,
         ("cluster_mix", None)),
        (f"ring K={SWEEP_RING_K} bf16 gamma x seeds", FedConfig(
            num_nodes=SWEEP_RING_K, topology="ring", gamma=0.5,
            local_steps=10, wire_dtype="bf16"),
         experiment.SweepAxes(seeds=2, gamma=[0.5, 0.8]), SWEEP_RING_K,
         ("flat_mix", "flat_mix_variants")),
        (f"ring K={SWEEP_RING_K} crash", FedConfig(
            num_nodes=SWEEP_RING_K, topology="ring", gamma=0.5,
            local_steps=10, faults=FaultConfig(**SWEEP_CRASH)),
         experiment.SweepAxes(seeds=2), SWEEP_RING_K,
         ("flat_consensus", "flat_consensus_variants"))]
    def p_init(gen):
        return simple.mlp_init(gen, MLP_CONFIG, device="cpu")

    for label, fed, axes, k, (kernel, variant_name) in fleet_cases:
        data, items = data_by_k[k]
        build = make(fed, train, loss, p_init)
        expect = {kernel: SWEEP_CHECK_ROUNDS,
                  "cnd_bitmaps": len(axes.seed_list()),
                  "cnd_popcount": len(axes.seed_list())}
        if variant_name:
            expect[variant_name] = SWEEP_CHECK_ROUNDS
        for other in ("flat_mix", "flat_consensus", "sparse_mix",
                      "cluster_mix", "robust_agg"):
            expect.setdefault(other, 0)
        res, counts, worst = check_variants(label, build, data, items, axes,
                                            {}, expect)
        health = ""
        if "health" in res.metrics:
            health = (f" crashed node-rounds="
                      f"{int((res.metrics['health'] == 0).sum().item())}")
        loss_rounds = res.metrics["loss"].mean(dim=-1).tolist()
        print(f"path sweep {label}: V={res.num_variants} "
              f"R={SWEEP_CHECK_ROUNDS} loss/round per variant="
              f"{[[round(x, 4) for x in r] for r in loss_rounds]}"
              f"{health} launches={counts} variants 0 and "
              f"{res.num_variants - 1} against their single Sessions "
              f"max|diff|/max|param|={worst:.3e} (<= {SWEEP_TOL})",
              flush=True)
        # at K=64 with the f32 wire, as the fleets' own checks (a bf16
        # wire drifts by whole bf16 steps between summation orders)
        data64, items64 = data_by_k[64]
        small = make(dataclasses.replace(fed, num_nodes=64,
                                         wire_dtype="f32"), train, loss,
                     p_init)
        diff = check_cpu(label + " K=64", small, data64, items64, axes, {})
        print(f"check sweep {label} at K=64 wire=f32 3 rounds card-vs-cpu "
              f"max|param diff|={diff:.3e} (<= 1e-4)", flush=True)
        # the batch against its loop, on stacks built once for the horizon
        bs = build().compile_batch(data, items, axes)
        tr = build().trainer(bs.data)
        state0 = cdfl.select_state(bs.states, 0)
        horizon = FLEET_ROUNDS
        if kernel == "cluster_mix":
            etas, gammas, shared = fleet["sparse"][1], fleet["sparse"][2], True
        elif axes.gamma is not None:
            stacks = [tr.mixing_stack(state0, horizon, gamma_cap=v["gamma"])
                      for v in bs.variants]
            etas = mob_mixing.stack_variant_stacks([e for e, _ in stacks])
            gammas = torch.stack([g for _, g in stacks])
            shared = False
        else:
            etas, gammas = tr.mixing_stack(state0, horizon)
            shared = True
        if shared:
            gammas = gammas.expand(bs.num_variants, horizon)
        paired(label, tr, bs.states, bs.data, etas, gammas, shared,
               bs.batch_indices(0, horizon))
        del bs, tr, etas, gammas
        torch.cuda.empty_cache()

    # -- 13d. the training CLI's --sweep on the card ----------------------
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        state, losses = train_cli.main(["--quick", "--rounds",
                                        str(CLI_ROUNDS), "--sweep",
                                        "seeds=2,lr=1e-3:3e-3"])
    torch.cuda.synchronize()
    lines = out.getvalue().splitlines()
    counts = read_counts()
    # one B9 launch a layer, node row and local step: 4 variants x 4 nodes
    expect_counts("train cli --sweep", counts, {
        "flat_mix": CLI_ROUNDS, "flat_mix_variants": CLI_ROUNDS,
        "cnd_bitmaps": 2, "cnd_popcount": 2,
        "flash_attention": CLI_ROUNDS * 4 * 16 * 2})
    add(counts)
    verdict = [ln for ln in lines if ln.startswith("SWEEP_SMOKE")]
    if len(verdict) != 1 or not verdict[0].startswith("SWEEP_SMOKE ok "):
        fail(f"train cli --sweep: no 'SWEEP_SMOKE ok' line: {lines[-8:]}")
    table = [ln for ln in lines if ln.startswith("sweep:") or
             ln.lstrip().startswith(("variant", "0 ", "1 ", "2 ", "3 "))]
    print(f"path train cli --sweep seeds=2,lr=1e-3:3e-3: {table} "
          f"losses (V, R, K)={tuple(losses.shape)} launches={counts} "
          f"{verdict[0]}", flush=True)
    print(f"phase batched sweeps {time.perf_counter() - t_phase:.1f}s",
          flush=True)


def transports_and_ingest(dev, add, expect_counts, dense_only, loss, train,
                          p0, fleet, fleet_feds, data_by_k) -> None:
    """The ring and gossip transports and the redundancy-aware ingest on the
    card, each path's launches counted and held against the port's CPU run
    within 1e-4: the ring at K=4 (no kernel: the roll form) against the
    CPU and against the dense transport (B1) on the ring, and at K=256
    with a bf16 wire against dense in turns; gossip with snapshots 2
    rounds old: dense at K=4 (B2), the K=1024 Manhattan sparse bf16 fleet
    (B6, timed in turns against the dense transport's B5; at K=64 against
    the CPU) and the crashed K=256 ring (B2 through the fault payloads);
    ``staleness=0`` bit for bit the dense transport (K=4 B1, K=64 sparse
    B5); a Session resumed with its bf16 snapshots; the training CLI's
    gossip ``--sweep``; ingest on the paper K=4 MLP (duplicate_heavy,
    sampling and mixing, drift; the card's weighted indices equal to the
    CPU's, its sketches bit for bit) and on the K=1024 sparse fleet
    (sensor_overlap, B5), each timed in turns against the ingest-free run,
    with the ``IngestCallback`` line."""
    from repro_torch import experiment
    from repro_torch.configs.base import FaultConfig, FedConfig, IngestConfig
    from repro_torch.configs.paper_models import MLP_CONFIG
    from repro_torch.core import cdfl
    from repro_torch.core.cdfl import round_slice
    from repro_torch.ingest import weighting
    from repro_torch.launch import train as train_cli
    from repro_torch.models import simple

    t_phase = time.perf_counter()
    idle = {"flat_mix": 0, "flat_consensus": 0, **dense_only}
    data4, items4 = data_by_k[4]
    data64, items64 = data_by_k[64]
    data256, items256 = data_by_k[256]
    data1024, items1024 = data_by_k[FLEET_K]

    def inputs(fed, rounds, n, seed):
        """(R, K, S, B) batch indices, or the uniforms that
        duplicate-corrected ingest sampling maps to indices."""
        shape = (rounds, fed.num_nodes, fed.local_steps, train.batch_size)
        gen = torch.Generator().manual_seed(seed)
        ing = fed.ingest
        if ing is not None and ing.active and ing.correct_sampling:
            return torch.rand(shape, generator=gen)
        return torch.randint(0, n, shape, generator=gen)

    def on_card(fed, rounds, seed, data, items, label, expect,
                stacks=None):
        """One warm-up round, then ``rounds`` rounds on the card with the
        launch counts zeroed before and checked after. Returns (trainer,
        state, metrics, counts, ms/round, inputs of all rounds)."""
        idx = inputs(fed, rounds + 1, data["x"].shape[1], seed)

        def kw(lo, hi):
            return {} if stacks is None else dict(
                eta_stack=round_slice(stacks[0], slice(lo, hi)),
                gamma_stack=stacks[1][lo:hi])

        tr = cdfl.build_trainer(loss, fed, train)
        d = {n: torch.as_tensor(v, device=dev) for n, v in data.items()}
        state, _ = tr.run_rounds(tr.init(p0, items), d, 1, idx=idx[:1],
                                 **kw(0, 1))
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, metrics = tr.run_rounds(state, d, rounds, idx=idx[1:],
                                       **kw(1, rounds + 1))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / rounds
        counts = read_counts()
        expect_counts(label, counts, {**idle, "cnd_bitmaps": 0,
                                      "cnd_popcount": 0, **expect})
        add(counts)
        if not torch.isfinite(metrics["loss"]).all():
            fail(f"{label}: non-finite loss")
        return tr, final, metrics, counts, ms, idx

    def against_cpu(label, fed, data, items, idx, card):
        """The same rounds on the CPU from the same init and inputs: max
        |param diff| <= 1e-4, gossip snapshots too; ingest sketches bit
        for bit."""
        tr = cdfl.build_trainer(loss, fed, train, device="cpu")
        final, metrics = tr.run_rounds(tr.init(p0, items), data,
                                       idx.shape[0], idx=idx)
        diff = (card.buf.cpu() - final.buf).abs().max().item()
        if isinstance(card.tstate, torch.Tensor):
            diff = max(diff, (card.tstate.cpu().float()
                              - final.tstate.float()).abs().max().item())
        if not diff <= 1e-4:
            fail(f"{label}: the card's run differs from the CPU's by "
                 f"{diff:.3e} > 1e-4")
        for name, a in getattr(card.istate, "_asdict", dict)().items():
            if not torch.equal(a.cpu(), getattr(final.istate, name)):
                fail(f"{label}: the card's sketch {name} differs from the "
                     f"CPU's")
        return diff, metrics

    def runner(tr, state, data, seed, stacks=None):
        """``run(n)``: n more rounds from where the last call left off,
        batches drawn from a generator; with ``stacks`` every call reads
        rounds [0, n) of the stacks (timing only)."""
        box = [state]
        gen = torch.Generator().manual_seed(seed)
        d = {n: torch.as_tensor(v, device=dev) for n, v in data.items()}

        def run(n: int) -> None:
            kw = {} if stacks is None else dict(
                eta_stack=round_slice(stacks[0], slice(0, n)),
                gamma_stack=stacks[1][:n])
            box[0], _ = tr.run_rounds(box[0], d, n, generator=gen, **kw)

        return run

    def turns(label, a, b, names, rounds=3):
        """ms/round of runners ``a`` and ``b`` in turns (ABBA), then one
        round of each under the profiler: wall, device busy, busy share,
        the top kernels."""
        a_ms, b_ms, a_all, b_all = paired_ms(a, b, blocks=2, rounds=rounds)
        print(f"paired {label} ms/round (turns {names[0]}, {names[1]}, "
              f"{names[1]}, {names[0]}, twice, {rounds} rounds a turn): "
              f"{names[0]}={a_ms:.3f} {names[1]}={b_ms:.3f} "
              f"ratio={a_ms / b_ms:.3f} turns {names[0]}="
              f"{[round(t, 3) for t in a_all]} {names[1]}="
              f"{[round(t, 3) for t in b_all]}", flush=True)
        for name, run in zip(names, (a, b)):
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run(1)
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0)
            busy, n_dev = device_profile(prof)
            busy_ms = sum(busy.values())
            if busy_ms <= 0:
                fail(f"profile {label} {name}: the round shows no device "
                     f"time")
            top = sorted(busy.items(), key=lambda kv: -kv[1])[:5]
            print(f"profile {label} {name} round: wall_ms={wall:.3f} "
                  f"device_busy_ms={busy_ms:.3f} busy_share="
                  f"{busy_ms / wall:.4f} device_events={n_dev} top="
                  f"{[(n, round(v, 4)) for n, v in top]}", flush=True)

    # -- 14a. the ring at K=4 (paper MLP), against the CPU and dense -------
    fed4 = FedConfig(num_nodes=4, topology="ring", gamma=0.5, local_steps=10)
    ring4 = dataclasses.replace(fed4, transport="ring")
    tr_r, ring_fin, _, counts, ring_ms, idx = on_card(
        ring4, 10, 41, data4, items4, "ring K=4", {})
    d_cpu, _ = against_cpu("ring K=4", ring4, data4, items4, idx, ring_fin)
    tr_d, dense_fin, _, _, dense_ms, _ = on_card(
        fed4, 10, 41, data4, items4, "dense K=4", {"flat_mix": 10})
    d_dense = (ring_fin.buf - dense_fin.buf).abs().max().item()
    if not d_dense <= 1e-4:
        fail(f"ring K=4: the ring transport differs from the dense one (B1) "
             f"on the ring by {d_dense:.3e} > 1e-4")
    print(f"path ring K=4 f32 10 rounds: launches={counts} (the roll form, "
          f"no kernel) card-vs-cpu max|param diff|={d_cpu:.3e} ring-vs-dense"
          f" (B1 on the ring topology) max|param diff|={d_dense:.3e} (<= "
          f"1e-4) card ms/round ring={ring_ms:.3f} dense={dense_ms:.3f}",
          flush=True)
    turns("ring K=4 f32", runner(tr_r, ring_fin, data4, 42),
          runner(tr_d, dense_fin, data4, 42), ("ring", "dense"))

    # -- 14b. the ring at K=256, bf16 wire, against dense -----------------
    fed256 = FedConfig(num_nodes=256, topology="ring", gamma=0.5,
                       local_steps=10, wire_dtype="bf16")
    ring256 = dataclasses.replace(fed256, transport="ring")
    tr_r, ring_fin, _, counts, ring_ms, _ = on_card(
        ring256, 3, 43, data256, items256, "ring K=256 bf16", {})
    tr_d, dense_fin, _, _, dense_ms, _ = on_card(
        fed256, 3, 43, data256, items256, "dense K=256 bf16",
        {"flat_mix": 3})
    rel = rel_diff(ring_fin.buf, dense_fin.buf)
    print(f"path ring K=256 bf16 3 rounds: launches={counts} ring-vs-dense "
          f"(B1 on the ring topology) max|param diff|/max|param|={rel:.3e} "
          f"(reported: a bf16 wire moves by whole bf16 steps between "
          f"summation orders) card ms/round ring={ring_ms:.3f} dense="
          f"{dense_ms:.3f}", flush=True)
    turns("ring K=256 bf16", runner(tr_r, ring_fin, data256, 44),
          runner(tr_d, dense_fin, data256, 44), ("ring", "dense"))
    del tr_r, tr_d, ring_fin, dense_fin

    # -- 14c. gossip, snapshots 2 rounds old: dense K=4 (B2) -------------
    gossip4 = dataclasses.replace(fed4, transport="gossip",
                                  staleness=GOSSIP_S)
    _, g_fin, _, counts, g_ms, idx = on_card(
        gossip4, 10, 45, data4, items4, "gossip K=4", {"flat_consensus": 10})
    d_cpu, _ = against_cpu("gossip K=4", gossip4, data4, items4, idx, g_fin)
    print(f"path gossip K=4 s={GOSSIP_S} f32 10 rounds: launches={counts} "
          f"snapshots {tuple(g_fin.tstate.shape)} {g_fin.tstate.dtype} "
          f"card-vs-cpu max|param and snapshot diff|={d_cpu:.3e} (<= 1e-4) "
          f"card ms/round={g_ms:.3f}", flush=True)

    # -- 14d. staleness=0 is the dense transport, bit for bit -------------
    sparse64 = dataclasses.replace(fleet_feds["sparse"], num_nodes=64,
                                   wire_dtype="f32")
    for label, fed, data, items, kernel in (
            ("K=4 dense", fed4, data4, items4, "flat_mix"),
            ("K=64 sparse Manhattan", sparse64, data64, items64,
             "sparse_mix")):
        runs = [on_card(f, 3, 46, data, items, f"{label} {name}",
                        {kernel: 3})
                for name, f in (("gossip s=0", dataclasses.replace(
                    fed, transport="gossip", staleness=0)),
                    ("dense", fed))]
        (_, a, ma, counts, _, _), (_, b, mb, _, _, _) = runs
        if not (torch.equal(a.buf, b.buf) and torch.equal(a.opt.m, b.opt.m)
                and all(torch.equal(ma[n], mb[n]) for n in mb)):
            fail(f"gossip s=0 {label}: not bit for bit the dense transport "
                 f"(max |buf diff| {(a.buf - b.buf).abs().max().item():.3e})")
        print(f"check gossip s=0 {label} 3 rounds: params, Adam moments and "
              f"metrics equal the dense transport's bit for bit; launches="
              f"{counts}", flush=True)

    # -- 14e. gossip on the K=1024 Manhattan sparse bf16 fleet (B6) -------
    _, etas, gammas = fleet["sparse"]
    gfleet = dataclasses.replace(fleet_feds["sparse"], transport="gossip",
                                 staleness=GOSSIP_S)
    tr_g, g_fin, g_met, counts, g_ms, _ = on_card(
        gfleet, TI_ROUNDS, 47, data1024, items1024,
        f"gossip fleet K={FLEET_K}", {"cluster_mix": TI_ROUNDS},
        stacks=(etas, gammas))
    tr_d, d_fin, _, _, d_ms, _ = on_card(
        fleet_feds["sparse"], TI_ROUNDS, 47, data1024, items1024,
        f"fleet sparse K={FLEET_K}", {"sparse_mix": TI_ROUNDS},
        stacks=(etas, gammas))
    snap = g_fin.tstate
    print(f"path gossip fleet sparse K={FLEET_K} bf16 Manhattan s="
          f"{GOSSIP_S}: launches={counts} snapshots {tuple(snap.shape)} "
          f"{snap.dtype} {snap.numel() * snap.element_size()} bytes loss/"
          f"round={[round(v, 4) for v in g_met['loss'].mean(dim=1).tolist()]}"
          f" card ms/round gossip={g_ms:.3f} dense={d_ms:.3f}", flush=True)
    turns(f"gossip fleet K={FLEET_K}", runner(tr_g, g_fin, data1024, 48,
                                              (etas, gammas)),
          runner(tr_d, d_fin, data1024, 48, (etas, gammas)),
          ("gossip", "dense"), rounds=2)
    del tr_g, tr_d, g_fin, d_fin, snap
    g64 = dataclasses.replace(gfleet, num_nodes=64, wire_dtype="f32")
    _, fin, _, counts, _, idx = on_card(g64, 3, 49, data64, items64,
                                        "gossip fleet K=64",
                                        {"cluster_mix": 3})
    diff, _ = against_cpu("gossip fleet K=64", g64, data64, items64, idx,
                          fin)
    print(f"check gossip fleet sparse K=64 wire=f32 s={GOSSIP_S} 3 rounds "
          f"card-vs-cpu max|param and snapshot diff|={diff:.3e} (<= 1e-4) "
          f"launches={counts}", flush=True)

    # -- 14f. gossip on the crashed K=256 ring (B2, fault payloads) -------
    crash = FaultConfig(**SWEEP_CRASH)
    gcrash = FedConfig(num_nodes=256, topology="ring", gamma=0.5,
                       local_steps=10, transport="gossip",
                       staleness=GOSSIP_S, faults=crash)
    _, fin, met, counts, c_ms, _ = on_card(
        gcrash, TI_ROUNDS, 50, data256, items256, "gossip crash K=256",
        {"flat_consensus": TI_ROUNDS})
    crashed = int((met["health"] == 0).sum().item())
    print(f"path gossip crash K=256 ring s={GOSSIP_S}: crashed node-rounds="
          f"{crashed} launches={counts} card ms/round={c_ms:.3f}",
          flush=True)
    g64 = dataclasses.replace(gcrash, num_nodes=64)
    _, fin, met, counts, _, idx = on_card(g64, 3, 51, data64, items64,
                                          "gossip crash K=64",
                                          {"flat_consensus": 3})
    diff, _ = against_cpu("gossip crash K=64", g64, data64, items64, idx, fin)
    print(f"check gossip crash K=64 3 rounds card-vs-cpu max|param and "
          f"snapshot diff|={diff:.3e} (<= 1e-4) crashed node-rounds="
          f"{int((met['health'] == 0).sum().item())} launches={counts}",
          flush=True)

    # -- 14g. a Session resumed with its bf16 snapshots, bit for bit ------
    gexp = experiment.Experiment.from_parts(
        loss, lambda g: simple.mlp_init(g, MLP_CONFIG),
        fed=dataclasses.replace(gossip4, wire_dtype="bf16"), train=train)
    check_resume(f"gossip K=4 bf16 s={GOSSIP_S}", gexp, data4, items4, add,
                 expect_counts, dense_only, expect={
                     **idle, "flat_consensus": 40, "cnd_bitmaps": 3,
                     "cnd_popcount": 3})

    # -- 14h. the training CLI's gossip --sweep ---------------------------
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        _, losses = train_cli.main(["--quick", "--rounds", str(CLI_ROUNDS),
                                    "--sweep", "seeds=2", "--transport",
                                    "gossip", "--staleness", str(GOSSIP_S)])
    torch.cuda.synchronize()
    lines = out.getvalue().splitlines()
    counts = read_counts()
    # B2 with a variant axis a round; B9 a layer, node row and local step:
    # 2 variants x 4 nodes
    expect_counts("train cli --sweep gossip", counts, {
        "flat_mix": 0, "flat_consensus": CLI_ROUNDS,
        "flat_consensus_variants": CLI_ROUNDS, "cnd_bitmaps": 2,
        "cnd_popcount": 2, "flash_attention": CLI_ROUNDS * 4 * 8 * 2})
    add(counts)
    verdict = [ln for ln in lines if ln.startswith("SWEEP_SMOKE")]
    if len(verdict) != 1 or not verdict[0].startswith("SWEEP_SMOKE ok "):
        fail(f"train cli gossip --sweep: no 'SWEEP_SMOKE ok' line: "
             f"{lines[-8:]}")
    print(f"path train cli --sweep seeds=2 --transport gossip --staleness "
          f"{GOSSIP_S}: losses (V, R, K)={tuple(losses.shape)} launches="
          f"{counts} {verdict[0]}", flush=True)

    # -- 14i. ingest on the paper K=4 MLP ---------------------------------
    def recording(store):
        """weighting.weighted_indices, its outputs kept on the host."""
        real = weighting.weighted_indices

        def fn(u, w):
            out = real(u, w)
            store.append(out.cpu())
            return out

        return unittest.mock.patch.object(weighting, "weighted_indices", fn)

    ifed = dataclasses.replace(fed4, ingest=IngestConfig(**INGEST_K4))
    exps = {d: experiment.Experiment.from_parts(
        loss, lambda g: simple.mlp_init(g, MLP_CONFIG), fed=ifed,
        train=train, device=d) for d in (None, "cpu")}
    picked = {None: [], "cpu": []}
    lines, results = [], {}
    reset_counts()
    for d, exp in exps.items():
        with recording(picked[d]):
            results[d] = exp.compile(data4, items4).run(
                10, callbacks=[experiment.IngestCallback(lines.append)])
        if d is None:
            torch.cuda.synchronize()
            counts = read_counts()
            expect_counts("ingest K=4", counts, {
                **idle, "flat_mix": 10, "cnd_bitmaps": 1,
                "cnd_popcount": 1})
            add(counts)
    card, cpu = results[None], results["cpu"]
    flips = sum(int((a != b).sum()) for a, b in zip(picked[None],
                                                    picked["cpu"]))
    n_picked = sum(a.numel() for a in picked[None])
    if flips or len(picked[None]) != 10:
        fail(f"ingest K=4: the card's weighted indices differ from the "
             f"CPU's in {flips} of {n_picked}")
    diff = (card.state.buf.cpu() - cpu.state.buf).abs().max().item()
    if not diff <= 1e-4:
        fail(f"ingest K=4: the card's run differs from the CPU's by "
             f"{diff:.3e} > 1e-4")
    for name, a in card.state.istate._asdict().items():
        if not torch.equal(a.cpu(), getattr(cpu.state.istate, name)):
            fail(f"ingest K=4: the card's sketch {name} differs from the "
                 f"CPU's")
    est_diff = rel_diff(card.metrics["est_distinct"].cpu(),
                        cpu.metrics["est_distinct"])
    drift = card.metrics["drift"].cpu()
    if lines[0] != lines[1] or not torch.equal(drift, cpu.metrics["drift"]):
        fail(f"ingest K=4: the card's IngestCallback line or drift differs "
             f"from the CPU's: {lines}")
    print(f"path ingest K=4 {INGEST_K4} 10 rounds (Session.run): launches="
          f"{counts} weighted indices equal to the CPU's ({n_picked}, 0 "
          f"flips) sketches (cm, hll, seen) bit for bit card-vs-cpu "
          f"max|param diff|={diff:.3e} (<= 1e-4) est_distinct rel diff="
          f"{est_diff:.3e} drift/round="
          f"{[round(v, 3) for v in drift.mean(dim=1).tolist()]}", flush=True)
    print(f"ingest callback K=4: {lines[0]}", flush=True)
    free = experiment.Experiment.from_parts(
        loss, lambda g: simple.mlp_init(g, MLP_CONFIG), fed=fed4,
        train=train)
    s_ing, s_free = (e.compile(data4, items4) for e in (exps[None], free))
    s_ing.run(1)
    s_free.run(1)                               # warm-up rounds
    turns("ingest K=4", s_ing.run, s_free.run, ("ingest", "free"))
    del s_ing, s_free

    # -- 14j. ingest on the K=1024 sparse fleet (sensor_overlap, B5) ------
    ifleet = dataclasses.replace(fleet_feds["sparse"],
                                 ingest=IngestConfig(**INGEST_FLEET))
    tr_i, i_fin, i_met, counts, i_ms, _ = on_card(
        ifleet, TI_ROUNDS, 52, data1024, items1024,
        f"ingest fleet K={FLEET_K}", {"sparse_mix": TI_ROUNDS},
        stacks=(etas, gammas))
    lines = []
    experiment.IngestCallback(lines.append).on_run_end(
        None, experiment.RunResult(state=i_fin, metrics=i_met,
                                   rounds=TI_ROUNDS, wall_time_s=0.0))
    est = i_met["est_distinct"][-1]
    print(f"path ingest fleet sparse K={FLEET_K} bf16 Manhattan "
          f"{INGEST_FLEET}: launches={counts} est_distinct min="
          f"{est.min().item():.1f} max={est.max().item():.1f} card ms/round="
          f"{i_ms:.3f}", flush=True)
    print(f"ingest callback fleet: {lines[0][:160]}", flush=True)
    tr_d, d_fin, _, _, _, _ = on_card(
        fleet_feds["sparse"], 1, 52, data1024, items1024,
        f"fleet sparse K={FLEET_K}", {"sparse_mix": 1},
        stacks=(etas, gammas))
    turns(f"ingest fleet K={FLEET_K}", runner(tr_i, i_fin, data1024, 53,
                                              (etas, gammas)),
          runner(tr_d, d_fin, data1024, 53, (etas, gammas)),
          ("ingest", "free"), rounds=2)
    del tr_i, tr_d, i_fin, d_fin
    i64 = dataclasses.replace(ifleet, num_nodes=64, wire_dtype="f32")
    _, fin, _, counts, _, idx = on_card(i64, 3, 54, data64, items64,
                                        "ingest fleet K=64",
                                        {"sparse_mix": 3})
    diff, _ = against_cpu("ingest fleet K=64", i64, data64, items64, idx,
                          fin)
    print(f"check ingest fleet sparse K=64 wire=f32 3 rounds card-vs-cpu "
          f"max|param diff|={diff:.3e} (<= 1e-4) sketches bit for bit "
          f"launches={counts}", flush=True)
    torch.cuda.empty_cache()
    print(f"phase transports and ingest {time.perf_counter() - t_phase:.1f}s",
          flush=True)


def llm_training(dev, add, expect_counts) -> None:
    """The federated LLM training path: qwen3-1.7b at full width (depth
    cut to two layers, f32) trained on K=2 through Experiment and Session
    with B9 in every training forward, and one local step's loss and flat
    gradient through B9's autograd Function against autograd of B9's plain
    version; the training CLI at --quick on the card (qwen3 with both
    drivers, rwkv6-7b with B10, faults, hierarchy; the qwen3 run against
    the CPU); the federated_llm twin at qwen3-100m on K=4."""
    from repro_torch import experiment
    from repro_torch.configs.base import FedConfig, RunConfig, TrainConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import flatten
    from repro_torch.data import pipeline, redundancy, synthetic
    from repro_torch.examples import federated_llm
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train as train_cli

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()

    # -- 12a. qwen3-1.7b at full width, K=2, through Experiment -----------
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), num_layers=TRAIN_LAYERS,
                              dtype="float32")
    run_cfg = RunConfig(
        model=cfg,
        fed=FedConfig(num_nodes=TRAIN_K, topology="ring",
                      local_steps=TRAIN_STEPS),
        train=TrainConfig(learning_rate=3e-4, batch_size=TRAIN_BATCH))
    nodes = [redundancy.inject_duplicates(synthetic.token_lm(
        seed=i, n_seqs=64, seq_len=TRAIN_SEQ, vocab=cfg.vocab_size), 0.5,
        seed=i) for i in range(TRAIN_K)]
    seqs = np.stack([d.x for d in nodes])
    data = {"tokens": seqs[..., :-1], "labels": seqs[..., 1:]}
    items = pipeline.FederatedBatcher(nodes, TRAIN_BATCH,
                                      TRAIN_STEPS).node_items()
    exp = experiment.Experiment(run_cfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()   # tensors of earlier phases
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    # the init drawn on the card: 723M draws a node
    session = exp.compile(data, items,
                          rng=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    layout = session.state.layout
    if layout.total != TRAIN_PARAMS or len(layout.names) != 14:
        fail(f"train full: {layout.total} params in {len(layout.names)} "
             f"leaves, expected {TRAIN_PARAMS} in 14")
    # the rounds one Session.run each (the segments equal one run), so
    # that the first round's one-time costs show apart from the others
    round_ms, losses = [], []
    for _ in range(TRAIN_ROUNDS):
        t0 = time.perf_counter()
        losses.append(session.run(1).metrics["loss"][0])
        torch.cuda.synchronize()
        round_ms.append(1e3 * (time.perf_counter() - t0))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        session.run(1)
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    counts = read_counts()
    n_b9 = (TRAIN_ROUNDS + 1) * TRAIN_STEPS * TRAIN_K * TRAIN_LAYERS
    expect = {name: 0 for name in counted()}
    expect.update(flat_mix=TRAIN_ROUNDS + 1, cnd_bitmaps=1, cnd_popcount=1,
                  flash_attention=n_b9)
    expect_counts("train full", counts, expect)
    add(counts)
    busy, n_dev = device_profile(prof)
    busy_ms = sum(busy.values())
    # f32 B9 is f32::flash_kernel in csrc/flash_attention.cu
    b9_ms = sum(v for n, v in busy.items()
                if n.split("<")[0].endswith("flash_kernel"))
    if b9_ms <= 0:
        fail(f"profiled training round launched B9 but no flash_kernel "
             f"shows device time: {sorted(busy)[:20]}")
    loss = torch.stack(losses)
    mean = loss.mean(dim=1).cpu()
    if not (bool(torch.isfinite(loss).all()) and mean[-1] < mean[0]):
        fail(f"train full: loss not finite or not falling: {mean.tolist()}")
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
    print(f"path train full {TRAIN_ARCH} d_model={cfg.d_model} "
          f"layers={cfg.num_layers} f32 params/node={layout.total} "
          f"K={TRAIN_K} ring cdfl batch={TRAIN_BATCH} seq={TRAIN_SEQ} "
          f"local_steps={TRAIN_STEPS} compile_s={compile_s:.2f} "
          f"ms/round={[round(v, 3) for v in round_ms]} loss/round="
          f"{[round(v, 4) for v in mean.tolist()]} peak_gb="
          f"{peak / 1e9:.2f} (earlier phases {base / 1e9:.2f}) "
          f"launches={counts} (B1={counts['flat_mix']} "
          f"B3={counts['cnd_bitmaps']} B4={counts['cnd_popcount']} "
          f"B9={counts['flash_attention']})", flush=True)
    print(f"profile train full round: wall_ms={prof_ms:.3f} device_busy_ms="
          f"{busy_ms:.3f} busy_share={busy_ms / prof_ms:.4f} B9_ms="
          f"{b9_ms:.4f} device_events={n_dev} "
          f"top={[(n, round(v, 4)) for n, v in top]}", flush=True)
    del prof

    # -- 12b. one local step: B9's Function against B9's plain version ----
    # the same params and batch (round 0's first step); the loss and the
    # (K, P) gradient with B9 in the forward and the plain version's
    # autograd in the backward, against autograd of the plain version in
    # both. These launches compare a kernel with its plain version: they
    # are not counted.
    loss_fn, _ = exp._model_fns(session.data)
    idx = session.batch_indices(0, 1)[0, :, 0].to(dev)      # (K, B)
    rows = torch.arange(TRAIN_K, device=dev)[:, None]
    batch = {name: v[rows, idx] for name, v in session.data.items()}

    def one_step():
        p = session.state.buf.detach().requires_grad_(True)
        losses = loss_fn(flatten.unflatten(p, layout), batch)
        (grad,) = torch.autograd.grad(losses.sum(), p)
        return losses.detach(), grad

    def plain_attention(q, k, v, *, causal=True, window=None):
        return ref.flash_attention(q, k, v, causal=causal, window=window)

    reset_counts()
    loss_k, grad_k = one_step()
    launched = read_counts()["flash_attention"]
    with unittest.mock.patch.object(ops, "flash_attention", plain_attention):
        loss_p, grad_p = one_step()
    if launched != TRAIN_K * TRAIN_LAYERS or \
            read_counts()["flash_attention"] != launched:
        fail(f"train step check: B9 launched {launched} times through the "
             f"Function (expected {TRAIN_K * TRAIN_LAYERS}), "
             f"{read_counts()['flash_attention'] - launched} on the plain "
             f"path (expected 0)")
    loss_rel = ((loss_k - loss_p).abs() / loss_p.abs()).max().item()
    grad_rel = (grad_k - grad_p).abs().max().item() / \
        grad_p.abs().max().item()
    if not (loss_rel <= 1e-5 and grad_rel <= 1e-4):
        fail(f"train step check: B9-forward loss {loss_rel:.3e} (<= 1e-5 "
             f"relative), gradient {grad_rel:.3e} of max |grad| (<= 1e-4) "
             f"from autograd of B9's plain version")
    print(f"check train step {TRAIN_ARCH} full width K={TRAIN_K}: B9 "
          f"forward + plain backward against autograd of B9's plain "
          f"version, loss max rel diff={loss_rel:.3e} (<= 1e-5) flat "
          f"gradient max|diff|/max|grad|={grad_rel:.3e} (<= 1e-4) "
          f"losses={[round(v, 5) for v in loss_k.tolist()]}", flush=True)
    del session, exp, grad_k, grad_p, batch
    torch.cuda.empty_cache()

    # -- 12c. the training CLI at --quick on the card ---------------------
    def cli(argv):
        with contextlib.redirect_stdout(io.StringIO()) as out:
            state, losses = train_cli.main(argv)
        return out.getvalue().splitlines(), state, losses

    quick = ["--quick", "--rounds", str(CLI_ROUNDS)]
    # a kernel launch a layer, node and local step: 3 x 4 x 4 x 2
    n_fwd = CLI_ROUNDS * 4 * 4 * 2
    runs = [("qwen3 scan", [], "flash_attention", None),
            ("qwen3 loop", ["--driver", "loop"], "flash_attention", None),
            ("rwkv6-7b scan", ["--arch", "rwkv6-7b"], "rwkv6_scan", None),
            ("qwen3 faults", ["--faults", "crash,corrupt"],
             "flash_attention", "FAULT_SMOKE"),
            ("qwen3 hierarchy", ["--hierarchy"], "flash_attention",
             "HIER_SMOKE")]
    scan_losses = None
    for label, flags, kernel, verdict in runs:
        reset_counts()
        t0 = time.perf_counter()
        lines, state, losses = cli(quick + flags)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = read_counts()
        expect = {"cnd_bitmaps": 1, "cnd_popcount": 1, kernel: n_fwd,
                  ({"flash_attention", "rwkv6_scan"} - {kernel}).pop(): 0}
        if verdict is None:
            expect["flat_mix"] = CLI_ROUNDS
        expect_counts(f"train cli {label}", counts, expect)
        mixes = sum(counts[n] for n in ("flat_mix", "flat_consensus",
                                        "sparse_mix", "cluster_mix"))
        if mixes < CLI_ROUNDS:
            fail(f"train cli {label}: {mixes} exchange launches for "
                 f"{CLI_ROUNDS} rounds")
        add(counts)
        if not (np.isfinite(losses).all()
                and losses[-1].mean() < losses[0].mean()):
            fail(f"train cli {label}: loss not finite or not falling: "
                 f"{losses.mean(axis=1).tolist()}")
        said = ""
        if verdict is not None:
            found = [ln for ln in lines if ln.startswith(verdict)]
            if len(found) != 1 or not found[0].startswith(f"{verdict} ok "):
                fail(f"train cli {label}: no '{verdict} ok' line: {found}")
            said = " " + found[0]
        if label == "qwen3 scan":
            scan_losses = losses
        print(f"path train cli {label}: {lines[0]} loss/round="
              f"{[round(v, 4) for v in losses.mean(axis=1).tolist()]} "
              f"wall_s={wall_s:.2f} launches={counts}{said}", flush=True)
    _, _, cpu_losses = cli(quick + ["--device", "cpu"])
    diff = float(np.abs(scan_losses - cpu_losses).max())
    if not diff <= 1e-4:
        fail(f"train cli qwen3 scan: card losses differ from the CPU run's "
             f"by {diff:.3e} > 1e-4")
    print(f"check train cli qwen3 scan {CLI_ROUNDS} rounds card-vs-cpu "
          f"max|loss diff|={diff:.3e} (<= 1e-4)", flush=True)

    # -- 12d. the federated_llm twin at qwen3-100m, K=4 -------------------
    # FLLM_ROUNDS timed rounds, then one more under the profiler: the
    # example's trainer is wrapped so that its last round is profiled
    from repro_torch.core import baselines
    real_cdfl, seen = baselines.cdfl, {}

    def profiling_cdfl(*args, **kw):
        tr = real_cdfl(*args, **kw)

        def round_fn(state, batch):
            seen["rounds"] = seen.get("rounds", 0) + 1
            if seen["rounds"] <= FLLM_ROUNDS:
                return tr.round(state, batch)
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = tr.round(state, batch)
                torch.cuda.synchronize()
                seen["ms"] = 1e3 * (time.perf_counter() - t0)
            seen["busy"] = device_profile(prof)
            return out
        return tr._replace(round=round_fn)

    ckpt = ROOT / "build" / "chip_smoke_federated_llm"
    reset_counts()
    with unittest.mock.patch.object(baselines, "cdfl", profiling_cdfl), \
            contextlib.redirect_stdout(io.StringIO()) as out:
        state, means, seconds = federated_llm.main(
            ["--rounds", str(FLLM_ROUNDS + 1), "--checkpoint", str(ckpt)])
    shutil.rmtree(ckpt, ignore_errors=True)
    counts = read_counts()
    layers = federated_llm.model_100m().num_layers
    expect = {name: 0 for name in counted()}
    expect.update(flat_mix=FLLM_ROUNDS + 1, cnd_bitmaps=1, cnd_popcount=1,
                  flash_attention=(FLLM_ROUNDS + 1) * 2 * 4 * layers)
    expect_counts("federated_llm", counts, expect)
    add(counts)
    if not (np.isfinite(means).all() and means[-1] < means[0]):
        fail(f"federated_llm: loss not finite or not falling: "
             f"{means.tolist()}")
    busy, n_dev = seen["busy"]
    busy_ms = sum(busy.values())
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
    print(f"path federated_llm {out.getvalue().splitlines()[0]} "
          f"rounds={FLLM_ROUNDS} ms/round="
          f"{[round(1e3 * v, 3) for v in seconds[:FLLM_ROUNDS].tolist()]} "
          f"loss/round={[round(v, 4) for v in means.tolist()]} "
          f"launches={counts}", flush=True)
    print(f"profile federated_llm round {FLLM_ROUNDS}: wall_ms="
          f"{seen['ms']:.3f} device_busy_ms={busy_ms:.3f} busy_share="
          f"{busy_ms / seen['ms']:.4f} device_events={n_dev} "
          f"top={[(n, round(v, 4)) for n, v in top]}", flush=True)
    del state
    torch.cuda.empty_cache()
    print(f"phase llm training {time.perf_counter() - t_phase:.1f}s",
          flush=True)


def cut_depth(cfg, layers):
    """``cfg`` with its first ``layers`` layers (block pattern included);
    None keeps every layer."""
    if layers is None:
        return cfg
    return dataclasses.replace(cfg, num_layers=layers,
                               block_pattern=cfg.block_pattern[:layers])


def cast_params(tree, dtype):
    """Params in ``dtype``, the MoE router kept in f32 (as init draws it
    for every dtype)."""
    if isinstance(tree, dict):
        return {k: v if k == "router" else cast_params(v, dtype)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_params(v, dtype) for v in tree]
    return tree.to(dtype)


def model_families(dev, rows, record, add, expect_counts, bf16_ulp) -> None:
    """The MoE, hybrid (mamba and shared attention), vision and audio
    families: B9 at each family's prefill shape in f32 and bf16 against its
    plain version, timed against SDPA; zamba2-1.2b, musicgen-medium and
    internvl2-26b (1,024 stub patch embeddings before the text) at full
    width and depth, mixtral-8x7b at full width and 16 layers, in bf16
    (prefill of 4 x 512 prompt tokens, B9's launches counted, 16 decode
    tokens, one profiled prefill and decode step); the f32 gates (128-token
    prefill against teacher-forced decode; mixtral at capacity 8.0, zamba2
    also through the sequential scan) and bf16 against f32 on the same
    weights (mixtral on the positions whose experts agree); the five smoke
    arches on the card against the CPU."""
    from repro_torch.configs.registry import get_arch, get_smoke_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve, steps
    from repro_torch.models import mamba, moe, stubs, transformer

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"phase model families starts with "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(29)

    def attn_layers(cfg) -> int:
        return sum(k in ("attn", "shared_attn") for k in cfg.blocks())

    def prefix(cfg) -> int:
        return cfg.num_patches if cfg.modality == "vision" else 0

    def counts_only(label, counts, b9):
        expect_counts(label, counts, {name: (b9 if name == "flash_attention"
                                             else 0) for name in counted()})
        add(counts)

    # every route the MoE layers take: (ids (..., k), capacity or None, E)
    routes = []
    real_route = moe.route

    def logged_route(params, cfg, tokens):
        out = real_route(params, cfg, tokens)
        cap = (moe._capacity(tokens.shape[1], cfg.num_experts,
                             cfg.experts_per_token, cfg.capacity_factor)
               if tokens.dim() == 3 else None)
        routes.append((out[2], cap, cfg.num_experts))
        return out

    route_log = unittest.mock.patch.object(moe, "route", logged_route)

    def dropped_share() -> tuple[int, int]:
        """(dropped, all) (token, choice) pairs of the logged prefill
        routes."""
        dropped = total = 0
        for idx, cap, e in routes:
            if cap is not None:
                _, pos = moe.queue_positions(idx, e)
                dropped += int((pos >= cap).sum().item())
                total += pos.numel()
        return dropped, total

    # -- 12a. B9 at the families' prefill shapes ---------------------------
    for arch in FAMILY_SERVE:
        cfg = get_arch(arch)
        h, kvh = cfg.num_heads, cfg.num_kv_heads
        d, win = cfg.resolved_head_dim(), cfg.sliding_window
        for dtype, s_len in ((torch.float32, F32_PROMPT + prefix(cfg)),
                             (torch.bfloat16, SERVE_PROMPT + prefix(cfg))):
            shape = (SERVE_BATCH, s_len)
            q = torch.randn(shape + (h, d), generator=gen,
                            device=dev).to(dtype)
            k = torch.randn(shape + (kvh, d), generator=gen,
                            device=dev).to(dtype)
            v = torch.randn(shape + (kvh, d), generator=gen,
                            device=dev).to(dtype)
            out = fa.flash_attention(q, k, v, causal=True, window=win)
            dt = str(dtype)[6:]
            label = (f"{arch} B={SERVE_BATCH} S={s_len} H={h} KV={kvh} D={d} "
                     f"G={h // kvh} causal window={win} {dt}")
            err, _ = b9_agrees(label, out, q, k, v, True, win, rows,
                               bf16_ulp)
            g = h // kvh
            kr = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
            vr = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
            qt = q.transpose(1, 2).contiguous()
            if win is not None and win < s_len:
                fail(f"{label}: the timing row's SDPA takes the window as "
                     f"causal, which needs window >= S")
            if dtype == torch.float32:
                band = torch.ones((s_len, s_len), dtype=torch.bool,
                                  device=dev).tril()
                lib = (lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kr, vr, attn_mask=band))
                what = "attn_mask=causal band) in f32, TF32 off"
            else:
                lib = (lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kr, vr, is_causal=True))
                what = "is_causal=True)"
            pairs = SERVE_BATCH * h * live_pairs(s_len, s_len, True, win)
            e = q.element_size()
            record("flash_attention", label, err,
                   lambda: fa.flash_attention(q, k, v, causal=True,
                                              window=win),
                   lambda: ref.flash_attention(q, k, v, causal=True,
                                               window=win),
                   lib, 2 * (q.numel() * e + k.numel() * e), 4 * d * pairs,
                   F32_OPS_PER_S if dtype == torch.float32
                   else BF16_OPS_PER_S, slow=s_len > SERVE_PROMPT,
                   table=False,
                   extra={"live_pairs": pairs,
                          "library": f"torch.nn.functional.scaled_dot_"
                                     f"product_attention({what} on (B, H, "
                                     f"S, D), k/v repeated to H outside the "
                                     f"timing"})
            del q, k, v, kr, vr, qt, out

    # -- 12b. bf16 serving at full width -----------------------------------
    for arch, (layers, n_expect) in FAMILY_SERVE.items():
        cfg = dataclasses.replace(cut_depth(get_arch(arch), layers),
                                  dtype="bfloat16")
        n_attn = attn_layers(cfg)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        gen_m = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        params = transformer.init_params(cfg, gen_m, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in tree_leaves(params))
        if n_params != n_expect:
            fail(f"{arch} ({cfg.num_layers} layers) has {n_params} params, "
                 f"expected {n_expect}")
        prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH,
                                                    SERVE_PROMPT),
                                generator=gen_m, device=dev,
                                dtype=torch.int32)
        batch = {"tokens": prompts}
        if cfg.modality == "vision":
            batch["embeds"] = stubs.vision_patch_embeddings(gen_m, cfg,
                                                            SERVE_BATCH)
        prefill = steps.make_prefill_step(cfg)
        prefill(params, batch)                   # warm-up
        torch.cuda.synchronize()
        reset_counts()
        routes.clear()
        with route_log:
            t0 = time.perf_counter()
            tok = prefill(params, batch)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
        counts_only(f"{arch} bf16 prefill", read_counts(), n_attn)
        dropped, pairs = dropped_share()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prefill(params, batch)
            torch.cuda.synchronize()
            prof_pf_ms = 1e3 * (time.perf_counter() - t0)
        busy_pf, n_pf = device_profile(prof)
        # B9 is flash_tc_kernel (bf16) and flash_kernel (f32)
        if n_attn and not any("flash_" in n.split("<")[0] for n in busy_pf):
            fail(f"{arch} bf16 profiled prefill launched B9 but no flash_ "
                 f"kernel shows device time")
        serve_step = steps.make_serve_step(cfg)
        warm = transformer.init_decode(cfg, SERVE_BATCH, 4, device=dev)
        for _ in range(2):
            serve_step(params, warm, tok)
        del warm
        # the cache sized for the prompt and the generated tokens: each
        # decode step's attention reads all of it (masked), as at the end
        # of a 512-token prompt
        state = transformer.init_decode(cfg, SERVE_BATCH,
                                        SERVE_PROMPT + SERVE_GEN + 1,
                                        device=dev)
        generated = []
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVE_GEN):
            generated.append(tok)
            tok, state = serve_step(params, state, tok)
        torch.cuda.synchronize()
        decode_ms = 1e3 * (time.perf_counter() - t0) / SERVE_GEN
        counts_only(f"{arch} bf16 decode", read_counts(), 0)
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tok, state = serve_step(params, state, tok)
            torch.cuda.synchronize()
            prof_dec_ms = 1e3 * (time.perf_counter() - t0)
        busy_dec, n_dec = device_profile(prof)
        gen_tokens = torch.stack(generated, dim=1).cpu()
        if not bool(((gen_tokens >= 0) & (gen_tokens < cfg.vocab_size))
                    .all()):
            fail(f"{arch} bf16: generated tokens out of the vocabulary")
        n_prompt = SERVE_BATCH * (SERVE_PROMPT + prefix(cfg))
        drop = (f" dropped (token, choice) pairs at capacity "
                f"{cfg.capacity_factor}: {dropped}/{pairs} "
                f"({dropped / pairs:.4f})" if pairs else "")
        print(f"path serve {arch} bf16 params={n_params} layers="
              f"{cfg.num_layers} batch={SERVE_BATCH} prompt={SERVE_PROMPT}"
              f"{f' + {prefix(cfg)} patch embeddings' if prefix(cfg) else ''}"
              f" gen={SERVE_GEN} init_s={init_s:.2f} prefill_ms="
              f"{1e3 * prefill_s:.3f} prefill_tokens/s="
              f"{n_prompt / prefill_s:.1f} decode_ms/token={decode_ms:.3f} "
              f"decode_tokens/s={SERVE_BATCH * 1e3 / decode_ms:.1f} "
              f"peak_mem_GB={peak_gb:.3f} B9 launches a prefill="
              f"{n_attn}{drop} sample={gen_tokens[0, :8].tolist()}",
              flush=True)
        for what, busy, n_ev, wall in (("prefill", busy_pf, n_pf, prof_pf_ms),
                                       ("decode step", busy_dec, n_dec,
                                        prof_dec_ms)):
            busy_ms = sum(busy.values())
            top = sorted(busy.items(), key=lambda kv: -kv[1])[:5]
            print(f"profile serve {arch} bf16 {what}: wall_ms={wall:.3f} "
                  f"device_busy_ms={busy_ms:.3f} busy_share="
                  f"{busy_ms / wall:.4f} device_events={n_ev} top="
                  f"{[(n, round(v, 4)) for n, v in top]} (reported, not "
                  f"gated)", flush=True)
        del params, state, batch, prompts

    # -- 12c. f32: prefill against teacher-forced decode; bf16 against f32 -
    for arch in FAMILY_SERVE:
        cfg32 = cut_depth(dataclasses.replace(get_arch(arch),
                                              dtype="float32"),
                          FAMILY_F32_LAYERS.get(arch))
        if cfg32.num_experts:
            cfg32 = dataclasses.replace(cfg32,
                                        capacity_factor=WIDE_CAPACITY)
        n_attn = attn_layers(cfg32)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        gen_m = torch.Generator(device=dev).manual_seed(0)
        params32 = transformer.init_params(cfg32, gen_m, device=dev)
        p32 = {"tokens": torch.randint(0, cfg32.vocab_size,
                                       (SERVE_BATCH, F32_PROMPT),
                                       generator=gen_m, device=dev,
                                       dtype=torch.int32)}
        reset_counts()
        t0 = time.perf_counter()
        tok_pf = steps.make_prefill_step(cfg32)(params32, p32)
        torch.cuda.synchronize()
        pf_ms = 1e3 * (time.perf_counter() - t0)
        lg_pf = transformer.forward(params32, cfg32, p32,
                                    last_only=True)[0][:, 0]
        counts_only(f"{arch} f32 prefill", read_counts(), 2 * n_attn)
        scan = ""
        if "mamba" in cfg32.blocks():
            # the same prefill with the sequential scan in every mamba block
            seq = functools.partial(mamba.forward, use_chunked=False)
            with unittest.mock.patch.object(mamba, "forward", seq):
                lg_scan = transformer.forward(params32, cfg32, p32,
                                              last_only=True)[0][:, 0]
        state32 = transformer.init_decode(cfg32, SERVE_BATCH, F32_PROMPT,
                                          device=dev)
        step32 = steps.make_serve_step(cfg32)
        reset_counts()
        t0 = time.perf_counter()
        for t in range(F32_PROMPT - 1):
            _, state32 = step32(params32, state32, p32["tokens"][:, t])
        lg_tf = transformer.decode_step(params32, cfg32, state32,
                                        p32["tokens"][:, -1])[0]
        torch.cuda.synchronize()
        tf_s = time.perf_counter() - t0
        counts_only(f"{arch} f32 decode", read_counts(), 0)
        rel = rel_diff(lg_pf, lg_tf)
        tok_tf = torch.argmax(lg_tf, dim=-1).to(torch.int32)
        if "mamba" in cfg32.blocks():
            scan = (f" sequential-scan prefill against teacher-forced "
                    f"{rel_diff(lg_scan, lg_tf):.3e}, chunked against scan "
                    f"prefill {rel_diff(lg_pf, lg_scan):.3e}")
        if not (rel <= 1e-4 and torch.equal(tok_pf, tok_tf)):
            fail(f"{arch} f32: prefill against teacher-forced decode "
                 f"{rel:.3e} of max |logit| (<= 1e-4), tokens "
                 f"{tok_pf.tolist()} against {tok_tf.tolist()}{scan}")
        print(f"check prefill-vs-teacher-forced {arch} f32 layers="
              f"{cfg32.num_layers} prompt={F32_PROMPT}"
              f"{f' capacity={cfg32.capacity_factor}' if cfg32.num_experts else ''}"
              f" max|logit diff|/max|logit|={rel:.3e} (<= 1e-4) tokens "
              f"equal {tok_pf.tolist()} B9 prefill_ms={pf_ms:.3f} "
              f"teacher-forced {F32_PROMPT} steps in {tf_s:.2f}s{scan}",
              flush=True)
        del state32

        # bf16 against f32: the same weights cast, every position's logits
        drift = dict(p32)
        if cfg32.modality == "vision":
            drift["embeds"] = stubs.vision_patch_embeddings(gen_m, cfg32,
                                                            SERVE_BATCH)
        cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
        routes.clear()
        with route_log:
            lg32 = transformer.forward(params32, cfg32, drift)[0]
            params16 = cast_params(params32, torch.bfloat16)
            del params32
            lg16 = transformer.forward(params16, cfg16, drift)[0]
        # the control: bf16 with B9 swapped for its plain version (the
        # reference's arithmetic, p rounded to bf16 before the PV product)
        with unittest.mock.patch.object(ops, "flash_attention",
                                        ref.flash_attention):
            lg_plain = transformer.forward(params16, cfg16, drift)[0]
        del params16
        rel16 = rel_diff(lg16, lg32)
        rel_plain = rel_diff(lg_plain, lg32)
        # bf16 rounding of the weights and of the residual stream alone
        # drifts with depth (on the CPU the JAX package's own bf16 forward
        # of a 12-layer zamba2 at d_model 256 is 5.9e-2 from its f32): the
        # gate is 3e-2, or twice the plain-attention control's drift where
        # that is larger, as rwkv6's bf16 gate is twice its plain path's
        tol = max(FAMILY_BF16_TOL, 2 * rel_plain)
        flips = f" plain-attention control {rel_plain:.3e}"
        if cfg32.num_experts:
            # one route a layer in each run: f32's, then bf16's
            ids = [torch.sort(idx.reshape(SERVE_BATCH, F32_PROMPT, -1),
                              dim=-1)[0] for idx, _, _ in routes]
            n = len(ids) // 2
            agree = torch.ones((SERVE_BATCH, F32_PROMPT), dtype=torch.bool,
                               device=dev)
            for a, b in zip(ids[:n], ids[n:]):
                agree &= (a == b).all(dim=-1)
            # an expert flipped by bf16 rounding moves its position by far
            # more than rounding does, and causal attention carries the
            # move to every later position of its sequence: the gate holds
            # the positions whose experts, and those of every earlier
            # position of their sequence, agree in all layers at 3e-2
            clean = torch.cumprod(agree.int(), dim=1).bool()
            if not clean.any():
                fail(f"{arch} bf16 against f32: every sequence flips an "
                     f"expert at its first position")
            rel16 = ((lg16.float() - lg32)[clean].abs().max()
                     / lg32.abs().max()).item()
            tol = FAMILY_BF16_TOL
            flips = (f" on the {int(clean.sum())}/{clean.numel()} positions "
                     f"with no flipped expert in any layer at or before "
                     f"them (flipped share {1 - agree.float().mean().item():.4f}"
                     f"; positions whose own experts agree "
                     f"{((lg16.float() - lg32)[agree].abs().max() / lg32.abs().max()).item():.3e}"
                     f"; all positions {rel_diff(lg16, lg32):.3e};{flips})")
        if not (torch.isfinite(lg16).all() and rel16 <= tol):
            fail(f"{arch} bf16 against f32: {rel16:.3e} of max |logit| > "
                 f"{tol:.3e}{flips}")
        print(f"check bf16-vs-f32 {arch} layers={cfg32.num_layers} prompt="
              f"{F32_PROMPT}{f' + {prefix(cfg32)} patch embeddings' if prefix(cfg32) else ''}"
              f" max|logit diff|/max|logit|={rel16:.3e} (<= {tol:.3e})"
              f"{flips}", flush=True)
        del lg32, lg16, lg_plain

    # -- 12d. the smoke arches on the card against the CPU, f32 -----------
    for arch in FAMILY_SMOKE:
        argv = ["--arch", arch, "--batch", "4", "--prompt-len", "32", "--gen",
                "16"]
        out_card = serve.main(argv + ["--device", "cuda"])
        out_cpu = serve.main(argv + ["--device", "cpu"])
        scfg = get_smoke_arch(arch)
        p_card, pr_card = serve.init_inputs(scfg, 4, 32, dev)
        p_cpu, pr_cpu = serve.init_inputs(scfg, 4, 32, "cpu")
        b_card, b_cpu = {"tokens": pr_card}, {"tokens": pr_cpu}
        if scfg.modality == "vision":
            b_cpu["embeds"] = stubs.vision_patch_embeddings(
                torch.Generator().manual_seed(1), scfg, 4)
            b_card["embeds"] = b_cpu["embeds"].to(dev)
        reset_counts()
        lg_card = transformer.forward(p_card, scfg, b_card,
                                      last_only=True)[0]
        counts_only(f"serve {arch} smoke prefill", read_counts(),
                    attn_layers(scfg))
        lg_cpu = transformer.forward(p_cpu, scfg, b_cpu, last_only=True)[0]
        rel = rel_diff(lg_card.cpu(), lg_cpu)
        same = np.array_equal(np.asarray(out_card), np.asarray(out_cpu))
        if not (rel <= 1e-4 and same):
            fail(f"serve {arch} smoke: card against CPU prefill logits "
                 f"{rel:.3e} of max |logit| (<= 1e-4), tokens equal {same}")
        print(f"path serve {arch} smoke ({'/'.join(dict.fromkeys(scfg.blocks()))}"
              f"{f', {scfg.num_experts} experts top-{scfg.experts_per_token}' if scfg.num_experts else ''}"
              f"{f', {scfg.num_patches} patch embeddings' if prefix(scfg) else ''}"
              f") f32 card-vs-cpu prefill max|logit diff|/max|logit|="
              f"{rel:.3e} (<= 1e-4) generated tokens equal "
              f"({tuple(np.asarray(out_cpu).shape)})", flush=True)
    print(f"phase model families {time.perf_counter() - t_phase:.1f}s",
          flush=True)


def mesh_state(cfg, f: int, gen, dev, ratios):
    """A MeshFedState of ``f`` nodes of ``cfg``: each node's params drawn
    from ``gen`` on its device into stacked (F, ...) leaves (one node's
    copy at a time), zero f32 moments, step counters at 0."""
    from repro_torch.core import flatten
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.optim import AdamState
    stacked = paths = None
    for k in range(f):
        pairs = flatten.leaves_with_paths(
            transformer.init_params(cfg, gen, device=dev))
        if stacked is None:
            paths = [path for path, _ in pairs]
            stacked = [leaf.new_empty((f,) + tuple(leaf.shape))
                       for _, leaf in pairs]
        for out, (_, leaf) in zip(stacked, pairs):
            out[k] = leaf
        del pairs

    def zeros():
        return flatten.build_tree(paths, [
            torch.zeros_like(leaf, dtype=torch.float32) for leaf in stacked])

    return steps.MeshFedState(
        flatten.build_tree(paths, stacked),
        AdamState(torch.zeros(f, dtype=torch.int32, device=dev), zeros(),
                  zeros()),
        torch.tensor(ratios, dtype=torch.float32, device=dev))


def mesh_batch(cfg, f: int, batch: int, seq: int, seed: int, dev) -> dict:
    """``f`` nodes' training batch: token_lm sequences of ``seq`` + 1
    tokens (tokens and next-token labels), a vision model's stub patch
    embeddings before the text."""
    from repro_torch.data import synthetic
    from repro_torch.models import stubs
    seqs = np.stack([synthetic.token_lm(seed=seed + k, n_seqs=batch,
                                        seq_len=seq, vocab=cfg.vocab_size).x
                     for k in range(f)])
    out = {"tokens": torch.tensor(seqs[..., :-1], device=dev),
           "labels": torch.tensor(seqs[..., 1:], device=dev)}
    if cfg.modality == "vision":
        gen = torch.Generator(device=dev).manual_seed(seed)
        out["embeds"] = torch.stack([stubs.vision_patch_embeddings(
            gen, cfg, batch) for _ in range(f)])
    return out


def tree_rel(got, want) -> float:
    """max |got - want| over a tree's leaves, over the tree's max |want|."""
    pairs = list(zip(tree_leaves(got), tree_leaves(want)))
    top = max(w.float().abs().max().item() for _, w in pairs)
    return max((g.float().cpu() - w.float().cpu()).abs().max().item()
               for g, w in pairs) / top


def mesh_train(dev, add, expect_counts, smi) -> None:
    """The federated mesh train step (``launch/steps.py``:
    ``ring_consensus_roll`` and ``make_fed_train_step``, the reference's
    step for full-size LLM training) at full width: mixtral-8x7b (1 layer),
    internvl2-26b (1 layer, 1,024 stub patch embeddings before the text),
    zamba2-1.2b (30 layers, five periods of 5 mamba blocks and a shared
    attention block), musicgen-medium (all 48 layers) and rwkv6-7b (2
    layers), in bf16 with f32 moments on an F=2 ring, remat "full", 2 x
    512 tokens a node, 3 timed steps and 1 profiled, B9 in every attention
    layer's forward and B10 in every wkv scan; each family's smoke width
    on F=3 nodes in f32 on the card against the CPU; internvl2's loss and
    gradient with B9 in the forward against its plain version."""
    from repro_torch.configs.base import (FedConfig, ShapeConfig,
                                          TrainConfig)
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import flatten
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import roofline, steps
    from repro_torch.models import transformer
    from repro_torch.optim import schedules

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"phase mesh train starts with "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated",
          flush=True)
    # a linear warmup to MESH_LR over the steps (a sign-sized Adam step at
    # the full rate first overshoots at these widths)
    train = TrainConfig(learning_rate=schedules.cosine(
        MESH_LR, MESH_STEPS + 1, 100), remat="full")
    fed = FedConfig(num_nodes=MESH_F)

    def kernel_layers(cfg) -> dict:
        """Launches of B9 and B10 one node's training forward makes; the
        backward's remat recomputes each block's forward, kernels and all,
        so a node's step launches each twice."""
        kinds = cfg.blocks()
        return {"flash_attention": sum(k in ("attn", "shared_attn")
                                       for k in kinds),
                "rwkv6_scan": sum(k == "rwkv" for k in kinds)}

    for arch, layers in MESH_DEPTH.items():
        cfg = dataclasses.replace(cut_depth(get_arch(arch), layers),
                                  dtype="bfloat16")
        struct = steps.fed_state_struct(cfg, MESH_F, train)
        struct_leaves = (tree_leaves(struct.params)
                         + tree_leaves(struct.opt.m)
                         + tree_leaves(struct.opt.v)
                         + [struct.opt.step, struct.ratios])
        state_bytes = sum(t.numel() * t.element_size()
                          for t in struct_leaves)
        n_params = sum(t.numel() for t in tree_leaves(struct.params)) \
            // MESH_F
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev).manual_seed(30)
        t0 = time.perf_counter()
        state = mesh_state(cfg, MESH_F, gen, dev, MESH_RATIOS)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        # the caching allocator hands a large request a whole block when
        # less than 1 MiB of it would be left: up to 1 MiB over, a leaf
        got_bytes = torch.cuda.memory_allocated() - base
        if not state_bytes <= got_bytes <= state_bytes + 2 ** 20 * len(
                struct_leaves):
            fail(f"mesh train {arch}: the state holds {got_bytes} bytes, "
                 f"fed_state_struct reckons {state_bytes}")
        batch = mesh_batch(cfg, MESH_F, MESH_BATCH, MESH_SEQ, 30, dev)
        step = steps.make_fed_train_step(cfg, fed, train)
        reset_counts()
        step_ms, losses = [], []
        for _ in range(MESH_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, batch)
            losses.append(loss.item())
            step_ms.append(1e3 * (time.perf_counter() - t0))
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, loss = step(state, batch)
            losses.append(loss.item())
            prof_ms = 1e3 * (time.perf_counter() - t0)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() - base
        per_node = kernel_layers(cfg)
        expect = {name: 0 for name in counted()}
        for name, n in per_node.items():
            expect[name] = 2 * n * MESH_F * (MESH_STEPS + 1)
        busy, n_dev = device_profile(prof)
        busy_ms = sum(busy.values())
        del prof
        kernel_ms = {
            "B9": sum(v for n, v in busy.items()
                      if n.split("<")[0].split("::")[-1].startswith("flash_")),
            "B10": sum(v for n, v in busy.items()
                       if "rwkv6_kernel" in n.split("<")[0])}
        router = ""
        if cfg.num_experts:
            r_max = state.opt.m["layers"]["ffn"]["router"].abs().max().item()
            router = f" router max|m|={r_max:.3e} (> 0)"
        seq_len = MESH_SEQ + (cfg.num_patches if cfg.modality == "vision"
                              else 0)
        shape = ShapeConfig("mesh", seq_len, MESH_F * MESH_BATCH, "train")
        flops = roofline.model_flops_per_device(cfg, shape, 1, MESH_F)
        best_ms = min(step_ms[1:])
        top = sorted(busy.items(), key=lambda kv: -kv[1])[:5]
        print(f"path mesh train {arch} layers={cfg.num_layers} bf16 params, "
              f"f32 moments, F={MESH_F} ring remat=full batch={MESH_BATCH} "
              f"x {seq_len} tokens a node params/node={n_params} "
              f"state_bytes={state_bytes} ({state_bytes / 1e9:.3f} GB by "
              f"fed_state_struct, before allocation; {got_bytes} allocated) "
              f"init_s={init_s:.2f} "
              f"peak_gb={peak / 1e9:.3f} (above the "
              f"{base / 1e9:.3f} GB left by earlier phases) ms/step="
              f"{[round(v, 3) for v in step_ms]} profiled_ms={prof_ms:.3f} "
              f"loss/step={[round(v, 5) for v in losses]} launches "
              f"B9={counts['flash_attention']} B10={counts['rwkv6_scan']} "
              f"(2 x {per_node} x F x {MESH_STEPS + 1} steps){router}",
              flush=True)
        print(f"profile mesh train {arch} step: wall_ms={prof_ms:.3f} "
              f"device_busy_ms={busy_ms:.3f} busy_share="
              f"{busy_ms / prof_ms:.4f} device_events={n_dev} B9_ms="
              f"{kernel_ms['B9']:.4f} B10_ms={kernel_ms['B10']:.4f} top="
              f"{[(n, round(v, 4)) for n, v in top]}", flush=True)
        print(f"roofline mesh train {arch}: model_flops/step={flops:.4e} "
              f"(6 x {cfg.active_param_count()} active params x "
              f"{MESH_F * MESH_BATCH * seq_len} tokens) best ms/step="
              f"{best_ms:.3f} model_flops_share="
              f"{flops / (best_ms * 1e-3 * roofline.PEAK_FLOPS):.4f} of "
              f"{roofline.PEAK_FLOPS:.3e} bf16 FLOP/s on {smi}", flush=True)
        expect_counts(f"mesh train {arch}", counts, expect)
        add(counts)
        for name, key in (("flash_attention", "B9"), ("rwkv6_scan", "B10")):
            if per_node[name] and kernel_ms[key] <= 0:
                fail(f"mesh train {arch}: the profiled step launched {key} "
                     f"but none of its kernels shows device time")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            fail(f"mesh train {arch}: losses not finite or not falling: "
                 f"{losses}")
        if cfg.num_experts and not r_max > 0:
            fail(f"mesh train {arch}: the router's gradient is zero (its "
                 f"first moment after {MESH_STEPS + 1} steps)")

        if arch == "internvl2-26b":
            # node 0's loss and gradient at its params after the steps,
            # as the step takes them: B9 in the forward, its plain version
            # in the forward, and (the control) the plain version on the
            # same params in f32. These launches compare a kernel with its
            # plain version: they are not counted.
            node = transformer._layer(state.params, 0)
            nb = {name: v[0] for name, v in batch.items()}
            del state, step

            def node_grad(params, c, b):
                pairs = flatten.leaves_with_paths(params)
                own = [leaf.detach().requires_grad_() for _, leaf in pairs]
                loss = transformer.loss_fn(
                    flatten.build_tree([p for p, _ in pairs], own), c, b,
                    remat=True)
                grads = torch.autograd.grad(loss, own,
                                            materialize_grads=True)
                return loss.item(), grads

            def plain_attention(q, k, v, *, causal=True, window=None):
                return ref.flash_attention(q, k, v, causal=causal,
                                           window=window)

            reset_counts()
            loss_k, grad_k = node_grad(node, cfg, nb)
            launched = read_counts()["flash_attention"]
            with unittest.mock.patch.object(ops, "flash_attention",
                                            plain_attention):
                loss_p, grad_p = node_grad(node, cfg, nb)
                cfg32 = dataclasses.replace(cfg, dtype="float32")
                node32 = flatten.tree_map(lambda t: t.float(), node)
                nb32 = dict(nb, embeds=nb["embeds"].float())
                loss_c, grad_c = node_grad(node32, cfg32, nb32)
                del node32, nb32
            if launched != 2 * per_node["flash_attention"] or \
                    read_counts()["flash_attention"] != launched:
                fail(f"mesh train {arch} gradient check: B9 launched "
                     f"{launched} times with the kernel forward (expected "
                     f"{2 * per_node['flash_attention']}), "
                     f"{read_counts()['flash_attention'] - launched} on the "
                     f"plain path (expected 0)")
            loss_rel = abs(loss_k - loss_p) / abs(loss_p)
            worst = (0.0, 0.0, "")
            names = [path for path, _ in flatten.leaves_with_paths(node)]
            for path, gk, gp, gc in zip(names, grad_k, grad_p, grad_c):
                top = gp.float().abs().max().item()
                if top == 0 or gc.abs().max().item() == 0:
                    fail(f"mesh train {arch} gradient check: leaf {path} "
                         f"has a zero gradient")
                rel = (gk.float() - gp.float()).abs().max().item() / top
                ctl = (gp.float() - gc).abs().max().item() / \
                    gc.abs().max().item()
                if rel > max(MESH_GRAD_TOL, 2 * ctl):
                    fail(f"mesh train {arch} gradient check: leaf {path} "
                         f"B9 forward against plain {rel:.3e} of max "
                         f"|grad| > max({MESH_GRAD_TOL}, 2 x the plain "
                         f"path's bf16-vs-f32 {ctl:.3e})")
                if rel > worst[0]:
                    worst = (rel, ctl, "/".join(map(str, path)))
            if not loss_rel <= MESH_LOSS_TOL:
                fail(f"mesh train {arch} gradient check: B9-forward loss "
                     f"{loss_k} against plain {loss_p}: {loss_rel:.3e} > "
                     f"{MESH_LOSS_TOL} relative")
            print(f"check mesh train {arch} one node's step bf16: B9 "
                  f"forward against its plain version, loss {loss_k:.6f} "
                  f"against {loss_p:.6f} (f32 control {loss_c:.6f}) rel "
                  f"diff={loss_rel:.3e} (<= {MESH_LOSS_TOL}); gradient "
                  f"worst leaf {worst[2]} {worst[0]:.3e} of max |grad| "
                  f"(<= {MESH_GRAD_TOL} or twice the plain path's "
                  f"bf16-vs-f32 {worst[1]:.3e}), {len(grad_k)} leaves",
                  flush=True)
            del grad_k, grad_p, grad_c, gk, gp, gc, node, nb
        else:
            del state, step
        del batch
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # -- smoke width: F=3, f32, 2 steps, card against the CPU --------------
    from repro_torch.configs.base import reduced
    for arch in MESH_DEPTH:
        scfg = reduced(get_arch(arch))
        if arch == "zamba2-1.2b":       # a pattern that holds shared_attn
            scfg = dataclasses.replace(scfg,
                                       block_pattern=("mamba", "shared_attn"))
        sfed = FedConfig(num_nodes=MESH_SMOKE_F)
        strain = TrainConfig(learning_rate=MESH_LR, remat="full")
        ratios = (0.3, 0.6, 0.9)
        runs = {}
        for where in ("cpu", dev):
            st = mesh_state(scfg, MESH_SMOKE_F, torch.Generator()
                            .manual_seed(31), "cpu", ratios)
            st = steps.MeshFedState(
                flatten.tree_map(lambda t: t.to(where), st.params),
                type(st.opt)(st.opt.step.to(where),
                             flatten.tree_map(lambda t: t.to(where),
                                              st.opt.m),
                             flatten.tree_map(lambda t: t.to(where),
                                              st.opt.v)),
                st.ratios.to(where))
            sb = mesh_batch(scfg, MESH_SMOKE_F, 2, 32, 31, "cpu")
            sb = {name: v.to(where) for name, v in sb.items()}
            sstep = steps.make_fed_train_step(scfg, sfed, strain)
            reset_counts()
            ls = []
            for _ in range(2):
                st, loss = sstep(st, sb)
                ls.append(loss.item())
            if where == dev:
                expect = {name: 0 for name in counted()}
                expect.update({name: 2 * n * MESH_SMOKE_F * 2
                               for name, n in kernel_layers(scfg).items()})
                expect_counts(f"mesh train {arch} smoke", read_counts(),
                              expect)
                add(read_counts())
            runs[where] = (st, ls)
        (cst, cls), (gst, gls) = runs["cpu"], runs[dev]
        errs = {"params": tree_rel(gst.params, cst.params),
                "m": tree_rel(gst.opt.m, cst.opt.m),
                "v": tree_rel(gst.opt.v, cst.opt.v)}
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(gls, cls))
        if not (torch.equal(gst.opt.step.cpu(), cst.opt.step)
                and loss_rel <= MESH_SMOKE_TOL
                and max(errs.values()) <= MESH_SMOKE_TOL):
            fail(f"mesh train {arch} smoke: card against CPU params/m/v "
                 f"{errs}, losses {loss_rel:.3e} (<= {MESH_SMOKE_TOL} of "
                 f"max |value|), steps {gst.opt.step.tolist()}")
        print(f"check mesh train {arch} smoke F={MESH_SMOKE_F} f32 2 steps "
              f"card-vs-cpu {', '.join(f'{k} {v:.3e}' for k, v in errs.items())}"
              f" losses {loss_rel:.3e} (<= {MESH_SMOKE_TOL} of max |value|)",
              flush=True)
    print(f"phase mesh train {time.perf_counter() - t_phase:.1f}s",
          flush=True)


def to_mesh(tree, mesh, spec_fn):
    """Every tensor of a tree as a DTensor on ``mesh``, placed by
    ``spec_fn(shape, mesh, name)`` (the sharding rules), sharing its
    storage."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch import sharding

    def place(path, leaf):
        spec = spec_fn(tuple(leaf.shape), mesh, sharding._leaf_name(path)) \
            if leaf.dim() else sharding.P()
        return DTensor.from_local(
            leaf, mesh, sharding.NamedSharding(mesh, spec).placements,
            run_check=False)
    return sharding.tree_map_with_path(place, tree)


def mesh_prefill(dev, add, expect_counts, smi, smesh, arch, layers,
                 kernel) -> None:
    """``arch``'s bf16 prefill of SERVE_BATCH x SERVE_PROMPT tokens (its
    first ``layers`` layers, None: every layer) four ways, each one call
    after a warm-up, host-timed: the plain step; the step with params and
    batch as DTensors on the one-device ``(data, model)`` mesh ``smesh``
    (``make_prefill_step(cfg, multi_pod=False)``, which runs a one-device
    mesh on the local tensors); the model's forward on plain tensors; and
    the model's forward on those DTensors under the serving rules, which
    takes the shard-local paths (each rank's MoE groups, rwkv6 rows and
    heads, attention heads) and launches the kernels on the local
    tensors. The mesh step's tokens equal the plain step's and the
    DTensor forward's last logits the plain forward's, bit for bit;
    ``kernel`` is launched once a layer in every run."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import sharding, steps
    from repro_torch.models import pspec, transformer

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(cut_depth(get_arch(arch), layers),
                              dtype="bfloat16")
    gen = torch.Generator(device=dev).manual_seed(44)
    params = transformer.init_params(cfg, gen, device=dev)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (SERVE_BATCH, SERVE_PROMPT),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    dparams = to_mesh(params, smesh, lambda s, m, n:
                      sharding.serve_param_spec(s, m, name=n))
    dbatch = to_mesh(batch, smesh, lambda s, m, n:
                     sharding.serve_batch_spec(s, m))
    prefill = steps.make_prefill_step(cfg, multi_pod=False)

    def model(p, b):
        with torch.no_grad(), pspec.logical_rules(pspec.SERVE_RULES), \
                implicit_replication():
            logits, _ = transformer.forward(p, cfg, b, last_only=True)
        return logits

    runs = {"plain step": lambda: prefill(params, batch),
            "mesh step": lambda: prefill(dparams, dbatch),
            "plain model": lambda: model(params, batch),
            "mesh model": lambda: model(dparams, dbatch)}
    done = {}
    for name, fn in runs.items():
        fn()                                # first use
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        counts = read_counts()
        expect = {n: 0 for n in counted()}
        expect[kernel] = cfg.num_layers
        expect_counts(f"mesh prefill {arch} {name}", counts, expect)
        add(counts)
        if name.startswith("mesh") and not isinstance(out, DTensor):
            fail(f"mesh prefill {arch} {name}: returned a "
                 f"{type(out).__name__}, not a DTensor")
        done[name] = (out.to_local() if isinstance(out, DTensor) else out,
                      ms, counts[kernel])
    tokens_equal = torch.equal(done["plain step"][0], done["mesh step"][0])
    logits_equal = torch.equal(done["plain model"][0],
                               done["mesh model"][0])
    diff = (done["plain model"][0].float()
            - done["mesh model"][0].float()).abs().max().item()
    print(f"check mesh prefill {arch} {cfg.num_layers} layers bf16 "
          f"{SERVE_BATCH} x {SERVE_PROMPT} tokens on a one-device (data, "
          f"model) mesh: step tokens equal to the plain step's: "
          f"{tokens_equal}; the model on DTensors (shard-local paths), "
          f"last logits equal to the plain forward's: {logits_equal} (max "
          f"|diff| {diff:.3e}); ms plain step={done['plain step'][1]:.3f} "
          f"mesh step={done['mesh step'][1]:.3f} plain model="
          f"{done['plain model'][1]:.3f} DTensor model="
          f"{done['mesh model'][1]:.3f} (host-timed, one call each); "
          f"{kernel} launches a call "
          f"{'/'.join(str(done[n][2]) for n in runs)} on {smi}",
          flush=True)
    if not (tokens_equal and logits_equal):
        fail(f"mesh prefill {arch}: the one-device mesh differs from the "
             f"plain prefill")
    del params, dparams, batch, dbatch, done, out
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def start_mesh_dryruns() -> list:
    """``python -m repro_torch.launch.dryrun`` for each of MESH_DRYRUNS as
    a subprocess, all at once, killed when the script ends whichever way
    it ends: ``[(arch, shape, two pods, JSON path, start, process)]``.
    They run on the host's cores while the card works (the rwkv6-7b x
    prefill_32k one takes about a minute), each on one thread at the
    lowest priority, so that the script's host-timed steps keep a core."""
    import os
    out_dir = ROOT / "build" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    runs = []
    for arch, shape, pods in MESH_DRYRUNS:
        out = out_dir / f"{arch}_{shape}_{'two' if pods else 'one'}_pod.json"
        out.unlink(missing_ok=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", str(out)]
        runs.append((arch, shape, pods, out, time.perf_counter(),
                     subprocess.Popen(cmd + (["--multi-pod"] if pods else []),
                                      cwd=ROOT, env=env, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT,
                                      preexec_fn=lambda: os.nice(19))))

    def stop_dryruns():
        for *_, proc in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    atexit.register(stop_dryruns)
    return runs


def mesh_code(dev, add, expect_counts, smi, runs) -> None:
    """The mesh code: ``python -m repro_torch.launch.dryrun`` on a fake
    world of 256 or 512 ranks as subprocesses (``runs``, started by
    :func:`start_mesh_dryruns`: qwen3-1.7b x train_4k on one and two pods,
    mixtral-8x7b x decode_32k and x train_4k, rwkv6-7b x prefill_32k,
    musicgen-medium x long_500k), their records' devices,
    shard GB, counted FLOPs, collectives and seconds; then, in a one-rank
    world (NCCL for the card, gloo for the CPU, a FileStore under
    ``build/``), ``ring_exchange_shard`` and ``ring_consensus_shard`` on
    one node of qwen3-1.7b at full width with f32 and bf16 wires and 1 and
    4 column shards, the card against the CPU and against its input (a
    ring of one rank returns it: a self-permute and a mix whose
    differences are 0), and timed; the serving
    prefill of qwen3-1.7b at full width through ``make_prefill_step(cfg,
    multi_pod=False)`` with its params and batch as DTensors on a
    one-device ``("data", "model")`` mesh, then rwkv6-7b's (every layer)
    and mixtral-8x7b's (16 layers) bf16 prefills there as steps and as
    the model on the DTensors (:func:`mesh_prefill`), and the mesh train
    step of rwkv6-7b (2 layers, F=2, bf16; four steps, the last three
    timed, and the memory they allocate above the state) with its state
    as DTensors on a one-device ``("fed", "dp", "tp")`` mesh (a ring one
    rank wide), each bit for bit against the plain-tensor step, with B9
    and B10 counted."""
    import os
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs.base import FedConfig, TrainConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import consensus, flatten, transport
    from repro_torch.launch import sharding, steps
    from repro_torch.models import transformer
    from repro_torch.optim import schedules

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"phase mesh code starts with "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated",
          flush=True)
    store = ROOT / "build" / f"mesh_store_{os.getpid()}"
    store.unlink(missing_ok=True)
    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"file://{store}", rank=0,
                            world_size=1)
    rings = {where: DeviceMesh(where, torch.zeros(1, dtype=torch.int64),
                               mesh_dim_names=("fed",))
             for where in ("cpu", "cuda")}

    # -- the ring helpers: one node of qwen3-1.7b at full width -----------
    rcfg = cut_depth(get_arch(SERVE_ARCH), RING_LAYERS)
    params = transformer.init_params(rcfg, torch.Generator(device=dev)
                                     .manual_seed(41), device=dev)
    vec, layout = flatten.flatten_one(params)
    vec_cpu = vec.cpu()
    ratio = {where: torch.tensor([0.7], device=where)
             for where in ("cpu", "cuda")}
    etas = {where: consensus.ring_sketch_exchange(ratio[where], "fed",
                                                  mesh=rings[where])
            for where in ("cpu", "cuda")}
    for wire in ("f32", "bf16"):
        ep, en = etas["cpu"]
        want = transport.ring_exchange_shard(
            vec_cpu, ep[0], en[0], RING_GAMMA, "fed", wire_dtype=wire,
            mesh=rings["cpu"])
        want_tree = flatten.unflatten_one(want, layout)
        for shards in (1, 4):
            ep, en = etas["cuda"]

            def exchange():
                return transport.ring_exchange_shard(
                    vec, ep[0], en[0], RING_GAMMA, "fed", wire_dtype=wire,
                    shards=shards, mesh=rings["cuda"])

            def mix():
                return consensus.ring_consensus_shard(
                    params, ep[0], en[0], RING_GAMMA, "fed",
                    wire_dtype=wire, shards=shards, mesh=rings["cuda"])

            got = exchange().cpu()
            err = (got - want).abs()
            excess = (err - (RING_ATOL + RING_RTOL * want.abs())).max()
            # a ring of one rank receives its own payload, so every
            # difference term is 0 and the output is its input: this
            # checks the wire cast and the plumbing (the 4-rank gloo test
            # holds the mix's arithmetic)
            same = torch.equal(got, vec_cpu)
            tree = mix()
            tree_ok = all(torch.equal(g.cpu(), w) for (_, g), (_, w) in zip(
                flatten.leaves_with_paths(tree),
                flatten.leaves_with_paths(want_tree)))
            del tree
            if excess > 0 or not tree_ok or not same:
                fail(f"mesh ring qwen3-1.7b wire={wire} shards={shards}: "
                     f"card against CPU max |diff| {err.max().item():.3e} "
                     f"(rtol {RING_RTOL}, atol {RING_ATOL}); "
                     f"ring_consensus_shard's leaves equal: {tree_ok}; "
                     f"output equal to its input: {same}")
            ex_ms, _ = timing(exchange, launches=3, reps=3, graph=False)
            mix_ms, _ = timing(mix, launches=3, reps=3, graph=False)
            print(f"check mesh ring qwen3-1.7b {RING_LAYERS} layers "
                  f"P={layout.padded} wire={wire} shards={shards} "
                  f"(n={flatten.column_shards(layout.padded, shards)}): "
                  f"ring_exchange_shard card against CPU max |diff| "
                  f"{err.max().item():.3e} (rtol {RING_RTOL} atol "
                  f"{RING_ATOL}), ring_consensus_shard leaves equal to the "
                  f"CPU's, output equal to its input (a ring of one rank); ms ring_exchange_shard={ex_ms:.3f} "
                  f"ring_consensus_shard={mix_ms:.3f} on {smi}", flush=True)
        del want, want_tree
    del params, vec, vec_cpu
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # -- the serving prefill on a one-device ("data", "model") mesh -------
    scfg = get_arch(SERVE_ARCH)
    sparams = transformer.init_params(scfg, torch.Generator(device=dev)
                                      .manual_seed(42), device=dev)
    tokens = torch.randint(0, scfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                           generator=torch.Generator(device=dev)
                           .manual_seed(42), device=dev, dtype=torch.int32)
    smesh = DeviceMesh("cuda", torch.zeros((1, 1), dtype=torch.int64),
                       mesh_dim_names=("data", "model"))
    prefill = steps.make_prefill_step(scfg, multi_pod=False)
    results = {}
    for name, (p, b) in {
            "plain": (sparams, {"tokens": tokens}),
            "mesh": (to_mesh(sparams, smesh, lambda s, m, n:
                             sharding.serve_param_spec(s, m, name=n)),
                     to_mesh({"tokens": tokens}, smesh, lambda s, m, n:
                             sharding.serve_batch_spec(s, m)))}.items():
        prefill(p, b)                       # first use
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = prefill(p, b)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        counts = read_counts()
        expect = {n: 0 for n in counted()}
        expect["flash_attention"] = scfg.num_layers
        expect_counts(f"mesh prefill {name}", counts, expect)
        add(counts)
        results[name] = (getattr(out, "to_local", lambda: out)(), ms,
                         counts)
    equal = torch.equal(results["plain"][0], results["mesh"][0])
    print(f"check mesh prefill {SERVE_ARCH} bf16 {SERVE_BATCH} x "
          f"{SERVE_PROMPT} tokens, params as DTensors on a one-device "
          f"(data, model) mesh: tokens equal to the plain step's: {equal}; "
          f"ms plain={results['plain'][1]:.3f} mesh="
          f"{results['mesh'][1]:.3f}; launches added B9="
          f"{results['plain'][2]['flash_attention']} + "
          f"{results['mesh'][2]['flash_attention']} B10="
          f"{results['plain'][2]['rwkv6_scan']} + "
          f"{results['mesh'][2]['rwkv6_scan']}", flush=True)
    if not equal:
        fail("mesh prefill: the one-device mesh step differs from the "
             "plain step")
    del sparams, results, out, p, b
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # -- rwkv6-7b and mixtral-8x7b prefills: the step and the model on the
    # one-device mesh's DTensors ------------------------------------------
    for arch, layers, kernel in MESH_PREFILLS:
        mesh_prefill(dev, add, expect_counts, smi, smesh, arch, layers,
                     kernel)

    # -- one mesh train step on a one-device ("fed", "dp", "tp") mesh -----
    arch, layers = MESH_STEP_ARCH
    tcfg = dataclasses.replace(cut_depth(get_arch(arch), layers),
                               dtype="bfloat16")
    train = TrainConfig(learning_rate=schedules.cosine(
        MESH_LR, MESH_STEPS + 1, 100), remat="full")
    step = steps.make_fed_train_step(tcfg, FedConfig(num_nodes=MESH_F),
                                     train)
    batch = mesh_batch(tcfg, MESH_F, MESH_BATCH, MESH_SEQ, 43, dev)
    fmesh = DeviceMesh("cuda", torch.zeros((1, 1, 1), dtype=torch.int64),
                       mesh_dim_names=("fed", "dp", "tp"))
    done = {}
    for name in ("plain", "mesh"):
        state = mesh_state(tcfg, MESH_F, torch.Generator(device=dev)
                           .manual_seed(43), dev, MESH_RATIOS)
        b = batch
        if name == "mesh":
            state = to_mesh(state, fmesh, lambda s, m, n:
                            sharding.fed_param_spec(s, m, name=n))
            b = to_mesh(batch, fmesh, lambda s, m, n:
                        sharding.fed_batch_spec(s, m))
        # the first step pays for the allocator's first blocks; the next
        # MESH_CODE_TIMED are timed one by one (median), and their peak
        # allocation above the state is the step's transient memory
        reset_counts()
        state, loss = step(state, b)
        times = []
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(MESH_CODE_TIMED):
            t0 = time.perf_counter()
            state, loss = step(state, b)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        transient_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
        counts = read_counts()
        expect = {n: 0 for n in counted()}
        expect["rwkv6_scan"] = 2 * (1 + MESH_CODE_TIMED) * layers * MESH_F
        expect_counts(f"mesh train step {name}", counts, expect)
        add(counts)
        done[name] = (state, loss, statistics.median(times), counts,
                      transient_gb)
        del state, b
    (ps, pl, pms, pc, pgb), (ms_, ml, mms, mc, mgb) = done["plain"], \
        done["mesh"]
    local = [leaf.to_local() for leaf in tree_leaves(
        [ms_.params, ms_.opt.m, ms_.opt.v])] + [ms_.opt.step.to_local()]
    plain = tree_leaves([ps.params, ps.opt.m, ps.opt.v]) + [ps.opt.step]
    same = len(local) == len(plain) and torch.equal(pl, ml) and all(
        torch.equal(a, b) for a, b in zip(local, plain))
    print(f"check mesh train step {arch} {layers} layers bf16 F={MESH_F} "
          f"state as DTensors on a one-device (fed, dp, tp) mesh, a ring "
          f"one rank wide, {1 + MESH_CODE_TIMED} steps: params, moments, "
          f"steps and loss ({ml.item():.6f}) equal to the plain steps': "
          f"{same} ({len(plain)} tensors); ms median of steps 2-"
          f"{1 + MESH_CODE_TIMED} plain={pms:.3f} mesh={mms:.3f}; GB "
          f"allocated above the state at the peak plain={pgb:.3f} "
          f"mesh={mgb:.3f}; launches added B9="
          f"{pc['flash_attention']} + {mc['flash_attention']} B10="
          f"{pc['rwkv6_scan']} + {mc['rwkv6_scan']}", flush=True)
    if not same:
        fail("mesh train step: the one-device mesh step differs from the "
             "plain step")
    del done, ps, ms_, local, plain, batch, step
    dist.destroy_process_group()
    store.unlink(missing_ok=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # -- the dry runs' records ---------------------------------------------
    for arch, shape, pods, out, t0, proc in runs:
        try:
            text, _ = proc.communicate(
                timeout=max(1.0, DRYRUN_TIMEOUT - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            fail(f"mesh dryrun {arch} x {shape}: over {DRYRUN_TIMEOUT} s")
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"mesh dryrun {arch} x {shape} two_pods={pods}: exit "
                 f"{proc.returncode}: {text[-3000:]}")
        rec = json.loads(out.read_text())["records"][0]
        gb = rec["bytes_per_device"]["arguments"] / 1e9
        print(f"mesh dryrun {arch} x {shape} "
              f"{'two pods' if pods else 'one pod'}: devices="
              f"{rec['devices']} fed_nodes={rec['fed_nodes']} "
              f"gb_per_device={gb:.3f} (arguments; outputs "
              f"{rec['bytes_per_device']['outputs'] / 1e9:.3f}) "
              f"counted_gflops={rec['hlo_gflops']:.1f} counted_hbm_gb="
              f"{rec['hbm_gb']:.2f} collectives={rec['collective_counts']} "
              f"wire_gb={rec['wire_gb']:.3f} consensus_wire_bytes_per_node="
              f"{rec['consensus_wire_bytes_per_node']:.0f} "
              f"useful_flops_ratio={rec['useful_flops_ratio']:.3f} "
              f"bottleneck={rec['bottleneck']} run_s={rec['compile_s']} "
              f"process_s={secs:.1f} (counts priced at the H100's peaks, "
              f"not times)", flush=True)
    print(f"phase mesh code {time.perf_counter() - t_phase:.1f}s",
          flush=True)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for sub in tree.values() for leaf in tree_leaves(sub)]
    if isinstance(tree, list):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def main() -> None:
    # -- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    print(f"device {kind} count={torch.cuda.device_count()} torch="
          f"{torch.__version__} cuda={torch.version.cuda}", flush=True)

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import mobility
    from repro_torch.configs.base import (FaultConfig, FedConfig,
                                          HierarchyConfig, MobilityConfig,
                                          TrainConfig)
    from repro_torch.configs.paper_models import MLP_CONFIG
    from repro_torch.core import cdfl, transport
    from repro_torch.core.cdfl import round_slice
    from repro_torch.data import synthetic
    from repro_torch.faults import compile_plan
    from repro_torch.faults.robust import sorted_weights
    from repro_torch.hierarchy import mixing as hier
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import cluster_mix as clm
    from repro_torch.kernels import cnd_sketch as cs
    from repro_torch.kernels import consensus_mix as cm
    from repro_torch.kernels import robust_agg as ra
    from repro_torch.kernels import sparse_mix as sm
    from repro_torch.models import simple

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all(force=True)
    secs = time.perf_counter() - t0
    regs = [ln.strip() for log in logs.values() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"build {secs:.1f}s sources={sorted(logs)} "
          f"ptxas={' | '.join(regs)}", flush=True)
    # each library is keyed on its source's bytes and the nvcc flags
    # (kernels/_build.py): these digests tie a result to its source
    print("build digests " + " ".join(
        f"{name}={_build.digest(name)}" for name in sorted(logs)),
        flush=True)
    for lib in ("consensus_mix", "rwkv6_scan", "robust_agg", "sparse_mix",
                "flash_attention"):
        for name, n_regs, st, ld in ptxas_kernels(logs[lib]):
            print(f"ptxas {lib} {name} registers={n_regs} "
                  f"spill_stores={st} spill_loads={ld}", flush=True)
            # f32 B9 is f32::flash_kernel<D> (mangled ..3f3212flash_kernel..)
            if (lib in ("robust_agg", "sparse_mix")
                    or "3f3212flash_kernel" in name) and (st or ld):
                fail(f"{lib} kernel {name} spills ({st} bytes stored, {ld} "
                     f"loaded)")
    sass = subprocess.run(
        [str(Path(_build.nvcc()).parent / "cuobjdump"), "-sass",
         str(_build.library_path("robust_agg"))], capture_output=True,
        text=True, check=True, timeout=120).stdout
    n_ins, n_steps = walk_loop(sass)
    if n_steps == 0:
        fail("no loop of B7's group walk reads pairs with LDS.128")
    print(f"sass robust_agg group walk loop instructions={n_ins} "
          f"steps={n_steps} per_step={n_ins / n_steps:.2f}", flush=True)

    nodes4 = paper_nodes(4)
    data4, items4 = node_arrays(nodes4)
    t0 = time.perf_counter()
    data256, items256 = node_arrays(paper_nodes(256))
    print(f"data K=256 built in {time.perf_counter() - t0:.1f}s "
          f"({data256['x'].nbytes / 1e6:.0f} MB of inputs)", flush=True)
    t0 = time.perf_counter()
    data1024, items1024 = node_arrays(paper_nodes(FLEET_K, n=96))
    data64, items64 = node_arrays(paper_nodes(64, n=96))
    print(f"data K={FLEET_K} built in {time.perf_counter() - t0:.1f}s "
          f"({data1024['x'].nbytes / 1e6:.0f} MB of inputs)", flush=True)

    # -- 2b. the K=1024 fleet's per-round mixing stacks, built once -------
    # Manhattan mobility (benchmarks/paper_tables.py MOBILITY_SCENARIOS),
    # cdfl, bf16 wire; sparse top-8 and hierarchical. The host builds the
    # whole horizon once (traces, links, clusters, leaders) before any
    # timed window; the path phases below slice it.
    loss = simple.make_mlp_loss(MLP_CONFIG)
    train = TrainConfig(learning_rate=1e-3, batch_size=32)
    p0 = simple.mlp_init(torch.Generator().manual_seed(0), MLP_CONFIG,
                         device="cpu")
    fleet_feds = {
        "sparse": FedConfig(num_nodes=FLEET_K, gamma=0.5, local_steps=10,
                            wire_dtype="bf16", mixing_format="sparse",
                            degree=8, mobility=MobilityConfig(**MANHATTAN)),
        "hierarchical": FedConfig(
            num_nodes=FLEET_K, gamma=0.5, local_steps=10, wire_dtype="bf16",
            mixing_format="hierarchical",
            hierarchy=HierarchyConfig(max_cluster_size=16, inter_degree=4,
                                      remerge_burst=1),
            mobility=MobilityConfig(**MANHATTAN))}
    fleet = {}
    for fmt, fed in fleet_feds.items():
        tr = cdfl.build_trainer(loss, fed, train)
        state = tr.init(p0, items1024)
        t0 = time.perf_counter()
        etas, gammas = tr.mixing_stack(state, FLEET_ROUNDS)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        fleet[fmt] = (tr, etas, gammas)
        if fmt == "sparse":
            shape = f"idx {tuple(etas.idx.shape)}"
        else:
            shape = (f"intra {tuple(etas.intra.idx.shape)} inter "
                     f"{tuple(etas.inter.idx.shape)} clusters/round "
                     f"{[len(set(c.tolist())) for c in etas.cluster]} "
                     f"burst rounds "
                     f"{[r for r, b in enumerate(etas.burst) if b > 0]}")
        print(f"stacks {fmt} K={FLEET_K} R={FLEET_ROUNDS} built in "
              f"{build_s:.2f}s on the host (trace, links"
              f"{', clusters, leaders' if fmt != 'sparse' else ''}, "
              f"weights): {shape}", flush=True)

    # -- 3. every kernel against its plain version ------------------------
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def record(name, shape, err, fn, plain_fn, lib_fn, nbytes, ops, rate,
               lib_graph=True, extra=None, slow=False, table=True):
        """``slow``: time the plain and library versions over 2 calls x 5
        runs (they take tens of ms a call). ``table=False``: print the line
        and keep the kernel table's row as it was (its path shape)."""
        b_ms, b_by = bound(nbytes, ops, rate)
        ms, graph_ms = timing(fn)
        few = dict(launches=2, reps=5) if slow else {}
        plain_ms, plain_graph_ms = timing(plain_fn, **few)
        lib_ms, lib_graph_ms = (timing(lib_fn, graph=lib_graph, **few)
                                if lib_fn else (None, None))
        fmt = lambda v: "null" if v is None else f"{v:.5f}"
        more = "".join(f" {k}={v}" for k, v in (extra or {}).items())
        print(f"kernel {name} {shape} max_abs_err={err:.3e} ms={ms:.5f} "
              f"graph_ms={graph_ms:.5f} plain_ms={plain_ms:.5f} "
              f"plain_graph_ms={plain_graph_ms:.5f} library_ms="
              f"{fmt(lib_ms)} library_graph_ms={fmt(lib_graph_ms)} "
              f"bound_ms={b_ms:.5f} ({b_by}){more}", flush=True)
        row = rows.setdefault(name, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if not table:
            return
        row.update(shape=shape, ms=ms, graph_ms=graph_ms, plain_ms=plain_ms,
                   plain_graph_ms=plain_graph_ms, library_ms=lib_ms,
                   library_graph_ms=lib_graph_ms, bound_ms=b_ms,
                   bound_by=b_by, **(extra or {}))

    def flat_inputs(k, p, off=0):
        """A (K, P) f32 master and its bf16 wire, views that start ``off``
        elements into their buffers, and a row-stochastic eta with a zero
        diagonal."""
        flat = torch.randn(k * p + off, generator=gen, device=dev)
        master = flat[off:].view(k, p)
        wire16 = flat.to(torch.bfloat16)[off:].view(k, p)
        eta = torch.rand((k, k), generator=gen, device=dev)
        eta.fill_diagonal_(0.0)
        eta = (eta / eta.sum(dim=1, keepdim=True)).contiguous()
        return master, wire16, eta

    def flat_err(eta, master, wire, gamma, label):
        """B1 (``wire`` given) or B2 (``wire`` None) against its plain
        version: max |diff|; fails outside RTOL/ATOL."""
        if wire is None:
            out = cm.flat_consensus(eta, master)
            want = ref.flat_consensus(eta, master)
        else:
            out = cm.flat_mix(eta, master, wire, gamma)
            want = ref.flat_mix(eta, master, wire, gamma)
        torch.cuda.synchronize()
        err = (out - want).abs().max().item()
        if not torch.allclose(out, want, rtol=RTOL, atol=ATOL):
            fail(f"{label} disagrees with its plain version: max |diff| "
                 f"{err:.3e}")
        return err

    gamma = torch.full((1,), 0.5, device=dev)
    # K=1024 (the fleet's dense exchange, bf16 wire) before K=256: the
    # kernel table keeps each name's last row, the K=256 path's shape
    dense_b1_ms = None
    for k in (4, FLEET_K, 256):
        master, wire16, eta = flat_inputs(k, P)
        for wdt in ((torch.bfloat16,) if k == FLEET_K
                    else (torch.float32, torch.bfloat16)):
            wire = master if wdt == torch.float32 else wire16
            shape = f"K={k} P={P} wire={str(wdt)[6:]}"
            err = flat_err(eta, master, wire, gamma, f"flat_mix {shape}")
            w32 = wire.float()
            row = eta.sum(dim=1)
            a_pre = (0.5 * (eta - torch.diag(row))).contiguous()
            wbytes = wire.element_size()
            record("flat_mix", shape, err,
                   lambda: cm.flat_mix(eta, master, wire, gamma),
                   lambda: ref.flat_mix(eta, master, wire, gamma),
                   lambda: torch.addmm(master, a_pre, w32),
                   4 * k * k + (8 + wbytes) * k * P + 4,
                   2 * k * k * P + 4 * k * P, F32_OPS_PER_S)
            if k == FLEET_K:
                dense_b1_ms = rows["flat_mix"]["graph_ms"]
        err = flat_err(eta, master, None, None, f"flat_consensus K={k}")
        record("flat_consensus", f"K={k} P={P}", err,
               lambda: cm.flat_consensus(eta, master),
               lambda: ref.flat_consensus(eta, master),
               lambda: torch.matmul(eta, master),
               4 * k * k + 8 * k * P, 2 * k * k * P, F32_OPS_PER_S)

    # B1 (f32 and bf16 wire) and B2 where the tiled kernel's masks and
    # paths reach: K past the cut-over and ragged against its 16-node
    # stages and 64/128-row tiles; P ragged against its 128 columns and
    # 16-byte runs; and contiguous views 4 bytes (f32) or 2 bytes (bf16)
    # past a 16-byte boundary, which take its scalar copies
    worst, calls = 0.0, 0
    for k, p, off in ([(k, p, 0) for k in (25, 33, 64, 100, 256, FLEET_K)
                       for p in (P, 23_560, 1_001)] + [(256, P, 1)]):
        master, wire16, eta = flat_inputs(k, p, off)
        for wire in (master, wire16, None):
            what = ("flat_consensus" if wire is None
                    else f"flat_mix wire={wire.dtype}")
            worst = max(worst, flat_err(eta, master, wire, gamma,
                                        f"{what} K={k} P={p} offset={off}"))
            calls += 1
    print(f"check flat sweep K=25,33,64,100,256,{FLEET_K} x P={P},23560,1001 "
          f"(B1 f32 and bf16 wire, B2) and views one element past a 16-byte "
          f"boundary at K=256 (master +4 B, bf16 wire +2 B): {calls} calls, "
          f"worst max|diff|={worst:.3e} within rtol={RTOL} atol={ATOL}",
          flush=True)
    del master, wire16
    variant_kernel_rows(dev, gen, record)

    for items_np in (items4, items256):
        items = torch.as_tensor(items_np, device=dev).contiguous()
        k, n, f = items.shape
        h, m = 3, 8192
        bm = cs.cnd_bitmaps(items, h, m)
        want = ref.cnd_bitmaps(items, h, m)
        torch.cuda.synchronize()
        if not torch.equal(bm, want):
            fail(f"cnd_bitmaps K={k} differs from its plain version in "
                 f"{(bm != want).sum().item()} words")
        record("cnd_bitmaps", f"K={k} n={n} f={f} H={h} m={m}", 0.0,
               lambda: cs.cnd_bitmaps(items, h, m),
               lambda: ref.cnd_bitmaps(items, h, m), None, 4 * k * n * f + 4 * k * h * m // 32,
               k * n * h * (12 * f + 15), INT32_OPS_PER_S)
        cnt = cs.cnd_popcount(bm)
        want_cnt = ref.cnd_popcount(bm)
        torch.cuda.synchronize()
        if not torch.equal(cnt, want_cnt):
            fail(f"cnd_popcount K={k} differs from its plain version")
        record("cnd_popcount", f"K={k} H={h} W={m // 32}", 0.0,
               lambda: cs.cnd_popcount(bm),
               lambda: ref.cnd_popcount(bm), None,
               4 * k * h * m // 32 + 4 * k * h, 2 * k * h * m // 32,
               INT32_OPS_PER_S)

    # B5/B6 on the K=1024 fleet's round-0 neighbor tables. The yardstick
    # is torch.sparse.mm of the same eta in CSR form times the f32 wire:
    # the neighbor sum only, without the delta form.
    def csr(idx, val):
        k, d = idx.shape
        rows_ = torch.arange(k, device=dev).repeat_interleave(d)
        coo = torch.sparse_coo_tensor(
            torch.stack([rows_, idx.reshape(-1).long()]), val.reshape(-1),
            (k, k), check_invariants=True)
        return coo.coalesce().to_sparse_csr()

    def gather_bytes(k, d, wire):
        """(each input read once, every gathered row from HBM): tables,
        the f32 master, the wire (its self row plus D gathered rows), the
        f32 output. An f32 wire on the path IS the master buffer, so read
        once it adds nothing."""
        e = wire.element_size()
        once = 8 * k * d + (4 + (0 if wire is master else e) + 4) * k * P
        gather = 8 * k * d + (4 + e * (d + 1) + 4) * k * P
        return once, gather

    def check(name, out, want):
        torch.cuda.synchronize()
        if not torch.allclose(out, want, rtol=RTOL, atol=ATOL):
            fail(f"{name} disagrees with its plain version: max |diff| "
                 f"{(out - want).abs().max().item():.3e}")
        return (out - want).abs().max().item()

    master = torch.randn((FLEET_K, P), generator=gen, device=dev)
    sp0 = round_slice(fleet["sparse"][1], 0)
    h0 = round_slice(fleet["hierarchical"][1], 0)
    b5_cases = [  # (label, table, gamma, wire dtype); the path's shape last
        ("sparse tier", sp0, fleet["sparse"][2][0:1], torch.float32),
        ("hierarchical inter tier", h0.inter,
         fleet["hierarchical"][2][0:1], torch.float32),
        ("sparse tier", sp0, fleet["sparse"][2][0:1], torch.bfloat16)]
    for label, table, gamma, wdt in b5_cases:
        wire = master if wdt == torch.float32 else master.to(wdt)
        idx, val = table
        out = sm.sparse_mix(idx, val, master, wire, gamma)
        err = check(f"sparse_mix {label} wire={wdt}", out,
                    ref.sparse_mix(idx, val, master, wire, gamma))
        k, d = idx.shape
        once, gather = gather_bytes(k, d, wire)
        a_csr, w32 = csr(idx, val), wire.float()
        record("sparse_mix", f"K={k} D={d} P={P} wire={str(wdt)[6:]} "
               f"({label}, Manhattan round 0)", err,
               lambda: sm.sparse_mix(idx, val, master, wire, gamma),
               lambda: ref.sparse_mix(idx, val, master, wire, gamma),
               lambda: torch.sparse.mm(a_csr, w32), once,
               2 * k * d * P + 4 * k * P, F32_OPS_PER_S, lib_graph=False,
               extra={"bytes_once": once, "bytes_gather": gather,
                      "library": "torch.sparse.mm(csr eta, f32 wire), "
                                 "neighbor sum only"})
    # B6 without a plan: the faulted sparse exchange (core/transport.py's
    # `sent` branch), K=1024 top-8, bf16 payloads that differ from the bf16
    # self payload, one step size broadcast to every node
    other = torch.randn((FLEET_K, P), generator=gen, device=dev)
    idx, val = sp0
    k, d = idx.shape
    g_all = fleet["sparse"][2][0].reshape(1).expand(k).contiguous()
    wire, wself = other.to(torch.bfloat16), master.to(torch.bfloat16)
    err = check("cluster_mix sparse sent (walk)",
                clm.cluster_mix(idx, val, master, wself, wire, g_all),
                ref.cluster_mix(idx, val, master, wself, wire, g_all))
    once = 8 * k * d + (4 + 2 + 2 + 4) * k * P
    a_csr, w32 = csr(idx, val), wire.float()
    record("cluster_mix", f"K={k} D={d} P={P} wire=bfloat16 (faulted sparse "
           f"exchange, no plan: the walk, Manhattan round 0)", err,
           lambda: clm.cluster_mix(idx, val, master, wself, wire, g_all),
           lambda: ref.cluster_mix(idx, val, master, wself, wire, g_all),
           lambda: torch.sparse.mm(a_csr, w32), once,
           2 * k * d * P + 4 * k * P, F32_OPS_PER_S, lib_graph=False,
           extra={"bytes_once": once, "rows_per_tile": k * d,
                  "library": "torch.sparse.mm(csr eta, f32 wire), "
                             "neighbor sum only"})

    # B6 with the hierarchical stack's plan (the intra tier and the re-merge
    # bursts): the staged walk. The plan's cost is its build on the host
    # for the fleet's 17-round horizon (inside the stack build above);
    # rows_per_tile counts the wire rows a column tile stages, against the
    # K * Di the walk gathers.
    idx, val = h0.intra
    k, d = idx.shape
    gnode, plan = h0.gamma_node, h0.plan
    hier_etas = fleet["hierarchical"][1]
    t0 = time.perf_counter()
    replan = clm.plan_stack(hier_etas.intra.idx.cpu().numpy(),
                            hier_etas.cluster.cpu().numpy())
    plan_s = time.perf_counter() - t0
    if any(not torch.equal(a.cpu(), b.cpu())
           for a, b in zip(replan, hier_etas.plan)):
        fail("the fleet stack's plan differs from a rebuild of it")
    counts = plan.counts.cpu()
    staged_rows = int(counts[:, 1].sum())
    plan_bytes = sum(t.numel() * t.element_size() for t in hier_etas.plan)
    print(f"plan hierarchical K={k} Di={d} R={FLEET_ROUNDS}: built in "
          f"{plan_s:.3f}s on the host, {plan_bytes} bytes; round 0: "
          f"{int((counts[:, 0] > 0).sum())} groups (padded to "
          f"{counts.shape[0]}), at most {int(counts[:, 0].max())} members "
          f"and {int(counts[:, 1].max())} rows a group, {staged_rows} rows "
          f"staged a tile against {k * d} gathered "
          f"({k * d / staged_rows:.2f}x fewer); zero-weight slots "
          f"{(val == 0).float().mean().item():.4f} of the table's",
          flush=True)
    worst_b6 = 0.0
    for wdt in (torch.float32, torch.bfloat16):
        # the separate self payload, checked with a wire that differs
        wire, wself = other.to(wdt), master.to(wdt)
        worst_b6 = max(worst_b6, check(
            f"cluster_mix wire={wdt} (separate self payload, staged)",
            clm.cluster_mix(idx, val, master, wself, wire, gnode, plan=plan),
            ref.cluster_mix(idx, val, master, wself, wire, gnode)))
        # a NaN in a row that only a zero-weight slot reads poisons the
        # receivers that list it, as 0 * NaN does in the reference
        zk, ze = (int(v) for v in (val == 0).nonzero()[0])
        wire = (master.clone() if wdt == torch.float32
                else master.to(wdt))
        wire[idx[zk, ze], 7] = float("nan")
        master_nan = wire if wdt == torch.float32 else master
        out = clm.cluster_mix(idx, val, master_nan, wire, wire, gnode,
                              plan=plan)
        want = ref.cluster_mix(idx, val, master_nan, wire, wire, gnode)
        torch.cuda.synchronize()
        if not (torch.isnan(out[zk, 7])
                and torch.allclose(out, want, rtol=RTOL, atol=ATOL,
                                   equal_nan=True)):
            fail(f"cluster_mix wire={wdt}: a NaN at zero-weight slot "
                 f"({zk}, {ze}) does not propagate as in the reference")
    for wdt, label in ((torch.float32, "re-merge burst pass"),
                       (torch.bfloat16, "intra tier")):
        wire = master if wdt == torch.float32 else master.to(wdt)
        out = clm.cluster_mix(idx, val, master, wire, wire, gnode, plan=plan)
        err = check(f"cluster_mix wire={wdt} (staged)", out,
                    ref.cluster_mix(idx, val, master, wire, wire, gnode))
        worst_b6 = max(worst_b6, err)
        walk = clm.cluster_mix(idx, val, master, wire, wire, gnode)
        torch.cuda.synchronize()
        if not torch.equal(out, walk):
            fail(f"cluster_mix wire={wdt}: the staged walk's bits differ "
                 f"from the walk's in {(out != walk).sum().item()} places")
        once, gather = gather_bytes(k, d, wire)
        a_csr, w32 = csr(idx, val), wire.float()
        record("cluster_mix", f"K={k} Di={d} P={P} wire={str(wdt)[6:]} "
               f"({label}, per-node gamma, staged by the plan, Manhattan "
               f"round 0)", err,
               lambda: clm.cluster_mix(idx, val, master, wire, wire, gnode,
                                       plan=plan),
               lambda: ref.cluster_mix(idx, val, master, wire, wire, gnode),
               lambda: torch.sparse.mm(a_csr, w32), once,
               2 * k * d * P + 4 * k * P, F32_OPS_PER_S, lib_graph=False,
               extra={"bytes_once": once, "bytes_gather": gather,
                      "rows_per_tile": staged_rows,
                      "gathers_per_tile": k * d, "plan_build_s": plan_s,
                      "library": "torch.sparse.mm(csr eta, f32 wire), "
                                 "neighbor sum only"})
    print(f"check cluster_mix staged: separate self payloads, NaN at a "
          f"zero-weight slot (f32, bf16), bits equal to the walk; worst "
          f"max|diff|={worst_b6:.3e} within rtol={RTOL} atol={ATOL}",
          flush=True)
    del master, other

    # B7 at the shapes of the platoon (K=8), the card-vs-CPU checks (K=64)
    # and the robust fleet (K=256, last: the path's shape). Masks as in
    # tests/test_faults.py:325: density about 0.6, own slot live, one
    # drained row. The library yardstick is torch.sort over the masked
    # candidates plus one batched product with the position weights,
    # chunked over P as the plain version is: no single PyTorch call
    # computes B7.
    def sort_bmm(w, mask, buf, sent):
        k = buf.shape[0]
        step = max(1, ref.ROBUST_CHUNK_ELEMS // (k * k))
        return torch.cat([torch.bmm(w[:, None, :], ref.robust_sorted(
            mask, buf[:, c:c + step], sent[:, c:c + step]))[:, 0]
            for c in range(0, buf.shape[1], step)], dim=1)

    for k in (8, 64, ROBUST_K):
        buf = torch.randn((k, P), generator=gen, device=dev)
        sent = torch.randn((k, P), generator=gen, device=dev)
        mask = (torch.rand((k, k), generator=gen, device=dev) < 0.6) | \
            torch.eye(k, dtype=torch.bool, device=dev)
        mask[k // 2] = False
        mask = mask.to(torch.float32)
        for mode, trim in (("median", 0), ("trimmed_mean", 1),
                           ("trimmed_mean", 2)):
            w = sorted_weights(mask, mode, trim)
            err = check(f"robust_agg K={k} {mode} trim={trim}",
                        ra.robust_agg(w, mask, buf, sent),
                        ref.robust_agg(w, mask, buf, sent))
            print(f"check robust_agg K={k} {mode} trim={trim} "
                  f"max_abs_err={err:.3e} (rtol={RTOL} atol={ATOL})",
                  flush=True)
            row = rows.setdefault("robust_agg", {"max_abs_err": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], err)
        # timed on the trimmed mean with trim 1, the fleet's rule
        w = sorted_weights(mask, "trimmed_mean", 1)
        record("robust_agg", f"K={k} P={P} trimmed_mean trim=1", err,
               lambda: ra.robust_agg(w, mask, buf, sent),
               lambda: ref.robust_agg(w, mask, buf, sent),
               lambda: sort_bmm(w, mask, buf, sent),
               12 * k * P + 8 * k * k, k * k * P, F32_OPS_PER_S, slow=True,
               extra={"library": "torch.sort of the masked (K, K, C) "
                                 "candidates + torch.bmm with the weights, "
                                 "chunked over P"})
    # edges: K neither a power of two nor a multiple of 32, and live
    # non-finite payloads (-inf sorts first, +inf and NaN last, all zeroed)
    k = 100
    buf = torch.randn((k, P), generator=gen, device=dev)
    sent = torch.randn((k, P), generator=gen, device=dev)
    sent[1, :999] = float("inf")
    sent[2, 500:1500] = float("-inf")
    sent[3, 1000:2000] = float("nan")
    mask = ((torch.rand((k, k), generator=gen, device=dev) < 0.6) |
            torch.eye(k, dtype=torch.bool, device=dev)).to(torch.float32)
    for mode, trim in (("median", 0), ("trimmed_mean", 1)):
        w = sorted_weights(mask, mode, trim)
        err = check(f"robust_agg K={k} {mode} trim={trim} non-finite",
                    ra.robust_agg(w, mask, buf, sent),
                    ref.robust_agg(w, mask, buf, sent))
        print(f"check robust_agg K={k} {mode} trim={trim} with live "
              f"non-finite payloads max_abs_err={err:.3e}", flush=True)
        rows["robust_agg"]["max_abs_err"] = max(
            rows["robust_agg"]["max_abs_err"], err)
    # the shared-memory plan's edges at P=1,024: K=1 (the own slot only),
    # K=17 (the widest column walk), K=33 (a second receiver group of one),
    # K=1024 (one block an SM, 128 KB of transposed weights); and at the
    # fleet's K=256 and P. Each with
    # a mask of density 0.6 (one drained row, one own slot masked off) and
    # an all-live mask, and with the trimmed mean and a W that is not a
    # band: random non-negative position weights, half of them zero, each
    # row summing to 1. (Weights of both signs cancel to outputs near 0 on
    # which two f32 summation orders differ by more than any relative
    # tolerance holds.)
    def scattered_weights(k):
        w = torch.rand((k, k), generator=gen, device=dev)
        w = w * (torch.rand((k, k), generator=gen, device=dev) < 0.5)
        return w / w.sum(dim=1, keepdim=True).clamp_min(1e-6)

    for k, p_k in ((1, 1024), (17, 1024), (33, 1024), (1024, 1024),
                   (ROBUST_K, P)):
        buf = torch.randn((k, p_k), generator=gen, device=dev)
        sent = torch.randn((k, p_k), generator=gen, device=dev)
        sparse = (torch.rand((k, k), generator=gen, device=dev) < 0.6) | \
            torch.eye(k, dtype=torch.bool, device=dev)
        if k > 1:
            sparse[k // 2] = False
            sparse[k - 1, k - 1] = False
        for label, mask in (("density 0.6", sparse.to(torch.float32)),
                            ("all live", torch.ones((k, k), device=dev))):
            for rule, w in (
                    ("trimmed_mean trim=1",
                     sorted_weights(mask, "trimmed_mean", 1)),
                    ("non-band W", scattered_weights(k))):
                err = check(f"robust_agg K={k} P={p_k} {label} {rule}",
                            ra.robust_agg(w, mask, buf, sent),
                            ref.robust_agg(w, mask, buf, sent))
                print(f"check robust_agg K={k} P={p_k} mask {label} {rule} "
                      f"max_abs_err={err:.3e}", flush=True)
                rows["robust_agg"]["max_abs_err"] = max(
                    rows["robust_agg"]["max_abs_err"], err)
    del buf, sent

    # B8 at rows 8,192 with N=8 in f32 and bf16, then at the paper MLP's
    # buffer as (187, 128) rows with its two ring neighbors (the path's
    # shape, last). The library yardstick is cuBLAS's gemv: torch.mv of
    # the neighbor stack viewed as (N, rows*L), transposed, with eta, then
    # the delta form around it.
    def bf16_ulp(x):
        """One bf16 unit in the last place of each f32 value of x."""
        a = x.abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
        return torch.exp2(torch.floor(torch.log2(a)) - 7)

    for rows_b8, n_b8, dt in ((8192, 8, torch.float32),
                              (8192, 8, torch.bfloat16),
                              (P // 128, 2, torch.float32)):
        w = torch.randn((rows_b8, 128), generator=gen, device=dev).to(dt)
        nb = torch.randn((n_b8, rows_b8, 128), generator=gen,
                         device=dev).to(dt)
        eta = torch.rand((n_b8,), generator=gen, device=dev)
        eta = (eta / eta.sum()).contiguous()
        gamma = torch.full((1,), 0.5, device=dev)
        out = cm.consensus_mix(w, nb, eta, gamma)
        want = ref.consensus_mix(w, nb, eta, gamma)
        torch.cuda.synchronize()
        diff = (out.float() - want.float()).abs()
        label = f"consensus_mix rows={rows_b8} N={n_b8} {str(dt)[6:]}"
        if dt == torch.float32:
            if not torch.allclose(out, want, rtol=RTOL, atol=ATOL):
                fail(f"{label} disagrees with its plain version: max |diff| "
                     f"{diff.max().item():.3e}")
        elif not bool((diff <= bf16_ulp(want.float())).all()):
            fail(f"{label} differs from its plain version by more than one "
                 f"bf16 ulp: max |diff| {diff.max().item():.3e}")
        e = rows_b8 * 128
        nb_t = nb.view(n_b8, e).t()
        eta_dt, eta_sum = eta.to(dt), eta.sum().to(dt)

        def gemv(w=w, nb_t=nb_t, eta_dt=eta_dt, eta_sum=eta_sum,
                 rows_b8=rows_b8):
            nbsum = torch.mv(nb_t, eta_dt).view(rows_b8, 128)
            return w + 0.5 * (nbsum - eta_sum * w)

        record("consensus_mix", f"rows={rows_b8} L=128 N={n_b8} "
               f"{str(dt)[6:]}", diff.max().item(),
               lambda: cm.consensus_mix(w, nb, eta, gamma),
               lambda: ref.consensus_mix(w, nb, eta, gamma), gemv,
               (n_b8 + 2) * e * w.element_size() + 4 * n_b8 + 4,
               (3 * n_b8 + 2) * e, F32_OPS_PER_S,
               extra={"library": "torch.mv(neighbors (N, rows*L)^T, eta) "
                                 "+ the delta form"})
    del w, nb
    print("kernels all eight agree with their plain versions "
          f"(B1/B2/B5/B6/B7 and B8 f32 rtol={RTOL} atol={ATOL}, B8 bf16 "
          f"within one bf16 ulp, B3/B4 bit for bit)", flush=True)
    # the launch floor: a one-element add_ timed as the kernels are, what
    # one host-issued launch (ms) and one CUDA-graph node (graph) cost
    # whatever the kernel does
    one = torch.zeros(1, device=dev)
    floor_ms, floor_graph_ms = timing(lambda: one.add_(1.0))
    print(f"launch floor add_ of 1 element ms={floor_ms:.5f} "
          f"graph_ms={floor_graph_ms:.5f}", flush=True)

    # -- 4. the paper path at K=4, on the card and on the CPU -------------
    totals = {name: 0 for name in read_counts()}
    dense_only = {"sparse_mix": 0, "cluster_mix": 0, "robust_agg": 0,
                  "consensus_mix": 0, "flash_attention": 0,
                  "rwkv6_scan": 0}

    def add(counts):
        for name, c in counts.items():
            totals[name] += c

    def expect_counts(label, counts, expect):
        for name, want in expect.items():
            if counts[name] != want:
                fail(f"{label}: {name} launched {counts[name]} times on the "
                     f"path, expected {want}")

    def drive(fed, rounds, seed, expect, data, items, check_loss=True):
        n = data["x"].shape[1]
        idx = torch.randint(0, n, (rounds, fed.num_nodes, fed.local_steps,
                                   train.batch_size),
                            generator=torch.Generator().manual_seed(seed))
        tr = cdfl.build_trainer(loss, fed, train)
        # one round first, so the timed run does not pay for loading
        # every kernel of the path on its first use
        tr.run_rounds(tr.init(p0, items), data, 1, idx=idx[:1])
        reset_counts()
        state = tr.init(p0, items)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, metrics = tr.run_rounds(state, data, rounds, idx=idx)
        torch.cuda.synchronize()
        round_ms = 1e3 * (time.perf_counter() - t0) / rounds
        counts = read_counts()
        if expect is not None:
            expect_counts(f"{fed.algorithm}/{fed.mixing_format}", counts,
                          expect)
            add(counts)
        tr_cpu = cdfl.build_trainer(loss, fed, train, device="cpu")
        state_cpu = tr_cpu.init(p0, items)
        final_cpu, metrics_cpu = tr_cpu.run_rounds(state_cpu, data, rounds,
                                                   idx=idx)
        if not torch.equal(state.ratios.cpu(), state_cpu.ratios):
            fail(f"{fed.algorithm}: ratios differ between card and CPU")
        diff = (final.buf.cpu() - final_cpu.buf).abs().max().item()
        if not diff <= 1e-4:
            fail(f"{fed.algorithm}/{fed.mixing_format}: card params differ "
                 f"from the CPU run by {diff:.3e} > 1e-4")
        lossr = metrics["loss"].mean(dim=1).cpu()
        if not torch.isfinite(lossr).all() or (check_loss
                                               and not lossr[-1] < lossr[0]):
            fail(f"{fed.algorithm}: loss did not fall: {lossr.tolist()}")
        return final, metrics, counts, diff, round_ms

    fed_k4 = fed = FedConfig(num_nodes=4, topology="ring", gamma=0.5,
                             local_steps=10)
    cdfl4, metrics, counts, diff, cdfl4_ms = drive(
        fed, 10, 1, {"flat_mix": 10, "flat_consensus": 0, "cnd_bitmaps": 1,
                     "cnd_popcount": 1, **dense_only}, data4, items4)
    lossr = [round(v, 4) for v in metrics["loss"].mean(dim=1).tolist()]
    dis = [f"{v:.2e}" for v in metrics["disagreement"].tolist()]
    ratios4 = [round(v, 4) for v in cdfl4.ratios.tolist()]
    print(f"path cdfl K=4 ratios={ratios4}"
          f" loss/round={lossr} disagreement={dis} launches={counts} "
          f"card-vs-cpu max|param diff|={diff:.3e} card ms/round="
          f"{cdfl4_ms:.3f}", flush=True)

    quickstart_and_resume(add, expect_counts, dense_only, loss, train,
                          fed_k4, data4, items4)

    # -- 5. fedavg at K=4 -------------------------------------------------
    fed = FedConfig(num_nodes=4, topology="ring", gamma=0.5, local_steps=10,
                    algorithm="fedavg")
    _, metrics, counts, diff, round_ms = drive(
        fed, 3, 2, {"flat_mix": 0, "flat_consensus": 3, "cnd_bitmaps": 1,
                    "cnd_popcount": 1, **dense_only}, data4, items4)
    print(f"path fedavg K=4 loss/round="
          f"{[round(v, 4) for v in metrics['loss'].mean(dim=1).tolist()]} "
          f"launches={counts} card-vs-cpu max|param diff|={diff:.3e} "
          f"card ms/round={round_ms:.3f}", flush=True)

    def runner(tr, state, data, gen, stacks=None):
        """``run(n)``: ``n`` more rounds of trainer ``tr`` from where its
        last call left off. With ``stacks`` = (etas, gammas), keyed on the
        absolute round, round r reads slice r."""
        box = [state]

        def run(n: int) -> None:
            kw = {}
            if stacks is not None:
                r = box[0].round
                kw = dict(eta_stack=round_slice(stacks[0], slice(r, r + n)),
                          gamma_stack=stacks[1][r:r + n])
            box[0], _ = tr.run_rounds(box[0], data, n, generator=gen, **kw)

        return run

    # -- 5a. kernel B8 through ops.consensus_mix ------------------------
    # Each station of the K=4 ring mixes its trained buffer, seen as the
    # (187, 128) rows of the paper MLP, with its two ring neighbors' under
    # the ring's CND weights: eq. 5 node by node, which the trainer's B1
    # computes for all nodes at once.
    from repro_torch.core import consensus, flatten
    tr4 = cdfl.build_trainer(loss, fed_k4, train)
    eta4, gamma4 = tr4.mixing(cdfl4)
    buf4 = cdfl4.buf
    rows4 = buf4.view(4, P // 128, 128)
    reset_counts()
    mixed = []
    for node in range(4):
        nbrs = [(node - 1) % 4, (node + 1) % 4]
        mixed.append(ops.consensus_mix(rows4[node], rows4[nbrs],
                                       eta4[node, nbrs], gamma4))
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts("B8 via ops.consensus_mix", counts, {
        "consensus_mix": 4, "flat_mix": 0, "flat_consensus": 0,
        "cnd_bitmaps": 0, "cnd_popcount": 0, "sparse_mix": 0,
        "cluster_mix": 0, "robust_agg": 0})
    add(counts)
    mixed = torch.stack(mixed).view(4, P)
    cpu = torch.stack([ops.consensus_mix(
        rows4[node].cpu(), rows4[[(node - 1) % 4, (node + 1) % 4]].cpu(),
        eta4[node, [(node - 1) % 4, (node + 1) % 4]].cpu(), gamma4.cpu())
        for node in range(4)]).view(4, P)
    eq5 = ref.flat_mix(eta4, buf4, buf4, gamma4)
    d_cpu = (mixed.cpu() - cpu).abs().max().item()
    d_eq5 = (mixed - eq5).abs().max().item()
    if not (d_cpu <= 1e-6 and d_eq5 <= 1e-6):
        fail(f"B8 path: the per-node mix differs from the CPU by {d_cpu:.3e}"
             f" and from the whole-buffer eq. 5 by {d_eq5:.3e} (> 1e-6)")
    print(f"path B8 ops.consensus_mix K=4 ring, (187, 128) rows, N=2: "
          f"launches={counts} card-vs-cpu max|diff|={d_cpu:.3e} vs "
          f"whole-buffer eq. 5 max|diff|={d_eq5:.3e} (<= 1e-6)", flush=True)

    # -- 5b. core/consensus.py one-shots on the K=4 params -----------------
    params4 = flatten.unflatten(buf4, cdfl4.layout)
    params4_cpu = {n: v.cpu() for n, v in params4.items()}
    nbrs0 = [3, 1]
    node0 = {n: v[0] for n, v in params4.items()}
    nb0 = {n: v[nbrs0] for n, v in params4.items()}

    def one_shots(params, node, nbrs, eta, gamma):
        return {
            "consensus_step": consensus.consensus_step(params, eta, gamma,
                                                       self_weight=0.8),
            "partial 0.5": consensus.partial_consensus_step(params, eta,
                                                            gamma, 0.5),
            "partial 0.75": consensus.partial_consensus_step(params, eta,
                                                             gamma, 0.75),
            "simulate_rounds": consensus.simulate_rounds(params, eta,
                                                         gamma, 8),
            "consensus_mix_pytree": ops.consensus_mix_pytree(
                node, nbrs, eta[0, nbrs0], gamma)}

    reset_counts()
    card = one_shots(params4, node0, nb0, eta4, gamma4)
    torch.cuda.synchronize()
    counts = read_counts()
    # B1: consensus_step, two partial steps, the pytree mix; B2: 8 rounds
    expect_counts("consensus one-shots", counts, {
        "flat_mix": 4, "flat_consensus": 8, "consensus_mix": 0,
        "cnd_bitmaps": 0, "cnd_popcount": 0, "sparse_mix": 0,
        "cluster_mix": 0, "robust_agg": 0})
    add(counts)
    host = one_shots(params4_cpu, {n: v[0] for n, v in params4_cpu.items()},
                     {n: v[nbrs0] for n, v in params4_cpu.items()},
                     eta4.cpu(), gamma4.cpu())
    diffs = {}
    for name, got in card.items():
        want = host[name]
        if name == "simulate_rounds":
            (got, series), (want, want_series) = got, want
            diffs["disagreement series"] = (series.cpu() - want_series).abs(
                ).max().item()
        diffs[name] = max((got[n].cpu() - want[n]).abs().max().item()
                          for n in got)
    if not max(diffs.values()) <= 1e-4:
        fail(f"consensus one-shots differ between card and CPU: {diffs}")
    series = card["simulate_rounds"][1].tolist()
    print(f"path consensus one-shots K=4 launches={counts} card-vs-cpu "
          f"max|diff|={ {n: f'{v:.3e}' for n, v in diffs.items()} } (<= 1e-4)"
          f" disagreement series={[f'{v:.3e}' for v in series]}", flush=True)

    # -- 5c. dpsgd at K=4: gossip (B1) before every local step ------------
    fed = dataclasses.replace(fed_k4, algorithm="dpsgd")
    _, metrics, counts, diff, round_ms = drive(
        fed, 10, 13, {"flat_mix": 10 * fed.local_steps, "flat_consensus": 0,
                      "cnd_bitmaps": 1, "cnd_popcount": 1, **dense_only},
        data4, items4)
    print(f"path dpsgd K=4 loss/round="
          f"{[round(v, 4) for v in metrics['loss'][:, 0].tolist()]} "
          f"disagreement="
          f"{[f'{v:.2e}' for v in metrics['disagreement'].tolist()]} "
          f"launches={counts} card-vs-cpu max|param diff|={diff:.3e} "
          f"card ms/round={round_ms:.3f}", flush=True)
    # dpsgd's extra cost over cdfl's round, timed in turns (ABBA) here
    runs = []
    for alg in ("cdfl", "dpsgd"):
        tr = cdfl.build_trainer(loss, dataclasses.replace(fed_k4,
                                                          algorithm=alg),
                                train)
        run = runner(tr, tr.init(p0, items4), data4,
                     torch.Generator().manual_seed(18))
        run(1)                                   # warm-up round
        runs.append(run)
    a_ms, b_ms, a_all, b_all = paired_ms(*runs, blocks=2, rounds=5)
    print(f"paired K=4 ms/round (turns cdfl, dpsgd, dpsgd, cdfl, twice): "
          f"cdfl={a_ms:.3f} dpsgd={b_ms:.3f} extra={b_ms - a_ms:.3f} "
          f"turns cdfl={[round(t, 3) for t in a_all]} dpsgd="
          f"{[round(t, 3) for t in b_all]}", flush=True)

    # -- 5d. cdfa_m at K=4: the leaf prefix on the wire -------------------
    # prefixes 40 (b1, b2) and 23,860 (every leaf, unpadded); a bf16 wire
    # runs 2 rounds (bf16 rounding steps drift between summation orders)
    for fraction in (0.5, 1.0):
        for wire, rounds in (("f32", 5), ("bf16", 2)):
            fed = dataclasses.replace(fed_k4, algorithm="cdfa_m",
                                      cdfa_fraction=fraction,
                                      wire_dtype=wire)
            _, metrics, counts, diff, round_ms = drive(
                fed, rounds, 14, {"flat_mix": rounds, "flat_consensus": 0,
                                  "cnd_bitmaps": 1, "cnd_popcount": 1,
                                  **dense_only}, data4, items4,
                check_loss=wire == "f32")
            prefix = flatten.prefix_length(cdfl4.layout, fraction)
            lossr = [round(v, 4) for v in metrics["loss"].mean(dim=1).tolist()]
            print(f"path cdfa_m K=4 fraction={fraction} prefix={prefix} "
                  f"wire={wire} rounds={rounds} loss/round={lossr} "
                  f"launches={counts} card-vs-cpu max|param diff|="
                  f"{diff:.3e} card ms/round={round_ms:.3f}", flush=True)

    def profiled(tr, state, data_dev, gen_idx, **kw):
        """One round under the profiler: (state, wall ms, busy by kernel,
        device event count). Fails when the round launched B1 and no
        kernel of ``B1_KERNELS`` shows device time."""
        b1_before = cm.flat_mix.launches
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = tr.run_rounds(state, data_dev, 1, generator=gen_idx,
                                     **kw)
            torch.cuda.synchronize()
            prof_ms = 1e3 * (time.perf_counter() - t0)
        busy, n_dev = device_profile(prof)
        b1_launched = cm.flat_mix.launches - b1_before
        if b1_launched and b1_ms(busy) <= 0:
            fail(f"profile: the round launched B1 {b1_launched} times but "
                 f"no kernel named {B1_KERNELS} shows device time")
        return state, prof_ms, busy, n_dev

    # -- 6. fleet at K=256, bf16 wire -------------------------------------
    fed = FedConfig(num_nodes=256, topology="ring", gamma=0.5,
                    local_steps=10, wire_dtype="bf16")
    reset_counts()
    tr = cdfl.build_trainer(loss, fed, train)
    state = tr.init(p0, items256)
    data_dev = {name: torch.as_tensor(v, device=dev)
                for name, v in data256.items()}
    gen_idx = torch.Generator().manual_seed(3)
    state, _ = tr.run_rounds(state, data_dev, 1, generator=gen_idx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = tr.run_rounds(state, data_dev, 5, generator=gen_idx)
    torch.cuda.synchronize()
    round_ms = 1e3 * (time.perf_counter() - t0) / 5
    # one more round under the profiler: device busy time by kernel
    state, prof_ms, busy, n_dev = profiled(tr, state, data_dev, gen_idx)
    counts = read_counts()
    expect_counts("fleet K=256", counts, {
        "flat_mix": 7, "flat_consensus": 0, "cnd_bitmaps": 1,
        "cnd_popcount": 1, **dense_only})
    add(counts)
    if not torch.isfinite(metrics["loss"]).all():
        fail("fleet: non-finite loss")
    busy_ms = sum(busy.values())
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
    b1 = b1_ms(busy)
    print(f"path fleet K=256 wire=bf16 ms/round={round_ms:.3f} "
          f"loss={metrics['loss'].mean().item():.4f} launches={counts}",
          flush=True)
    print(f"profile fleet round: wall_ms={prof_ms:.3f} device_busy_ms="
          f"{busy_ms:.3f} busy_share={busy_ms / prof_ms:.4f} "
          f"B1_ms={b1:.4f} B1_share_of_wall={b1 / prof_ms:.4f} "
          f"B1_share_of_busy={b1 / busy_ms:.4f} "
          f"device_events={n_dev} top="
          f"{[(n, round(v, 4)) for n, v in top]}", flush=True)
    fleet256_ms = round_ms
    fleet256 = runner(tr, state, data_dev, gen_idx)

    # -- 6d. cdfa_m on the K=256 ring: B1 on an unaligned prefix ----------
    # fraction 0.75: the prefix b1, b2, w1 (23,560 columns), bf16 wire
    fed = FedConfig(num_nodes=256, topology="ring", gamma=0.5,
                    local_steps=10, wire_dtype="bf16", algorithm="cdfa_m",
                    cdfa_fraction=0.75)
    reset_counts()
    tr = cdfl.build_trainer(loss, fed, train)
    state = tr.init(p0, items256)
    gen_idx = torch.Generator().manual_seed(15)
    state, _ = tr.run_rounds(state, data_dev, 1, generator=gen_idx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = tr.run_rounds(state, data_dev, 5, generator=gen_idx)
    torch.cuda.synchronize()
    round_ms = 1e3 * (time.perf_counter() - t0) / 5
    counts = read_counts()
    expect_counts("cdfa_m K=256", counts, {
        "flat_mix": 6, "flat_consensus": 0, "cnd_bitmaps": 1,
        "cnd_popcount": 1, **dense_only})
    add(counts)
    if not torch.isfinite(metrics["loss"]).all():
        fail("cdfa_m K=256: non-finite loss")
    print(f"path cdfa_m K=256 ring fraction=0.75 prefix="
          f"{flatten.prefix_length(state.layout, 0.75)} wire=bf16 "
          f"ms/round={round_ms:.3f} (cdfl fleet K=256 {fleet256_ms:.3f}) "
          f"loss={metrics['loss'].mean().item():.4f} launches={counts}",
          flush=True)
    state, prof_ms, busy, n_dev = profiled(tr, state, data_dev, gen_idx)
    busy_ms = sum(busy.values())
    print(f"profile cdfa_m K=256 round: wall_ms={prof_ms:.3f} device_busy_ms"
          f"={busy_ms:.3f} busy_share={busy_ms / prof_ms:.4f} B1_ms="
          f"{b1_ms(busy):.4f} device_events={n_dev}", flush=True)
    a_ms, b_ms, a_all, b_all = paired_ms(
        fleet256, runner(tr, state, data_dev, gen_idx), blocks=2, rounds=3)
    print(f"paired K=256 ring ms/round (turns cdfl, cdfa_m, cdfa_m, cdfl, "
          f"twice): cdfl={a_ms:.3f} cdfa_m={b_ms:.3f} extra="
          f"{b_ms - a_ms:.3f} turns cdfl={[round(t, 3) for t in a_all]} "
          f"cdfa_m={[round(t, 3) for t in b_all]}", flush=True)
    del data_dev

    # -- 6a. the twin of examples/mobility_platoon.py: K=8, dense ---------
    platoon = MobilityConfig(**PLATOON)
    nodes8 = [synthetic_nodes(i) for i in range(8)]
    data8, items8 = node_arrays(nodes8, local_steps=5)
    adj = mobility.adjacency_stack(platoon, 20, 8)
    comps = [mobility.num_components(a) for a in adj]
    fed = FedConfig(num_nodes=8, gamma=0.5, local_steps=5, mobility=platoon)
    _, metrics, counts, diff, round_ms = drive(
        fed, 20, 4, {"flat_mix": 20, "flat_consensus": 0, "cnd_bitmaps": 1,
                     "cnd_popcount": 1, **dense_only}, data8, items8,
        check_loss=False)
    lossr = metrics["loss"].mean(dim=1)
    print(f"path platoon K=8 dense components/round={comps} "
          f"churn={mobility.handover_stats(adj)['churn_rate']:.4f} "
          f"loss/round[0,5,10,15,19]="
          f"{[round(lossr[r].item(), 4) for r in (0, 5, 10, 15, 19)]} "
          f"gamma/round={[round(g, 4) for g in metrics['gamma'].tolist()]} "
          f"launches={counts} card-vs-cpu max|param diff|={diff:.3e} "
          f"card ms/round={round_ms:.3f}", flush=True)

    # -- 6b/6c. the K=1024 Manhattan fleet: sparse, then hierarchical -----
    # B1 bound at this K: what the dense exchange would at best take
    dense_ms, dense_by = bound(4 * FLEET_K * FLEET_K + 10 * FLEET_K * P,
                               2 * FLEET_K * FLEET_K * P + 4 * FLEET_K * P,
                               F32_OPS_PER_S)
    data_dev = {name: torch.as_tensor(v, device=dev)
                for name, v in data1024.items()}
    for fmt, (tr, etas, gammas) in fleet.items():
        gen_idx = torch.Generator().manual_seed(5)

        def rounds(state, lo, hi):
            return tr.run_rounds(state, data_dev, hi - lo, generator=gen_idx,
                                 eta_stack=round_slice(etas, slice(lo, hi)),
                                 gamma_stack=gammas[lo:hi])

        reset_counts()
        state = tr.init(p0, items1024)
        state, _ = rounds(state, 0, 1)                  # warm-up round
        times, losses = [], []
        for rep in range(3):
            lo = 1 + 5 * rep
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = rounds(state, lo, lo + 5)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0) / 5)
            losses.append(metrics["loss"].mean().item())
        counts = read_counts()
        timed = FLEET_ROUNDS - 1
        expect = {"flat_mix": 0, "flat_consensus": 0, "cnd_bitmaps": 1,
                  "cnd_popcount": 1, "sparse_mix": timed, "cluster_mix": 0,
                  "robust_agg": 0}
        if fmt == "hierarchical":
            bursts = int(etas.burst[:timed].sum().item())
            expect["cluster_mix"] = (timed + fleet_feds[fmt].hierarchy
                                     .remerge_burst * bursts)
        expect_counts(f"fleet {fmt} K={FLEET_K}", counts, expect)
        add(counts)
        if not all(np.isfinite(losses)):
            fail(f"fleet {fmt}: non-finite loss {losses}")
        extra = ""
        if fmt == "hierarchical":
            extra = (f" clusters/round={metrics['clusters'].tolist()} "
                     f"gamma_intra/round="
                     f"{[round(g, 4) for g in metrics['gamma_intra'].tolist()]}"
                     f" burst_rounds={bursts}")
        print(f"path fleet {fmt} K={FLEET_K} wire=bf16 Manhattan "
              f"ms/round median={statistics.median(times):.3f} "
              f"spread={max(times) - min(times):.3f} repeats="
              f"{[round(t, 3) for t in times]} loss/repeat="
              f"{[round(v, 4) for v in losses]} gamma="
              f"{[round(g, 4) for g in metrics['gamma'].tolist()]} "
              f"launches={counts}{extra}", flush=True)
        # the exchange alone (the wire cast and the gather kernels) on
        # round 0's stack, beside the dense B1 bound at this K
        eta0, g0 = round_slice(etas, 0), gammas[0]
        buf = state.buf
        if fmt == "sparse":
            dense_t = transport.DenseTransport(wire_dtype="bf16")
            ex_ms, ex_graph_ms = timing(
                lambda: dense_t.exchange(buf, eta0, g0))
        else:
            def two_tier():
                w = buf.to(torch.bfloat16)
                return hier.hier_mix_flat(buf, eta0, g0, wire=w, wire_self=w,
                                          burst_passes=1)
            ex_ms, ex_graph_ms = timing(two_tier)
        state, prof_ms, busy, n_dev = profiled(
            tr, state, data_dev, gen_idx,
            eta_stack=round_slice(etas, slice(timed, timed + 1)),
            gamma_stack=gammas[timed:])
        busy_ms = sum(busy.values())
        gather_ms = sum(v for n, v in busy.items()
                        if "gather_mix" in n or "staged_mix" in n)
        top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
        print(f"exchange {fmt} K={FLEET_K} round 0: ms={ex_ms:.5f} "
              f"graph_ms={ex_graph_ms:.5f} dense_B1_bound_ms={dense_ms:.5f} "
              f"({dense_by}) dense_B1_graph_ms={dense_b1_ms:.5f}", flush=True)
        print(f"profile fleet {fmt} round {timed}: wall_ms={prof_ms:.3f} "
              f"device_busy_ms={busy_ms:.3f} busy_share="
              f"{busy_ms / prof_ms:.4f} gather_kernels_ms={gather_ms:.4f} "
              f"B6_ms={b6_ms(busy):.4f} B6_share="
              f"{b6_ms(busy) / busy_ms:.4f} B1_ms={b1_ms(busy):.4f} "
              f"device_events={n_dev} top="
              f"{[(n, round(v, 4)) for n, v in top]}", flush=True)
    del data_dev

    # each fleet format on the card against the CPU at K=64, 3 rounds;
    # the f32 wire is the gate (a bf16 wire drifts by whole bf16 steps
    # between summation orders, ROADMAP C), the bf16 wire is reported
    for fmt, fed in fleet_feds.items():
        for wire in ("f32", "bf16"):
            small = dataclasses.replace(fed, num_nodes=64, wire_dtype=wire)
            if wire == "f32":
                _, metrics, _, diff, _ = drive(small, 3, 6, None, data64,
                                               items64, check_loss=False)
                print(f"check {fmt} K=64 wire=f32 card-vs-cpu "
                      f"max|param diff|={diff:.3e} (<= 1e-4)", flush=True)
                continue
            idx = torch.randint(0, 96, (2, 64, 10, 32),
                                generator=torch.Generator().manual_seed(7))
            outs = []
            for device in (None, "cpu"):
                tr = cdfl.build_trainer(loss, small, train, device=device)
                final, _ = tr.run_rounds(tr.init(p0, items64), data64, 2,
                                         idx=idx)
                outs.append(final.buf.cpu())
            print(f"check {fmt} K=64 wire=bf16 2 rounds card-vs-cpu "
                  f"max|param diff|={(outs[0] - outs[1]).abs().max():.3e} "
                  f"(reported, not gated)", flush=True)

    # -- 6e. dpsgd on the K=1024 Manhattan fleet, sparse and hierarchical --
    # per-step gossip of the f32 buffer (dpsgd has no codec) on the fleet's
    # own stacks from 2b, handed over as explicit per-round stacks: the
    # CND weights of those stacks, not dpsgd's uniform ones, so the
    # hierarchical stack is not built a second time. 1 warm-up and 5
    # timed rounds; the CPU check at K=64 builds dpsgd's own stacks.
    data_dev = {name: torch.as_tensor(v, device=dev)
                for name, v in data1024.items()}
    for fmt, (_, etas, gammas) in fleet.items():
        fed = dataclasses.replace(fleet_feds[fmt], algorithm="dpsgd",
                                  wire_dtype="f32")
        tr = cdfl.build_trainer(loss, fed, train)
        gen_idx = torch.Generator().manual_seed(16)

        def rounds(state, lo, hi):
            return tr.run_rounds(state, data_dev, hi - lo, generator=gen_idx,
                                 eta_stack=round_slice(etas, slice(lo, hi)),
                                 gamma_stack=gammas[lo:hi])

        reset_counts()
        state = tr.init(p0, items1024)
        state, _ = rounds(state, 0, 1)                  # warm-up round
        times = []
        for rep in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = rounds(state, 1 + 3 * rep, 4 + 3 * rep)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0) / 3)
        counts = read_counts()
        steps = 10 * fed.local_steps
        expect = {"flat_mix": 0, "flat_consensus": 0, "cnd_bitmaps": 1,
                  "cnd_popcount": 1, "sparse_mix": steps, "cluster_mix": 0,
                  "robust_agg": 0, "consensus_mix": 0}
        if fmt == "hierarchical":
            # B6 then B5 every step, never a re-merge burst
            expect["cluster_mix"] = steps
        expect_counts(f"dpsgd fleet {fmt} K={FLEET_K}", counts, expect)
        add(counts)
        if not torch.isfinite(metrics["loss"]).all():
            fail(f"dpsgd fleet {fmt}: non-finite loss")
        print(f"path dpsgd fleet {fmt} K={FLEET_K} wire=f32 Manhattan "
              f"ms/round median={statistics.median(times):.3f} repeats="
              f"{[round(t, 3) for t in times]} loss/round="
              f"{[round(v, 4) for v in metrics['loss'][:, 0].tolist()]} "
              f"launches={counts}", flush=True)
        # against the cdfl fleet round (bf16 wire, one exchange a round),
        # in turns on the same stacks: rounds 10-13 and 1-4
        cdfl_tr = fleet[fmt][0]
        cdfl_run = runner(cdfl_tr, cdfl_tr.init(p0, items1024), data_dev,
                          torch.Generator().manual_seed(19), (etas, gammas))
        cdfl_run(1)                                     # warm-up round
        a_ms, b_ms, a_all, b_all = paired_ms(
            cdfl_run, runner(tr, state, data_dev, gen_idx, (etas, gammas)),
            blocks=1, rounds=2)
        print(f"paired {fmt} K={FLEET_K} ms/round (turns cdfl, dpsgd, "
              f"dpsgd, cdfl): cdfl={a_ms:.3f} dpsgd={b_ms:.3f} extra="
              f"{b_ms - a_ms:.3f} turns cdfl={[round(t, 3) for t in a_all]}"
              f" dpsgd={[round(t, 3) for t in b_all]}", flush=True)
        small = dataclasses.replace(fed, num_nodes=64)
        _, _, _, diff, _ = drive(small, 3, 17, None, data64, items64,
                                 check_loss=False)
        print(f"check dpsgd {fmt} K=64 wire=f32 3 rounds card-vs-cpu "
              f"max|param diff|={diff:.3e} (<= 1e-4)", flush=True)
    del data_dev

    # -- 7. faults and robust mixing --------------------------------------
    def check_telemetry(label, metrics, plan):
        """health equals the compiled plan; every corrupted frame (NaN, or
        bit flips that blow a value past the guard's threshold) was
        quarantined and nothing else."""
        for name, want in (("health", plan.health),
                           ("quarantined", plan.corrupt)):
            got = metrics[name].cpu().numpy()
            if not np.array_equal(got, want):
                fail(f"{label}: {name} differs from the fault plan in "
                     f"{int((got != want).sum())} of {got.size} entries")

    # 7a. the Byzantine platoon (tests/test_faults.py:375): 8 vehicles, node
    # i holding classes {3i, 3i+1, 3i+2} mod 10, one sign-flip attacker
    k = 8
    byz_data, byz_items = node_arrays([synthetic_classes(i)
                                       for i in range(k)], local_steps=2)
    test_set = synthetic.synthetic_mnist(seed=99, n=400)
    test_x = torch.as_tensor(test_set.x, device=dev).expand(
        (k,) + test_set.x.shape)
    test_y = torch.as_tensor(test_set.y, device=dev).expand(
        (k,) + test_set.y.shape)

    def accuracy(params):
        return simple.accuracy(simple.mlp_forward(params, test_x), test_y)

    byz_train = TrainConfig(learning_rate=1e-3, batch_size=32)
    honest = np.ones(k, dtype=bool)
    honest[3] = False
    tails = {}
    for robust in (None, "trimmed_mean"):
        fed = FedConfig(num_nodes=k, local_steps=2, gamma=0.8,
                        mobility=MobilityConfig(**BYZ_PLATOON),
                        faults=FaultConfig(kinds=("byzantine",),
                                           byzantine=(3,)),
                        robust=robust)
        tr = cdfl.build_trainer(loss, fed, byz_train, eval_fn=accuracy)
        reset_counts()
        t0 = time.perf_counter()
        _, metrics = tr.run_rounds(tr.init(p0, byz_items), byz_data, 20,
                                   generator=torch.Generator().manual_seed(7))
        torch.cuda.synchronize()
        round_ms = 1e3 * (time.perf_counter() - t0) / 20
        counts = read_counts()
        label = "eq5" if robust is None else robust
        # eq. 5 under faults mixes the per-node payloads through B2
        expect_counts(f"byzantine platoon {label}", counts, {
            "flat_mix": 0, "flat_consensus": 0 if robust else 20,
            "robust_agg": 20 if robust else 0, "cnd_bitmaps": 1,
            "cnd_popcount": 1, "sparse_mix": 0, "cluster_mix": 0})
        add(counts)
        acc = metrics["eval"].cpu().numpy()
        tails[label] = float(acc[-5:, honest].mean())
        print(f"path byzantine platoon K={k} {label} honest accuracy/round="
              f"{[round(float(a), 3) for a in acc[:, honest].mean(axis=1)]}"
              f" tail(last 5)={tails[label]:.4f} launches={counts} "
              f"ms/round={round_ms:.3f}", flush=True)
    gap = tails["trimmed_mean"] - tails["eq5"]
    if not (tails["trimmed_mean"] >= 0.80 and gap > 0.10):
        fail(f"byzantine platoon: trimmed-mean honest tail "
             f"{tails['trimmed_mean']:.4f} (floor 0.80), {gap:.4f} above "
             f"eq. 5 (floor 0.10)")
    print(f"check byzantine platoon tails trimmed_mean="
          f"{tails['trimmed_mean']:.4f} eq5={tails['eq5']:.4f} "
          f"gap={gap:.4f} (>= 0.80, > 0.10)", flush=True)
    _, _, _, diff, _ = drive(fed, 3, 8, None, byz_data, byz_items,
                             check_loss=False)
    print(f"check byzantine platoon trimmed_mean K={k} 3 rounds card-vs-cpu "
          f"max|param diff|={diff:.3e} (<= 1e-4)", flush=True)

    # 7b. the faulted robust fleet: Manhattan, dense format, trimmed mean,
    # every fault kind; 1 warm-up round, FAULT_ROUNDS timed, 1 profiled
    fed = FedConfig(num_nodes=ROBUST_K, gamma=0.5, local_steps=10,
                    mobility=MobilityConfig(**MANHATTAN),
                    faults=FaultConfig(**ROBUST_FAULTS),
                    robust="trimmed_mean", trim=1)
    tr = cdfl.build_trainer(loss, fed, train)
    data_dev = {name: torch.as_tensor(v, device=dev)
                for name, v in data256.items()}
    gen_idx = torch.Generator().manual_seed(9)
    reset_counts()
    state = tr.init(p0, items256)
    # the warm-up round (faulted like every round) records B7's inputs of
    # the fleet's first exchange: its own Manhattan mask, checked below
    first = {}
    real_agg = ops.robust_agg

    def record_first(weights, mask, buf, sent):
        if not first:
            first.update(weights=weights.clone(), mask=mask.clone(),
                         buf=buf.clone(), sent=sent.clone())
        return real_agg(weights, mask, buf, sent)

    with unittest.mock.patch.object(ops, "robust_agg", record_first):
        state, _ = tr.run_rounds(state, data_dev, 1, generator=gen_idx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = tr.run_rounds(state, data_dev, FAULT_ROUNDS,
                                   generator=gen_idx)
    torch.cuda.synchronize()
    round_ms = 1e3 * (time.perf_counter() - t0) / FAULT_ROUNDS
    check_telemetry("robust fleet", metrics,
                    compile_plan(fed.faults, FAULT_ROUNDS, ROBUST_K, start=1))
    state, prof_ms, busy, n_dev = profiled(tr, state, data_dev, gen_idx)
    counts = read_counts()
    expect_counts(f"robust fleet K={ROBUST_K}", counts, {
        "flat_mix": 0, "flat_consensus": 0, "cnd_bitmaps": 1,
        "cnd_popcount": 1, "sparse_mix": 0, "cluster_mix": 0,
        "robust_agg": FAULT_ROUNDS + 2})
    add(counts)
    if not torch.isfinite(state.buf).all():
        fail("robust fleet: non-finite params")
    busy_ms = sum(busy.values())
    # B7's kernels (csrc/robust_agg.cu) are all named robust_agg_*
    b7_ms = sum(v for n, v in busy.items() if "robust_agg" in n)
    if b7_ms == 0:
        fail("profiled robust fleet round launched B7 but no robust_agg "
             "kernel shows device time")
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
    health = metrics["health"].cpu().numpy()
    print(f"path robust fleet K={ROBUST_K} Manhattan trimmed_mean faults="
          f"{'+'.join(fed.faults.kinds)} ms/round={round_ms:.3f} "
          f"crashed node-rounds={int((health == 0).sum())} quarantined="
          f"{int(metrics['quarantined'].sum().item())} frozen="
          f"{int(metrics['frozen'].sum().item())} loss/round="
          f"{[round(v, 4) for v in metrics['loss'].mean(dim=1).tolist()]} "
          f"launches={counts}", flush=True)
    print(f"profile robust fleet round: wall_ms={prof_ms:.3f} device_busy_ms="
          f"{busy_ms:.3f} busy_share={busy_ms / prof_ms:.4f} B7_ms="
          f"{b7_ms:.4f} B7_share_of_busy={b7_ms / busy_ms:.4f} device_events="
          f"{n_dev} top={[(n, round(v, 4)) for n, v in top]}", flush=True)
    # (a comparison launch: the path's counts were read above)
    err = check(f"robust_agg robust fleet K={ROBUST_K} first round's mask",
                ra.robust_agg(**first), ref.robust_agg(**first))
    rows["robust_agg"]["max_abs_err"] = max(
        rows["robust_agg"]["max_abs_err"], err)
    print(f"check robust_agg robust fleet K={ROBUST_K} P={P} first faulted "
          f"round's Manhattan mask ({int(first['mask'].sum().item())} live "
          f"of {ROBUST_K * ROBUST_K}) max_abs_err={err:.3e} (rtol={RTOL} "
          f"atol={ATOL})", flush=True)
    first.clear()
    del data_dev
    _, _, _, diff, _ = drive(dataclasses.replace(fed, num_nodes=64), 3, 10,
                             None, data64, items64, check_loss=False)
    print(f"check robust fleet K=64 3 rounds card-vs-cpu max|param diff|="
          f"{diff:.3e} (<= 1e-4)", flush=True)

    # 7c. the faulted K=1024 fleets, sparse and hierarchical (eq. 5: robust
    # mixing needs the dense format), on the stacks built in 2b; the fault
    # plan's link mask edits them inside run_rounds
    data_dev = {name: torch.as_tensor(v, device=dev)
                for name, v in data1024.items()}
    faults = FaultConfig(**FLEET_FAULTS)
    for fmt, (_, etas, gammas) in fleet.items():
        fed = dataclasses.replace(fleet_feds[fmt], faults=faults)
        tr = cdfl.build_trainer(loss, fed, train)
        gen_idx = torch.Generator().manual_seed(11)

        def rounds(state, lo, hi):
            return tr.run_rounds(state, data_dev, hi - lo, generator=gen_idx,
                                 eta_stack=round_slice(etas, slice(lo, hi)),
                                 gamma_stack=gammas[lo:hi])

        reset_counts()
        state = tr.init(p0, items1024)
        state, _ = rounds(state, 0, 1)                  # warm-up round
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = rounds(state, 1, 1 + FAULT_ROUNDS)
        torch.cuda.synchronize()
        round_ms = 1e3 * (time.perf_counter() - t0) / FAULT_ROUNDS
        counts = read_counts()
        done = 1 + FAULT_ROUNDS
        # with per-node payloads the sparse exchange is B6 (gathered rows
        # from the payloads, self rescale from the buffer); the
        # hierarchical one B6 then B5, B6 again on re-merge rounds
        expect = {"flat_mix": 0, "flat_consensus": 0, "cnd_bitmaps": 1,
                  "cnd_popcount": 1, "robust_agg": 0, "sparse_mix": 0,
                  "cluster_mix": done}
        if fmt == "hierarchical":
            bursts = int(etas.burst[:done].sum().item())
            expect["sparse_mix"] = done
            expect["cluster_mix"] = done + fed.hierarchy.remerge_burst * bursts
        expect_counts(f"faulted fleet {fmt} K={FLEET_K}", counts, expect)
        add(counts)
        check_telemetry(f"faulted fleet {fmt}", metrics,
                        compile_plan(faults, FAULT_ROUNDS, FLEET_K, start=1))
        if not torch.isfinite(state.buf).all():
            fail(f"faulted fleet {fmt}: non-finite params")
        health = metrics["health"].cpu().numpy()
        print(f"path faulted fleet {fmt} K={FLEET_K} Manhattan faults="
              f"{'+'.join(faults.kinds)} ({faults.corrupt_mode}) ms/round="
              f"{round_ms:.3f} crashed node-rounds={int((health == 0).sum())}"
              f" quarantined={int(metrics['quarantined'].sum().item())} "
              f"frozen={int(metrics['frozen'].sum().item())} loss/round="
              f"{[round(v, 4) for v in metrics['loss'].mean(dim=1).tolist()]}"
              f" launches={counts} (B1={counts['flat_mix']})", flush=True)
    del data_dev
    for fmt, fed in fleet_feds.items():
        small = dataclasses.replace(fed, num_nodes=64, wire_dtype="f32",
                                    faults=faults)
        _, metrics, _, diff, _ = drive(small, 3, 12, None, data64, items64,
                                       check_loss=False)
        check_telemetry(f"faulted fleet {fmt} K=64", metrics,
                        compile_plan(faults, 3, 64))
        print(f"check faulted {fmt} K=64 wire=f32 3 rounds card-vs-cpu "
              f"max|param diff|={diff:.3e} (<= 1e-4)", flush=True)

    paper_tables(dev, add, expect_counts, dense_only)
    batched_sweeps(dev, add, expect_counts, dense_only, fleet, fleet_feds,
                   loss, train, {FLEET_K: (data1024, items1024),
                                 SWEEP_RING_K: (data256, items256),
                                 64: (data64, items64)})
    transports_and_ingest(dev, add, expect_counts, dense_only, loss, train,
                          p0, fleet, fleet_feds,
                          {4: (data4, items4), 64: (data64, items64),
                           256: (data256, items256),
                           FLEET_K: (data1024, items1024)})

    serving(dev, rows, record, add, expect_counts, bf16_ulp)
    rwkv_serving(dev, rows, record, add, expect_counts)
    llm_training(dev, add, expect_counts)
    model_families(dev, rows, record, add, expect_counts, bf16_ulp)
    mesh_train(dev, add, expect_counts, smi)
    mesh_code(dev, add, expect_counts, smi, start_mesh_dryruns())

    # -- 10. kernel table -------------------------------------------------
    sources = {"flat_mix": ("src/repro_torch/csrc/consensus_mix.cu",
                            "src/repro/kernels/consensus_mix.py:77"),
               "flat_consensus": ("src/repro_torch/csrc/consensus_mix.cu",
                                  "src/repro/kernels/consensus_mix.py:109"),
               # B1 and B2 with a variant axis: the Pallas kernels under
               # jax.vmap (src/repro/core/cdfl.py:917-931)
               "flat_mix_variants": (
                   "src/repro_torch/csrc/consensus_mix.cu",
                   "src/repro/kernels/consensus_mix.py:77"),
               "flat_consensus_variants": (
                   "src/repro_torch/csrc/consensus_mix.cu",
                   "src/repro/kernels/consensus_mix.py:109"),
               "consensus_mix": ("src/repro_torch/csrc/consensus_mix.cu",
                                 "src/repro/kernels/consensus_mix.py:133"),
               "cnd_bitmaps": ("src/repro_torch/csrc/cnd_sketch.cu",
                               "src/repro/kernels/cnd_sketch.py:77"),
               "cnd_popcount": ("src/repro_torch/csrc/cnd_sketch.cu",
                                "src/repro/kernels/cnd_sketch.py:102"),
               "sparse_mix": ("src/repro_torch/csrc/sparse_mix.cu",
                              "src/repro/kernels/sparse_mix.py:92"),
               "cluster_mix": ("src/repro_torch/csrc/sparse_mix.cu",
                               "src/repro/kernels/cluster_mix.py:95"),
               "robust_agg": ("src/repro_torch/csrc/robust_agg.cu",
                              "src/repro/kernels/robust_agg.py:90"),
               "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:86"),
               "rwkv6_scan": ("src/repro_torch/csrc/rwkv6_scan.cu",
                              "src/repro/kernels/rwkv6_scan.py:85")}
    table = []
    for name, (source, replaces) in sources.items():
        row = rows[name]
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": totals[name],
                      "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                      "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                      "bound_by": row["bound_by"],
                      "library_ms": row["library_ms"], "shape": row["shape"],
                      "graph_ms": row["graph_ms"],
                      "plain_graph_ms": row["plain_graph_ms"],
                      "library_graph_ms": row["library_graph_ms"],
                      **{key: row[key] for key in (
                          "bytes_once", "bytes_gather", "library", "flop",
                          "rows_per_tile", "gathers_per_tile",
                          "plan_build_s", "variants", "loop_ms",
                          "loop_graph_ms") if key in row}})
        if name == "flash_attention":    # the path's launches by dtype
            table[-1].update({f"launches_{dt}": totals[f"flash_attention_{dt}"]
                              for dt in B9_SPLIT})
    print("loaded libraries " + " ".join(
        f"lib{name}.{key}.so" for name, key in
        sorted(_build.loaded_digests.items())), flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
