#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases: the device; the build of every CUDA kernel from
``src/repro_torch/csrc``; each kernel held against its plain PyTorch
version at the shapes of the main path, with CUDA-event timings; the
paper's C-DFL path at K=4 (cdfl, then fedavg), each checked against the
same run of the port on the CPU; a K=256 bf16-wire fleet, with one round
under the profiler; the kernel table as one JSON line; and the verdict as
the last line. Every path phase zeroes the kernels' launch counts before
it runs and checks them after. Exits non-zero, with no verdict, when CUDA
is absent or any check fails.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
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

P = 23_936                    # the paper MLP's lane-padded buffer width
RTOL, ATOL = 1e-5, 1e-6       # f32 kernels against their plain versions


def fail(msg: str) -> None:
    print(f"FAIL {msg}", flush=True)
    sys.exit(1)


def bound(nbytes: float, ops: float, ops_rate: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def timing(fn, launches: int = 20, reps: int = 20) -> tuple[float, float]:
    """Milliseconds per call of ``fn``: (1) ``launches`` calls issued back
    to back by the host between two CUDA events, what a caller pays; (2)
    the same calls captured in one CUDA graph and replayed, the device
    time without host launch gaps. Each is the median of ``reps`` runs."""
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
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        burst()
    return eager, run(graph.replay)


def paper_nodes(k: int):
    """The quickstart's stations: synthetic MNIST with 10-80% distinct
    items, cycled over ``k`` stations."""
    from repro_torch.data import redundancy, synthetic
    ratios = [0.1, 0.3, 0.5, 0.8]
    return [redundancy.inject_duplicates(
        synthetic.synthetic_mnist(seed=i, n=320, noise=2.0),
        ratios[i % 4], seed=i) for i in range(k)]


def node_arrays(nodes):
    from repro_torch.data import pipeline
    data = {"x": np.stack([d.x for d in nodes]),
            "y": np.stack([d.y for d in nodes])}
    items = pipeline.FederatedBatcher(nodes, 32, 10, seed=0).node_items()
    return data, items


def reset_counts(cm, cs) -> None:
    for fn in (cm.flat_mix, cm.flat_consensus, cs.cnd_bitmaps,
               cs.cnd_popcount):
        fn.launches = 0


def read_counts(cm, cs) -> dict:
    return {"flat_mix": cm.flat_mix.launches,
            "flat_consensus": cm.flat_consensus.launches,
            "cnd_bitmaps": cs.cnd_bitmaps.launches,
            "cnd_popcount": cs.cnd_popcount.launches}


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
    from repro_torch.configs.base import FedConfig, TrainConfig
    from repro_torch.configs.paper_models import MLP_CONFIG
    from repro_torch.core import cdfl
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import cnd_sketch as cs
    from repro_torch.kernels import consensus_mix as cm
    from repro_torch.models import simple

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all(force=True)
    secs = time.perf_counter() - t0
    regs = [ln.strip() for log in logs.values() for ln in log.splitlines()
            if "registers" in ln]
    print(f"build {secs:.1f}s sources={sorted(logs)} "
          f"ptxas={' | '.join(regs)}", flush=True)

    nodes4 = paper_nodes(4)
    data4, items4 = node_arrays(nodes4)
    t0 = time.perf_counter()
    data256, items256 = node_arrays(paper_nodes(256))
    print(f"data K=256 built in {time.perf_counter() - t0:.1f}s "
          f"({data256['x'].nbytes / 1e6:.0f} MB of inputs)", flush=True)

    # -- 3. every kernel against its plain version ------------------------
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def record(name, shape, err, fn, plain_fn, lib_fn, nbytes, ops, rate):
        b_ms, b_by = bound(nbytes, ops, rate)
        ms, graph_ms = timing(fn)
        plain_ms, plain_graph_ms = timing(plain_fn)
        lib_ms, lib_graph_ms = timing(lib_fn) if lib_fn else (None, None)
        fmt = lambda v: "null" if v is None else f"{v:.5f}"
        print(f"kernel {name} {shape} max_abs_err={err:.3e} ms={ms:.5f} "
              f"graph_ms={graph_ms:.5f} plain_ms={plain_ms:.5f} "
              f"plain_graph_ms={plain_graph_ms:.5f} library_ms="
              f"{fmt(lib_ms)} library_graph_ms={fmt(lib_graph_ms)} "
              f"bound_ms={b_ms:.5f} ({b_by})", flush=True)
        row = rows.setdefault(name, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row.update(shape=shape, ms=ms, graph_ms=graph_ms, plain_ms=plain_ms,
                   plain_graph_ms=plain_graph_ms, library_ms=lib_ms,
                   library_graph_ms=lib_graph_ms, bound_ms=b_ms,
                   bound_by=b_by)

    for k in (4, 256):
        master = torch.randn((k, P), generator=gen, device=dev)
        eta = torch.rand((k, k), generator=gen, device=dev)
        eta.fill_diagonal_(0.0)
        eta = (eta / eta.sum(dim=1, keepdim=True)).contiguous()
        gamma = torch.full((1,), 0.5, device=dev)
        for wdt in (torch.float32, torch.bfloat16):
            wire = master if wdt == torch.float32 else master.to(wdt)
            out = cm.flat_mix(eta, master, wire, gamma)
            want = ref.flat_mix(eta, master, wire, gamma)
            torch.cuda.synchronize()
            if not torch.allclose(out, want, rtol=RTOL, atol=ATOL):
                fail(f"flat_mix K={k} wire={wdt} disagrees with its plain "
                     f"version: max |diff| "
                     f"{(out - want).abs().max().item():.3e}")
            w32 = wire.float()
            row = eta.sum(dim=1)
            a_pre = (0.5 * (eta - torch.diag(row))).contiguous()
            wbytes = wire.element_size()
            record("flat_mix", f"K={k} P={P} wire={str(wdt)[6:]}",
                   (out - want).abs().max().item(),
                   lambda: cm.flat_mix(eta, master, wire, gamma),
                   lambda: ref.flat_mix(eta, master, wire, gamma),
                   lambda: torch.addmm(master, a_pre, w32),
                   4 * k * k + (8 + wbytes) * k * P + 4,
                   2 * k * k * P + 4 * k * P, F32_OPS_PER_S)
        out = cm.flat_consensus(eta, master)
        want = ref.flat_consensus(eta, master)
        torch.cuda.synchronize()
        if not torch.allclose(out, want, rtol=RTOL, atol=ATOL):
            fail(f"flat_consensus K={k} disagrees with its plain version: "
                 f"max |diff| {(out - want).abs().max().item():.3e}")
        record("flat_consensus", f"K={k} P={P}",
               (out - want).abs().max().item(),
               lambda: cm.flat_consensus(eta, master),
               lambda: ref.flat_consensus(eta, master),
               lambda: torch.matmul(eta, master),
               4 * k * k + 8 * k * P, 2 * k * k * P, F32_OPS_PER_S)

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
    print("kernels all four agree with their plain versions "
          f"(B1/B2 rtol={RTOL} atol={ATOL}, B3/B4 bit for bit)", flush=True)

    # -- 4. the paper path at K=4, on the card and on the CPU -------------
    loss = simple.make_mlp_loss(MLP_CONFIG)
    train = TrainConfig(learning_rate=1e-3, batch_size=32)
    p0 = simple.mlp_init(torch.Generator().manual_seed(0), MLP_CONFIG,
                         device="cpu")
    totals = {name: 0 for name in read_counts(cm, cs)}

    def drive(fed, rounds, seed, expect):
        idx = torch.randint(0, 320, (rounds, fed.num_nodes, fed.local_steps,
                                     train.batch_size),
                            generator=torch.Generator().manual_seed(seed))
        tr = cdfl.build_trainer(loss, fed, train)
        # one round first, so the timed run does not pay for loading
        # every kernel of the path on its first use
        tr.run_rounds(tr.init(p0, items4), data4, 1, idx=idx[:1])
        reset_counts(cm, cs)
        state = tr.init(p0, items4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, metrics = tr.run_rounds(state, data4, rounds, idx=idx)
        torch.cuda.synchronize()
        round_ms = 1e3 * (time.perf_counter() - t0) / rounds
        counts = read_counts(cm, cs)
        for name, want in expect.items():
            if counts[name] != want:
                fail(f"{fed.algorithm}: {name} launched {counts[name]} "
                     f"times on the path, expected {want}")
        for name, c in counts.items():
            totals[name] += c
        tr_cpu = cdfl.build_trainer(loss, fed, train, device="cpu")
        state_cpu = tr_cpu.init(p0, items4)
        final_cpu, metrics_cpu = tr_cpu.run_rounds(state_cpu, data4, rounds,
                                                   idx=idx)
        if not torch.equal(state.ratios.cpu(), state_cpu.ratios):
            fail(f"{fed.algorithm}: ratios differ between card and CPU")
        diff = (final.buf.cpu() - final_cpu.buf).abs().max().item()
        if not diff <= 1e-4:
            fail(f"{fed.algorithm}: card params differ from the CPU run by "
                 f"{diff:.3e} > 1e-4")
        lossr = metrics["loss"].mean(dim=1).cpu()
        if not torch.isfinite(lossr).all() or not lossr[-1] < lossr[0]:
            fail(f"{fed.algorithm}: loss did not fall: {lossr.tolist()}")
        return state, metrics, counts, diff, round_ms

    fed = FedConfig(num_nodes=4, topology="ring", gamma=0.5, local_steps=10)
    state, metrics, counts, diff, round_ms = drive(
        fed, 10, 1, {"flat_mix": 10, "flat_consensus": 0, "cnd_bitmaps": 1,
                     "cnd_popcount": 1})
    lossr = [round(v, 4) for v in metrics["loss"].mean(dim=1).tolist()]
    dis = [f"{v:.2e}" for v in metrics["disagreement"].tolist()]
    print(f"path cdfl K=4 ratios={[round(v, 4) for v in state.ratios.tolist()]}"
          f" loss/round={lossr} disagreement={dis} launches={counts} "
          f"card-vs-cpu max|param diff|={diff:.3e} card ms/round="
          f"{round_ms:.3f}", flush=True)

    # -- 5. fedavg at K=4 -------------------------------------------------
    fed = FedConfig(num_nodes=4, topology="ring", gamma=0.5, local_steps=10,
                    algorithm="fedavg")
    _, metrics, counts, diff, round_ms = drive(
        fed, 3, 2, {"flat_mix": 0, "flat_consensus": 3, "cnd_bitmaps": 1,
                    "cnd_popcount": 1})
    print(f"path fedavg K=4 loss/round="
          f"{[round(v, 4) for v in metrics['loss'].mean(dim=1).tolist()]} "
          f"launches={counts} card-vs-cpu max|param diff|={diff:.3e} "
          f"card ms/round={round_ms:.3f}", flush=True)

    # -- 6. fleet at K=256, bf16 wire -------------------------------------
    fed = FedConfig(num_nodes=256, topology="ring", gamma=0.5,
                    local_steps=10, wire_dtype="bf16")
    reset_counts(cm, cs)
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
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = tr.run_rounds(state, data_dev, 1, generator=gen_idx)
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    counts = read_counts(cm, cs)
    if counts != {"flat_mix": 7, "flat_consensus": 0, "cnd_bitmaps": 1,
                  "cnd_popcount": 1}:
        fail(f"fleet: unexpected launches {counts}")
    for name, c in counts.items():
        totals[name] += c
    if not torch.isfinite(metrics["loss"]).all():
        fail("fleet: non-finite loss")
    busy, n_dev = {}, 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.name.replace("(anonymous namespace)::", "")
            name = name.replace("void ", "").split("(")[0][:70]
            busy[name] = busy.get(name, 0.0) + \
                ev.time_range.elapsed_us() / 1e3
            n_dev += 1
    busy_ms = sum(busy.values())
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
    b1_ms = sum(v for n, v in busy.items()
                if "mix_kernel<" in n and ", true," in n)
    print(f"path fleet K=256 wire=bf16 ms/round={round_ms:.3f} "
          f"loss={metrics['loss'].mean().item():.4f} launches={counts}",
          flush=True)
    print(f"profile fleet round: wall_ms={prof_ms:.3f} device_busy_ms="
          f"{busy_ms:.3f} busy_share={busy_ms / prof_ms:.4f} "
          f"B1_ms={b1_ms:.4f} B1_share_of_wall={b1_ms / prof_ms:.4f} "
          f"device_events={n_dev} top="
          f"{[(n, round(v, 4)) for n, v in top]}", flush=True)

    # -- 7. kernel table --------------------------------------------------
    sources = {"flat_mix": ("src/repro_torch/csrc/consensus_mix.cu",
                            "src/repro/kernels/consensus_mix.py:77"),
               "flat_consensus": ("src/repro_torch/csrc/consensus_mix.cu",
                                  "src/repro/kernels/consensus_mix.py:109"),
               "cnd_bitmaps": ("src/repro_torch/csrc/cnd_sketch.cu",
                               "src/repro/kernels/cnd_sketch.py:77"),
               "cnd_popcount": ("src/repro_torch/csrc/cnd_sketch.cu",
                                "src/repro/kernels/cnd_sketch.py:102")}
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
                      "library_graph_ms": row["library_graph_ms"]})
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
