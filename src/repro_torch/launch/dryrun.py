"""Multi-pod dry run: run one step of every (architecture x input shape)
on the production meshes without devices and count what this rank would
do — FLOPs, bytes, collectives, shard sizes. Nothing is allocated: the
state, params and batch are meta DTensors placed by the sharding rules,
the world is a fake process group of 256 or 512 ranks (this process is
rank 0), and the step runs once on them. The roofline terms are these
counts priced at the H100's peaks (:mod:`repro_torch.launch.roofline`),
not times.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \
      --shape train_4k [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \
      --out dryrun.json

What each record field counts (the reference's keys; its XLA analyses
have these counterparts):
  bytes_per_device.arguments/outputs  this rank's local shard bytes, exact
  bytes_per_device.temps/total_gb     null: eager torch has no compiled
                                      buffer plan to read a temp size from
  flops          FLOPs of the aten ops on this rank's local tensors
                 (torch.utils.flop_counter's formulas)
  hbm_bytes      bytes those ops read and write, op by op (unfused; an
                 in-place index_copy_, the decode's KV slot, counts the
                 slot, as the card's in-place write moves it)
  collective_*   the functional collectives CommDebugMode saw, bytes as
                 this rank's payload; a permute_tensor (the consensus
                 ring) is named collective-permute, as in the reference
  compile_s      seconds to build the inputs and run the step

The step runs on meta tensors (``kernels.ops.shapes_only``: the kernels'
plain versions), not under ``FakeTensorMode``: DTensor's
strided shards (a reshape that merges two sharded dims) compute their
local sizes with ``tolist()``, which a fake tensor refuses. The counter
tells DTensor's own shape propagation, which runs on fake tensors, from
the rank's work, which runs on meta tensors. It applies
``FlopCounterMode``'s formulas itself: that mode sees a DTensor op at its
global shapes, so it would count every rank's share and the propagation.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import INPUT_SHAPES, FedConfig, TrainConfig
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.core import flatten, topology
from repro_torch.core import transport as transport_lib
from repro_torch.kernels import ops
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import roofline, sharding, steps

# --- per-arch dry-run policy -------------------------------------------------

# federated nodes (paper: 4 base stations). dbrx's optimizer state needs
# dp=8 FSDP shards per node to fit HBM -> 2 nodes on a single pod.
FED_NODES = {"dbrx-132b": 2}
DEFAULT_FED = 4

# long_500k requires sub-quadratic attention. rwkv6 is attention-free;
# mixtral's window is native; every other attention arch runs its
# sliding-window variant (window 4096) for this shape ONLY.
LONG_WINDOW = 4096


def _policy(arch: str, shape_name: str):
    cfg = get_arch(arch)
    fed = FED_NODES.get(arch, DEFAULT_FED)
    window = None
    if shape_name == "long_500k" and cfg.num_heads > 0 \
            and cfg.sliding_window is None:
        window = LONG_WINDOW
    return cfg, fed, window


_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_reduce": "all-reduce",
                "all_reduce_coalesced": "all-reduce",
                "all_to_all_single": "all-to-all",
                "broadcast": "broadcast"}
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "detach", "alias",
               "lift_fresh", "wait_tensor", "_wrap_tensor_autograd"}


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


class _RankCounter(TorchDispatchMode):
    """FLOPs, bytes and collective payloads of the aten ops on this rank's
    local tensors. A DTensor op is handed on (``NotImplemented``), so the
    counter sees the local ops that DTensor issues for it; ops on fake
    tensors are DTensor's shape propagation and are not counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.coll_bytes: dict = {}
        self.permutes = 0
        self.permute_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out
        packet = func._overloadpacket
        name = packet.__name__
        if name in _COLLECTIVES:
            self._collective(name, args)
            return out
        if packet in self._flop_registry:
            self.flops += self._flop_registry[packet](*args, **kwargs,
                                                      out_val=out)
        if name == "index_copy_":
            # in place (the decode's KV slot): reads the index and the
            # source and writes the source's bytes; self is not touched
            # whole
            self.bytes += _tensor_bytes(list(args[2:])) \
                + _tensor_bytes(args[3])
        elif not func.is_view and name not in _NO_TRAFFIC:
            self.bytes += _tensor_bytes(list(args) + list(kwargs.values()))
            self.bytes += _tensor_bytes(out)
        return out

    def _collective(self, name: str, args) -> None:
        payload = args[0].numel() * args[0].element_size() \
            if isinstance(args[0], torch.Tensor) else _tensor_bytes(args[0])
        if name == "all_to_all_single":
            splits = [s for s in args[2] if s] if len(args) > 2 else []
            if len(splits) == 1:          # permute_tensor: one destination
                self.permutes += 1
                self.permute_bytes += payload
                return
        op = _COLLECTIVES[name]
        self.coll_bytes[op] = self.coll_bytes.get(op, 0) + payload


def _collective_stats(comm, counter) -> roofline.CollectiveStats:
    """CommDebugMode's counts by the reference's op names, its
    single-destination all-to-alls (permute_tensor) as
    collective-permute; bytes from the counter."""
    counts: dict = {}
    for packet, n in comm.get_comm_counts().items():
        name = _COLLECTIVES.get(packet.__name__, packet.__name__)
        counts[name] = counts.get(name, 0) + n
    if counter.permutes:
        counts["all-to-all"] -= counter.permutes
        if not counts["all-to-all"]:
            del counts["all-to-all"]
        counts["collective-permute"] = counter.permutes
    nbytes = dict(counter.coll_bytes)
    if counter.permutes:
        nbytes["collective-permute"] = counter.permute_bytes
    return roofline.CollectiveStats(bytes_by_op=nbytes, count_by_op=counts)


def _start_fake_world(size: int) -> None:
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group; "
                           "one is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               verbose: bool = True, return_artifacts: bool = False,
               fed_override: int | None = None,
               train_cfg: TrainConfig | None = None,
               transport: str = "dense", wire_dtype: str = "f32") -> dict:
    """One (arch x shape) on the single-pod (256 ranks) or two-pod (512)
    mesh; the record's fields are described in the module's note. The
    fake process group is destroyed on the way out, whatever happened."""
    from torch.distributed.tensor.debug import CommDebugMode
    shape = INPUT_SHAPES[shape_name]
    cfg, fed_nodes, window = _policy(arch, shape_name)
    if fed_override:
        fed_nodes = fed_override
    train = train_cfg or TrainConfig(remat="full")
    _start_fake_world(512 if multi_pod else 256)
    try:
        pmesh = meshlib.make_production_mesh(multi_pod=multi_pod,
                                             device="cpu")
        t0 = time.time()
        fed_layout = None
        if shape.mode == "train":
            fmesh = meshlib.make_fed_mesh(pmesh, fed_nodes)
            fed_cfg = FedConfig(num_nodes=fed_nodes, transport=transport,
                                wire_dtype=wire_dtype)
            state = steps.fed_state_struct(cfg, fed_nodes, train)
            # static pack layout of ONE node's params (leading F stripped):
            # prices the transport's per-link consensus payload below
            fed_layout = flatten.make_layout(state.params)
            # FSDP (ZeRO-3 over dp) only when a replica + optimizer state
            # is too big to replicate within the node's dp group
            use_fsdp = cfg.param_count() * 10 / meshlib.tp_size(fmesh) > 4e9
            shardings = sharding.fed_state_shardings(state, fmesh,
                                                     fsdp=use_fsdp)
            state = sharding.place(state, shardings)
            batch = steps.input_specs(cfg, shape, fed_nodes)
            batch = sharding.with_sharding(batch, fmesh,
                                           sharding.fed_batch_spec)
            step = steps.make_fed_train_step(cfg, fed_cfg, train)
            args = (state, batch)
            mesh_used = fmesh
        else:
            params = steps.serve_params_struct(cfg)
            sizes = meshlib.axis_sizes(pmesh)
            serve_fsdp = cfg.param_count() * 2 / sizes["model"] > 8e9
            shardings = sharding.serve_state_shardings(params, pmesh,
                                                       fsdp=serve_fsdp)
            params = sharding.place(params, shardings)
            if shape.mode == "prefill":
                batch = steps.input_specs(cfg, shape)
                batch = sharding.with_sharding(batch, pmesh,
                                               sharding.serve_batch_spec)
                step = steps.make_prefill_step(cfg, window_override=window,
                                               multi_pod=multi_pod)
                args = (params, batch)
            else:
                dstate = steps.decode_state_struct(cfg, shape,
                                                   window_override=window)
                dstate = sharding.with_sharding(dstate, pmesh,
                                                sharding.cache_spec)
                tokens = steps.input_specs(cfg, shape)["tokens"]
                tokens = sharding.with_sharding(
                    {"t": tokens}, pmesh, sharding.serve_batch_spec)["t"]
                step = steps.make_serve_step(cfg, window_override=window,
                                             multi_pod=multi_pod)
                args = (params, dstate, tokens)
            mesh_used = pmesh
        arg_bytes = _local_bytes(args)
        counter = _RankCounter()
        with CommDebugMode() as comm, counter, ops.shapes_only():
            out = step(*args)
        out_bytes = _local_bytes(out)
        compile_s = time.time() - t0
        colls = _collective_stats(comm, counter)
        n_dev = mesh_used.size()
        mf = roofline.model_flops_per_device(cfg, shape, n_dev, fed_nodes)
        rl = roofline.Roofline(flops=float(counter.flops),
                               hbm_bytes=float(counter.bytes),
                               wire_bytes=colls.wire_bytes,
                               collectives=colls, model_flops=mf)
        consensus_bytes = 0.0
        if fed_layout is not None:
            # the collective term reads the SELECTED transport's wire bytes
            # (bf16 / ring variants), not the f32 payload the step moved
            tr_obj = transport_lib.make_transport(fed_cfg)
            adj = topology.adjacency(fed_cfg.topology, fed_nodes)
            rl = rl.with_consensus(tr_obj, fed_layout, adj,
                                   devices_per_node=n_dev // fed_nodes)
            consensus_bytes = roofline.transport_consensus_bytes(
                tr_obj, fed_layout, adj)
    finally:
        dist.destroy_process_group()
    rec = {
        "arch": arch, "shape": shape_name,
        "multi_pod": multi_pod, "devices": n_dev,
        "fed_nodes": fed_nodes if shape.mode == "train" else 0,
        "transport": transport if shape.mode == "train" else None,
        "wire_dtype": wire_dtype if shape.mode == "train" else None,
        "consensus_wire_bytes_per_node": consensus_bytes,
        "window_override": window,
        "compile_s": round(compile_s, 1),
        "bytes_per_device": {
            "arguments": arg_bytes,
            "outputs": out_bytes,
            "temps": None,
            "total_gb": None,
        },
        "collective_counts": colls.count_by_op,
        "collective_bytes": colls.bytes_by_op,
        **rl.row(),
    }
    if verbose:
        print(f"== {arch} x {shape_name} "
              f"({'multi-pod 512' if multi_pod else 'single-pod 256'}) ==")
        print(f"  local shards: args={arg_bytes/1e9:.2f}GB "
              f"outputs={out_bytes/1e9:.2f}GB per device")
        print(f"  counted: flops/dev={rl.flops/1e9:.1f}G "
              f"bytes/dev={rl.hbm_bytes/1e9:.2f}GB")
        print(f"  collectives: {colls.count_by_op} "
              f"wire={colls.wire_bytes/1e9:.3f}GB")
        print(f"  roofline: compute={rl.t_compute:.3e}s "
              f"memory={rl.t_memory:.3e}s collective={rl.t_collective:.3e}s "
              f"-> {rl.bottleneck}-bound; useful={rl.useful_ratio:.2f} "
              f"(run {compile_s:.1f}s)")
    if return_artifacts:
        rec["_artifacts"] = {"output": out, "counter": counter,
                             "comm": comm}
    return rec


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of a tree of DTensors (and tensors)."""
    return _tensor_bytes([getattr(t, "_local_tensor", t)
                          for t in _tensors(tree)])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) on the chosen mesh")
    ap.add_argument("--out", default=None, help="JSON output path")
    from repro_torch.registry import transports, wire_codecs
    ap.add_argument("--transport", choices=transports.names(),
                    default="dense",
                    help="consensus transport backend priced into the "
                         "collective roofline term (train shapes)")
    ap.add_argument("--wire-dtype", choices=wire_codecs.names(),
                    default="f32",
                    help="exchanged-buffer wire codec for the "
                         "collective term (bf16 halves consensus bytes)")
    args = ap.parse_args(argv)

    if args.all:
        combos = [(a, s) for a in ARCHS for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        combos = [(args.arch, args.shape)]

    records, failures = [], []
    for arch, shape in combos:
        try:
            records.append(dryrun_one(arch, shape,
                                      multi_pod=args.multi_pod,
                                      transport=args.transport,
                                      wire_dtype=args.wire_dtype))
        except Exception as e:  # noqa: BLE001 — report, keep sweeping
            traceback.print_exc()
            failures.append({"arch": arch, "shape": shape,
                             "error": f"{type(e).__name__}: {_op(e)}"})
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"records": records, "failures": failures}, f,
                      indent=1)
    print(f"\n{len(records)} ok, {len(failures)} failed")
    if failures:
        for f_ in failures:
            print("  FAIL", f_["arch"], f_["shape"], f_["error"])
        raise SystemExit(1)


def _op(e: Exception) -> str:
    """The message of a failure, led by the aten op DTensor could not
    place when that is what failed, else followed by the port's line
    that raised it."""
    text = str(e).strip()
    first = text.splitlines()[0] if text else repr(e)
    for line in text.splitlines():
        if "Sharding propagation failed for" in line:
            op = line.split("for", 1)[1].strip().split("(", 1)[0]
            return f"{op}: {first}"
    frames = [f for f in traceback.extract_tb(e.__traceback__)
              if "repro_torch" in f.filename]
    if frames:
        where = frames[-1]
        path = where.filename.split("repro_torch/", 1)[-1]
        return f"{first} at {path}:{where.lineno} ({where.line})"
    return first


if __name__ == "__main__":
    main()
