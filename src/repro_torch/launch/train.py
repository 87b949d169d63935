"""End-to-end federated training driver (one card, or the CPU on request).

Runs the C-DFL round loop (consensus + local Adam) for a selected
architecture at a REDUCED size on synthetic token-LM data — the twin of
the JAX package's ``repro.launch.train``, through the port's
``Experiment`` and ``Session``.

The CLI builds ONE ``RunConfig``; ``Experiment(config).compile(...)``
derives the token-LM loss and init from it, and every plugin-name flag's
choices come from :mod:`repro_torch.registry`: ``--transport
dense|ring|gossip`` (with ``--staleness`` for gossip), ``--redundancy`` a
float (host-side duplicates) or a redundancy scenario, whose streaming
sketches then drive the weights (``--ingest-weighting``, ``--ingest-seed``)
and print an ``INGEST_SMOKE`` verdict.

Two drivers:
  * ``--driver scan`` (default) — ``Session.run``: the datasets live on
    the device, each round's batch indices are drawn from a generator
    keyed on (seed, round), and the rounds run in one ``run_rounds`` call.
    Metrics are printed after the run from the stacked per-round tensors.
  * ``--driver loop`` — one ``Trainer.round`` per round on host-built
    ``lm_batches``; kept for debugging and as the baseline.

``--sweep seeds=2,lr=1e-3:3e-3`` runs the variant cross product through
``Experiment.compile_batch`` (V runs in the launches of one) and prints the
reference's per-variant table and ``SWEEP_SMOKE`` verdict.

On the card, each training forward launches kernel B9 (attention) or B10
(the rwkv wkv scan); the backward differentiates their plain versions, as
the JAX package has no backward kernel either.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --rounds 20 --nodes 4 [--algorithm cdfl] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import registry
from repro_torch.checkpointing import save
from repro_torch.configs.base import (FaultConfig, FedConfig, HierarchyConfig,
                                      IngestConfig, MobilityConfig,
                                      RunConfig, TrainConfig)
from repro_torch.configs.registry import ARCHS, get_smoke_arch
from repro_torch.data import pipeline, redundancy, synthetic
from repro_torch.experiment import (ChurnLogCallback, DegreeStatsCallback,
                                    Experiment, HealthCallback,
                                    IngestCallback, SweepAxes)
from repro_torch.mobility.links import LINK_QUALITIES


def _print_round(r, loss, disagree, dt):
    print(f"round {r:3d} loss/node={np.round(loss, 3)} "
          f"mean={loss.mean():.4f} disagree={disagree:.2e} ({dt:.1f}s)")


_SWEEP_AXES = ("seeds", "lr", "gamma", "mobility")


def _parse_sweep(spec: str) -> dict:
    """``--sweep`` axis spec -> {axis: values}, validated here so a bad
    spec fails at argparse time, not after data/model setup.

    Grammar: comma-separated ``axis=value[:value...]`` — e.g.
    ``seeds=8`` (counts as seeds 0..7), ``seeds=3:7:11`` (explicit),
    ``lr=1e-3:3e-3``, ``gamma=0.5:0.8``,
    ``mobility=static:platoon:manhattan``.
    """
    from repro_torch import registry as _registry
    _registry.ensure_plugins()
    axes: dict = {}
    for part in spec.split(","):
        name, eq, vals = part.partition("=")
        name = name.strip()
        if not eq or not vals:
            raise argparse.ArgumentTypeError(
                f"bad sweep axis {part!r}: expected axis=v1[:v2...] "
                f"(axes: {', '.join(_SWEEP_AXES)})")
        if name not in _SWEEP_AXES:
            raise argparse.ArgumentTypeError(
                f"unknown sweep axis {name!r} (axes: "
                f"{', '.join(_SWEEP_AXES)})")
        if name in axes:
            raise argparse.ArgumentTypeError(
                f"duplicate sweep axis {name!r}")
        items = vals.split(":")
        try:
            if name == "seeds":
                axes[name] = (int(items[0]) if len(items) == 1
                              else [int(v) for v in items])
            elif name == "mobility":
                known = ("static",) + _registry.mobility_traces.names()
                for m in items:
                    if m not in known:
                        raise argparse.ArgumentTypeError(
                            f"unknown mobility scenario {m!r} in --sweep "
                            f"(choices: {', '.join(known)})")
                axes[name] = items
            else:
                axes[name] = [float(v) for v in items]
        except ValueError as e:
            raise argparse.ArgumentTypeError(
                f"bad value in sweep axis {part!r}: {e}") from None
    return axes


def main(argv=None):
    """Parse ``argv`` (default: the command line), train, print the
    reference's lines; returns the final :class:`FedState` and the
    ``(rounds, nodes)`` losses."""
    registry.ensure_plugins()
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen3-1.7b")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--algorithm", default="cdfl",
                    choices=registry.algorithms.names())
    ap.add_argument("--redundancy", default="0.5",
                    help="a float: fraction of duplicated items injected "
                         "host-side per node (legacy CND path); or a "
                         "registered redundancy scenario name "
                         f"({','.join(registry.redundancy_scenarios.names())})"
                         " — streaming sketches then estimate redundancy "
                         "on the ingest path and drive the weights "
                         "(needs --driver scan)")
    ap.add_argument("--ingest-weighting", default="both",
                    choices=("none", "mixing", "sampling", "both"),
                    help="what the streaming-sketch estimates drive when "
                         "--redundancy names a scenario: redundancy-aware "
                         "mixing weights, duplicate-corrected sampling, "
                         "both, or telemetry only")
    ap.add_argument("--ingest-seed", type=int, default=0,
                    help="redundancy-scenario RNG seed (deterministic)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--driver", choices=("scan", "loop"), default="scan",
                    help="scan: the rounds in one Session.run; "
                         "loop: one Trainer.round a round on host batches")
    ap.add_argument("--transport", choices=registry.transports.names(),
                    default="dense",
                    help="how the consensus exchange moves the flat "
                         "buffer (registered transport plugins)")
    ap.add_argument("--wire-dtype", choices=registry.wire_codecs.names(),
                    default="f32",
                    help="exchanged-buffer wire codec; bf16 halves "
                         "consensus bytes (f32 master copy is kept)")
    ap.add_argument("--staleness", type=int, default=0,
                    help="gossip bounded delay in rounds (0 = synchronous)")
    ap.add_argument("--mixing-format",
                    choices=("dense", "sparse", "hierarchical"),
                    default="dense",
                    help="mixing-weight representation: dense (K,K) eta "
                         "matrices, sparse top-D neighbor idx/val "
                         "pairs — O(K*D*P) gather-mix instead of the "
                         "O(K^2*P) matmul (city-scale fleets) — or "
                         "hierarchical two-tier cluster consensus "
                         "(repro_torch.hierarchy)")
    ap.add_argument("--degree", type=int, default=None,
                    help="top-D neighbor cap per node with "
                         "--mixing-format sparse (1 <= D <= K-1; "
                         "default min(8, nodes-1))")
    ap.add_argument("--hierarchy", action="store_true",
                    help="shorthand for --mixing-format hierarchical: "
                         "mobility clusters mix densely at their own "
                         "stability bound, elected leaders run a sparse "
                         "inter-cluster tier")
    ap.add_argument("--leader-policy", default="degree",
                    choices=registry.leader_policies.names(),
                    help="hierarchical leader election criterion")
    ap.add_argument("--max-cluster-size", type=int, default=16,
                    help="proximity-split cap on hierarchical cluster "
                         "membership (>= 2)")
    ap.add_argument("--simulate-wire", action="store_true",
                    help="force the wire-dtype cast roundtrip (the port "
                         "always casts the wire; accepted for the "
                         "reference's command lines)")
    ap.add_argument("--mobility",
                    choices=("static",) + registry.mobility_traces.names(),
                    default="static",
                    help="vehicular mobility scenario: per-round radio-"
                         "range topologies drive the consensus exchange "
                         "(static = the frozen --topology graph)")
    ap.add_argument("--range", type=float, default=250.0, dest="radio_range",
                    help="V2V radio range in meters (mobility scenarios)")
    ap.add_argument("--speed", type=float, default=20.0,
                    help="mean vehicle speed in m/s (mobility scenarios)")
    ap.add_argument("--speed-jitter", type=float, default=0.3,
                    help="fractional per-vehicle speed spread (platoon "
                         "split rate)")
    ap.add_argument("--mobility-seed", type=int, default=0,
                    help="trace RNG seed (deterministic per seed)")
    ap.add_argument("--link-quality", choices=LINK_QUALITIES,
                    default="binary",
                    help="link weighting: binary unit-disk or quadratic "
                         "distance-faded quality")
    ap.add_argument("--faults", default=None,
                    help="comma-separated fault kinds to inject "
                         f"({','.join(registry.fault_models.names())}); "
                         "compiled into per-round schedules riding the "
                         "run — needs --driver scan")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="fault-schedule RNG seed (deterministic per seed)")
    ap.add_argument("--drop-rate", type=float, default=0.1,
                    help="per-round symmetric link-erasure probability")
    ap.add_argument("--crash-rate", type=float, default=0.1,
                    help="per-round node crash probability (Markov)")
    ap.add_argument("--recover-rate", type=float, default=0.3,
                    help="per-round crashed-node recovery probability")
    ap.add_argument("--corrupt-rate", type=float, default=0.05,
                    help="per-round wire-payload corruption probability")
    ap.add_argument("--corrupt-mode", default="nan",
                    choices=("nan", "inf", "bitflip"))
    ap.add_argument("--straggle-rate", type=float, default=0.1,
                    help="per-round stale-buffer replay probability")
    ap.add_argument("--byzantine", default=None,
                    help="comma-separated adversarial node indices "
                         "(with --faults byzantine)")
    ap.add_argument("--byzantine-mode", default="sign_flip",
                    choices=("sign_flip", "scale"))
    ap.add_argument("--robust", default=None,
                    choices=registry.robust_rules.names(),
                    help="Byzantine-robust consensus rule replacing the "
                         "eq. 5 weighted mix (dense transport only)")
    ap.add_argument("--trim", type=int, default=1,
                    help="per-side trim count for --robust trimmed_mean")
    ap.add_argument("--sweep", type=_parse_sweep, default=None,
                    metavar="AXES",
                    help="batched fleet sweep: run the cross product of "
                         "axis=v1[:v2...] variants (axes: seeds, lr, "
                         "gamma, mobility) through one batched run via "
                         "BatchedSession.run_batch — e.g. "
                         "--sweep seeds=8,lr=1e-3:3e-3 — and print a "
                         "per-variant results table (needs --driver "
                         "scan; incompatible with --checkpoint: batched "
                         "runs don't checkpoint)")
    ap.add_argument("--quick", action="store_true",
                    help="tiny model + corpus for CI smoke runs")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    if args.sweep is not None:
        if args.driver != "scan":
            ap.error("--sweep needs --driver scan (the batched runs "
                     "share one vmapped scan)")
        if args.checkpoint:
            ap.error("--sweep cannot --checkpoint (batched sessions are "
                     "one-shot; re-run the winning variant to save it)")
        if args.mixing_format == "hierarchical" or args.hierarchy:
            ap.error("--sweep does not support the hierarchical mixing "
                     "format yet (ROADMAP follow-on)")

    # --redundancy is overloaded: a float keeps the legacy host-side
    # duplicate injection (static CND ratios), a scenario name activates
    # the streaming-redundancy ingest (repro_torch.ingest)
    ingest = None
    try:
        dup_fraction = float(args.redundancy)
    except ValueError:
        if args.driver != "scan":
            ap.error("--redundancy <scenario> needs --driver scan (the "
                     "streaming sketches ride the multi-round scan)")
        dup_fraction = 0.0
        ingest = IngestConfig(scenario=args.redundancy,
                              weighting=args.ingest_weighting,
                              seed=args.ingest_seed)

    faults = None
    if args.faults:
        if args.driver != "scan":
            ap.error("--faults needs --driver scan (fault schedules ride "
                     "the multi-round scan)")
        byz = (tuple(int(b) for b in args.byzantine.split(","))
               if args.byzantine else
               ((1,) if "byzantine" in args.faults else ()))
        faults = FaultConfig(
            kinds=tuple(k for k in args.faults.split(",") if k),
            seed=args.fault_seed, drop_rate=args.drop_rate,
            crash_rate=args.crash_rate, recover_rate=args.recover_rate,
            corrupt_rate=args.corrupt_rate, corrupt_mode=args.corrupt_mode,
            straggle_rate=args.straggle_rate, byzantine=byz,
            byzantine_mode=args.byzantine_mode)

    # --hierarchy is shorthand for --mixing-format hierarchical; either
    # spelling builds the two-tier HierarchyConfig from the CLI knobs
    if args.hierarchy:
        args.mixing_format = "hierarchical"
    hierarchy = None
    if args.mixing_format == "hierarchical":
        hierarchy = HierarchyConfig(max_cluster_size=args.max_cluster_size,
                                    leader_policy=args.leader_policy)

    mobility = None
    if args.mobility != "static":
        if args.driver != "scan":
            ap.error("--mobility needs --driver scan (time-varying "
                     "topologies ride the multi-round scan)")
        mobility = MobilityConfig(
            kind=args.mobility, radio_range=args.radio_range,
            speed=args.speed, speed_jitter=args.speed_jitter,
            seed=args.mobility_seed, link_quality=args.link_quality)

    cfg = get_smoke_arch(args.arch)
    n_seqs = 256
    if args.quick:
        n_seqs, args.batch = 64, min(args.batch, 4)
        args.seq = min(args.seq, 32)

    run_cfg = RunConfig(
        model=cfg,
        fed=FedConfig(num_nodes=args.nodes, local_steps=args.local_steps,
                      algorithm=args.algorithm, transport=args.transport,
                      wire_dtype=args.wire_dtype, staleness=args.staleness,
                      simulate_wire=args.simulate_wire, mobility=mobility,
                      faults=faults, robust=args.robust, trim=args.trim,
                      mixing_format=args.mixing_format,
                      hierarchy=hierarchy,
                      degree=(min(8, args.nodes - 1)
                              if args.degree is None else args.degree),
                      ingest=ingest),
        train=TrainConfig(learning_rate=args.lr, batch_size=args.batch))

    # per-node synthetic corpora. A float --redundancy injects the
    # duplicates host-side (the paper's redundant-data condition — CND
    # sees static distinct ratios < 1); a scenario --redundancy leaves the
    # corpora clean and lets the ingest plan rewrite the streams at run
    # time (the streaming sketches estimate the redundancy).
    nodes = [
        redundancy.inject_duplicates(
            synthetic.token_lm(seed=i, n_seqs=n_seqs, seq_len=args.seq,
                               vocab=cfg.vocab_size),
            1.0 - dup_fraction, seed=i)
        for i in range(args.nodes)
    ]

    # token/label views of the resident per-node corpora: (K, N, T)
    seqs = np.stack([d.x for d in nodes])
    data = {"tokens": seqs[..., :-1], "labels": seqs[..., 1:]}
    batcher_items = pipeline.FederatedBatcher(nodes, args.batch,
                                              args.local_steps)

    if args.sweep is not None:
        result = _run_sweep(args, run_cfg, data, batcher_items.node_items())
        return result.state, result.metrics["loss"].cpu().numpy()

    # the Experiment derives the token-LM loss/init from RunConfig.model
    session = Experiment(run_cfg, device=args.device).compile(
        data, batcher_items.node_items())
    state = session.state
    print(f"arch={cfg.name} nodes={args.nodes} alg={args.algorithm} "
          f"driver={args.driver} transport={args.transport}"
          f"/{args.wire_dtype}"
          f"{f'/stale{args.staleness}' if args.staleness else ''} "
          f"CND ratios={np.round(state.ratios.cpu().numpy(), 3)}")

    if args.driver == "scan":
        result = session.run(args.rounds, callbacks=[ChurnLogCallback(),
                                                     DegreeStatsCallback(),
                                                     HealthCallback(),
                                                     IngestCallback()])
        metrics = {name: np.asarray(v.cpu()) if hasattr(v, "cpu")
                   else np.asarray(v) for name, v in result.metrics.items()}
        losses = metrics["loss"]
        disagrees = metrics["disagreement"]
        per_round = result.wall_time_s / max(args.rounds, 1)
        for r in range(args.rounds):
            _print_round(r, losses[r], float(disagrees[r]), per_round)
        print(f"total {result.wall_time_s:.1f}s "
              f"({per_round * 1e3:.1f} ms/round, one Session.run)")
        if faults is not None and "health" in metrics:
            # greppable CI smoke verdict: training made progress THROUGH
            # the injected faults, and the schedule actually fired
            crashed = int((1.0 - metrics["health"]).sum())
            quarantined = int(metrics["quarantined"].sum())
            frozen = int(metrics["frozen"].sum())
            # byzantine/straggle/link_drop leave no health-telemetry
            # trace (their effect is on the mix, not node health), so
            # only demand a fired event for kinds that produce one
            eventful = bool({"crash", "corrupt"} & set(faults.kinds))
            ok = (np.isfinite(losses).all()
                  and losses[-1].mean() < losses[0].mean()
                  and (not eventful
                       or crashed + quarantined + frozen >= 1))
            print(f"FAULT_SMOKE {'ok' if ok else 'FAIL'} "
                  f"crashed_node_rounds={crashed} "
                  f"quarantined={quarantined}")
        if ingest is not None and "est_distinct" in metrics:
            # greppable CI smoke verdict: training made progress on the
            # redundant streams, the sketches produced finite positive
            # estimates, and (duplicate_heavy) the affected nodes are
            # actually measured as redundancy-heavy (fleet spread)
            est = metrics["est_distinct"][-1]
            spread = float(est.max() / max(float(est.min()), 1e-9))
            ok = (np.isfinite(losses).all()
                  and losses[-1].mean() < losses[0].mean()
                  and np.isfinite(est).all() and est.min() > 0
                  and (ingest.scenario != "duplicate_heavy"
                       or spread > 1.2))
            print(f"INGEST_SMOKE {'ok' if ok else 'FAIL'} "
                  f"scenario={ingest.scenario} "
                  f"est_distinct={np.round(est, 1)} "
                  f"spread={spread:.2f}")
        if hierarchy is not None and "gamma_intra" in metrics:
            # greppable CI smoke verdict: the two-tier mix trained (finite,
            # improving loss), the fleet actually partitioned into >= 1
            # cluster per round, and the intra-tier step sizes are finite
            # and positive (the per-cluster gamma path was exercised)
            g_intra = metrics["gamma_intra"]
            clusters = metrics["clusters"]
            ok = (np.isfinite(losses).all()
                  and losses[-1].mean() < losses[0].mean()
                  and np.isfinite(g_intra).all() and g_intra.min() > 0
                  and clusters.min() >= 1)
            print(f"HIER_SMOKE {'ok' if ok else 'FAIL'} "
                  f"policy={hierarchy.leader_policy} "
                  f"clusters={np.round(clusters).astype(int).tolist()} "
                  f"gamma_intra={np.round(g_intra, 3).tolist()}")
        state = result.state
    else:
        trainer = session.experiment.trainer(session.data)
        losses = []
        for r in range(args.rounds):
            t0 = time.time()
            batch = pipeline.lm_batches(nodes, args.batch, args.local_steps,
                                        seed=1000 + r)
            state, metrics = trainer.round(state, batch)
            losses.append(metrics["loss"].cpu().numpy())
            _print_round(r, losses[-1], float(metrics["disagreement"]),
                         time.time() - t0)
        losses = np.stack(losses)

    if args.checkpoint:
        save(args.checkpoint, state.params, step=args.rounds)
        print("saved params to", args.checkpoint)
    return state, losses


def _run_sweep(args, run_cfg, data, node_items):
    """``--sweep``: the variant cross product through
    ``Experiment.compile_batch`` — V runs in the launches of one — plus the
    per-variant results table and the greppable SWEEP_SMOKE verdict.
    Returns the :class:`BatchResult`."""
    spec = args.sweep
    mob_axis = None
    if "mobility" in spec:
        mob_axis = [None if m == "static" else MobilityConfig(
            kind=m, radio_range=args.radio_range, speed=args.speed,
            speed_jitter=args.speed_jitter, seed=args.mobility_seed,
            link_quality=args.link_quality) for m in spec["mobility"]]
    axes = SweepAxes(seeds=spec.get("seeds"), lr=spec.get("lr"),
                     gamma=spec.get("gamma"), mobility=mob_axis)
    batched = Experiment(run_cfg, device=args.device).compile_batch(
        data, node_items, axes)
    v = batched.num_variants
    print(f"sweep: {v} variants x {args.rounds} rounds "
          f"(axes: {', '.join(sorted(spec))}) — one batched run")
    result = batched.run_batch(args.rounds)
    losses = result.metrics["loss"].cpu().numpy()        # (V, R, K)
    first = losses[:, 0].mean(axis=-1)
    final = losses[:, -1].mean(axis=-1)
    dis = result.metrics["disagreement"].cpu().numpy()[:, -1]
    print(f"{'variant':>7} {'seed':>5} {'lr':>9} {'gamma':>6} "
          f"{'mobility':>10} {'loss_r0':>8} {'loss_rN':>8} "
          f"{'disagree':>9}")
    for i, var in enumerate(result.variants):
        mob = var["mobility"]
        seed_s = "-" if var["seed"] is None else str(var["seed"])
        lr_s = "-" if var["lr"] is None else f"{var['lr']:.1e}"
        g_s = "-" if var["gamma"] is None else f"{var['gamma']:.2f}"
        mob_s = ("-" if "mobility" not in spec
                 else (mob.kind if mob is not None else "static"))
        print(f"{i:>7d} {seed_s:>5} {lr_s:>9} {g_s:>6} {mob_s:>10} "
              f"{first[i]:>8.4f} {final[i]:>8.4f} {dis[i]:>9.2e}")
    per_round = result.wall_time_s / max(args.rounds, 1)
    print(f"total {result.wall_time_s:.1f}s for {v} runs "
          f"({per_round * 1e3:.1f} ms/round for the whole fleet batch)")
    improved = int((final < first).sum())
    ok = (np.isfinite(losses).all() and v == len(result.variants)
          and improved == v)
    print(f"SWEEP_SMOKE {'ok' if ok else 'FAIL'} variants={v} "
          f"improved={improved}/{v} "
          f"loss_rN_mean={float(final.mean()):.4f}")
    return result


if __name__ == "__main__":
    main()
