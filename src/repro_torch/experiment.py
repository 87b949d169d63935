"""Declarative experiment/session API — the user-facing façade over the
C-DFL trainer (the twin of the JAX package's ``repro.experiment``).

An experiment is declared once and compiled into a resumable session::

    exp = Experiment.from_parts(loss_fn, init_params,
                                fed=FedConfig(num_nodes=4, local_steps=10),
                                train=TrainConfig(learning_rate=1e-3))
    session = exp.compile(data, node_items)
    result = session.run(60, callbacks=[EvalCallback(eval_fn),
                                        CheckpointCallback("ckpt", every=20)])
    result.metrics["loss"]          # (R, K) stacked per-round metrics
    result.final_params             # node-stacked parameter views

    session2 = exp.compile(data, node_items).resume("ckpt")
    session2.run(40)                # rounds 60..99 of the SAME run

Every plugin name in the configs resolves through
:mod:`repro_torch.registry`. The port's conventions hold here too:
``loss_fn(params, batch) -> (K,)`` and ``eval_fn(params) -> (K,)`` take
node-stacked parameter views and batches whose leaves are ``(K, B, ...)``
(see :func:`repro_torch.core.cdfl.build_trainer`); ``init_params`` takes a
``torch.Generator``, and ``rng`` / ``sample_rng`` are a
``torch.Generator`` or an int seed. Everything runs on the card unless the
experiment is given ``device="cpu"``.

``Experiment(RunConfig(model=ModelConfig))`` derives the token-LM pair
from the config, as the JAX package does: the next-token loss of
:func:`repro_torch.models.transformer.loss_fn` over batches ``{"tokens",
"labels"}`` of ``(K, B, T)``, and :func:`transformer.init_params` drawn
from the generator on its own device (a generator on the card draws a
full-width model there).

* **Segmentation invariance.** ``Session.run`` draws the ``(R, K, S, B)``
  batch indices itself (under duplicate-corrected ingest sampling, the
  uniforms the sketches map to indices), round r's from a generator keyed
  on (sample seed, absolute round r); mobility stacks and fault plans are
  keyed on the absolute round as well, and gossip snapshots and ingest
  sketches ride the state. So run(10) + save + resume + run(10)
  reproduces run(20) bit for bit, with no generator state in the
  checkpoint.
* **Callbacks.** Per-round eval is a trainer metric (:class:`EvalCallback`);
  host-side hooks (:class:`CheckpointCallback`, :class:`ChurnLogCallback`)
  fire at segment boundaries, and the metrics of the segments are
  concatenated along the rounds axis.
* **Batched sweeps.** ``compile_batch(data, node_items, SweepAxes(...))``
  builds a :class:`BatchedSession`: the V variants of the axes' cross
  product (seeds, learning rates, step-size caps, mobility scenarios) run
  through ``Trainer.run_rounds_batch``, V runs in the launches of one.
  Variant v equals a plain :class:`Session` compiled with its seed and
  configs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import registry
from repro_torch.checkpointing import restore as _ckpt_restore
from repro_torch.checkpointing import save as _ckpt_save
from repro_torch.configs.base import FedConfig, RunConfig, TrainConfig
from repro_torch.core import flatten
from repro_torch.core.cdfl import (FedState, Trainer, build_trainer,
                                   select_state, stack_states)
from repro_torch.device import resolve_device

__all__ = [
    "Experiment", "Session", "RunResult",
    "SweepAxes", "BatchedSession", "BatchResult",
    "Callback", "EvalCallback", "CheckpointCallback", "ChurnLogCallback",
    "DegreeStatsCallback", "HealthCallback", "IngestCallback",
]


# --------------------------------------------------------------------------
# Callbacks.
# --------------------------------------------------------------------------

class Callback:
    """Per-round hook riding a :meth:`Session.run`.

    ``every=N`` makes the run segment its rounds at every N rounds and call
    :meth:`on_rounds` there (host-side work: checkpoints, logs);
    ``every=None`` keeps the whole run in one ``run_rounds`` call.
    Per-round metrics (eval) are declared via :attr:`eval_fn` instead."""

    every: Optional[int] = None
    eval_fn: Optional[Callable] = None   # params -> (K,) metric

    def on_run_start(self, session: "Session", rounds: int) -> None:
        pass

    def on_rounds(self, session: "Session", end_round: int) -> None:
        """Called after the segment ending at ``end_round`` (an absolute
        round index, multiples of ``every``)."""

    def on_run_end(self, session: "Session", result: "RunResult") -> None:
        pass


class EvalCallback(Callback):
    """Per-round evaluation as a trainer metric: the stacked ``(R, K)``
    values appear under ``result.metrics[name]``. ``eval_fn(params) ->
    (K,)`` takes node-stacked parameter views."""

    def __init__(self, eval_fn: Callable, name: str = "eval"):
        self.eval_fn = eval_fn
        self.name = name

    def on_run_end(self, session: "Session", result: "RunResult") -> None:
        # the trainer stacks the metric under its internal "eval" key;
        # honor the caller's name
        if self.name != "eval" and "eval" in result.metrics:
            result.metrics[self.name] = result.metrics.pop("eval")


class CheckpointCallback(Callback):
    """Save the session state every ``every`` rounds (and at run end) to
    ``path`` — the artifact :meth:`Session.resume` restarts from."""

    def __init__(self, path: str, every: Optional[int] = None):
        self.path = path
        self.every = every

    def on_rounds(self, session: "Session", end_round: int) -> None:
        session.save(self.path)

    def on_run_end(self, session: "Session", result: "RunResult") -> None:
        session.save(self.path)


def _adjacency(session: "Session", rounds: int):
    """The (R, K, K) radio links of the rounds a run covers, as the run
    uses them (the ring transport gates them to the physical ring), or
    None on a static topology."""
    fed = session.experiment.fed
    mob = fed.mobility
    if mob is None or mob.kind == "static":
        return None
    from repro_torch import mobility as mobility_lib
    from repro_torch.core import topology
    mask = (topology.adjacency("ring", fed.num_nodes)
            if fed.transport == "ring" else None)
    return mobility_lib.adjacency_stack(mob, rounds, fed.num_nodes,
                                        mask=mask,
                                        start=session.rounds_completed)


class ChurnLogCallback(Callback):
    """Log the mobility scenario's link-churn summary for the rounds this
    run will cover (no-op on static topologies)."""

    def __init__(self, print_fn: Callable[[str], None] = print):
        self.print_fn = print_fn

    def on_run_start(self, session: "Session", rounds: int) -> None:
        adj = _adjacency(session, rounds)
        if adj is None:
            return
        from repro_torch import mobility as mobility_lib
        mob = session.experiment.fed.mobility
        stats = mobility_lib.handover_stats(adj)
        self.print_fn(
            f"mobility={mob.kind} range={mob.radio_range:.0f}m "
            f"speed={mob.speed:.0f}m/s: "
            f"{stats['links_per_round']:.1f} links/round, "
            f"churn={stats['churn_rate']:.3f}, "
            f"{stats['handovers']} handovers, "
            f"{stats['partitioned_rounds']}/{stats['rounds']} "
            f"partitioned rounds")


class DegreeStatsCallback(Callback):
    """Surface ``mobility.degree_stats`` for the rounds a run covers: one
    greppable line at run start (mean/max degree, isolated node-rounds,
    and the smallest lossless sparse top-D cap) and the per-round ``(R,)``
    stacks injected into ``result.metrics`` under ``degree_max`` /
    ``degree_mean`` / ``degree_isolated`` at run end. No-op on static
    topologies."""

    def __init__(self, print_fn: Callable[[str], None] = print):
        self.print_fn = print_fn
        self._stats: Optional[dict] = None

    def on_run_start(self, session: "Session", rounds: int) -> None:
        self._stats = None
        adj = _adjacency(session, rounds)
        if adj is None:
            return
        from repro_torch import mobility as mobility_lib
        stats = mobility_lib.degree_stats(adj)
        self._stats = stats
        self.print_fn(
            f"degrees: mean={float(stats['mean_degree'].mean()):.1f} "
            f"max={int(stats['max_degree'].max())} "
            f"isolated_node_rounds={int(stats['isolated'].sum())} "
            f"lossless_top_d={stats['max_degree_overall']}")

    def on_run_end(self, session: "Session", result: "RunResult") -> None:
        if self._stats is None:
            return
        result.metrics["degree_max"] = self._stats["max_degree"]
        result.metrics["degree_mean"] = self._stats["mean_degree"]
        result.metrics["degree_isolated"] = self._stats["isolated"]


class HealthCallback(Callback):
    """Summarize the fault-injection telemetry the trainer emits when
    ``fed.faults`` is active (``health`` / ``quarantined`` / ``frozen``
    per-round ``(R, K)`` stacks in ``result.metrics``): one greppable line
    per run with crashed node-rounds, quarantined payloads, and frozen
    (self-healed) buffer-rounds. No-op on fault-free runs."""

    def __init__(self, print_fn: Callable[[str], None] = print):
        self.print_fn = print_fn

    def on_run_end(self, session: "Session", result: "RunResult") -> None:
        if "health" not in result.metrics:
            return
        health = np.asarray(result.metrics["health"].cpu())
        crashed = int((1.0 - health).sum())
        quarantined = int(result.metrics["quarantined"].sum())
        frozen = int(result.metrics["frozen"].sum())
        self.print_fn(
            f"health: rounds={result.rounds} nodes={health.shape[1]} "
            f"crashed_node_rounds={crashed} quarantined={quarantined} "
            f"frozen={frozen}")


class IngestCallback(Callback):
    """Summarize the streaming-redundancy telemetry the trainer emits when
    ``fed.ingest`` is active (the per-round ``(R, K)`` ``est_distinct``
    stack in ``result.metrics``): one greppable line per run with each
    node's final effective-cardinality estimate and the fleet spread the
    mixing reweight gates on. No-op on ingest-free runs."""

    def __init__(self, print_fn: Callable[[str], None] = print):
        self.print_fn = print_fn

    def on_run_end(self, session: "Session", result: "RunResult") -> None:
        if "est_distinct" not in result.metrics:
            return
        est = result.metrics["est_distinct"][-1].cpu().numpy()
        spread = float(est.max() / max(float(est.min()), 1e-9))
        vals = " ".join(f"{v:.0f}" for v in est)
        self.print_fn(
            f"ingest: rounds={result.rounds} nodes={est.shape[0]} "
            f"est_distinct=[{vals}] spread={spread:.2f}")


# --------------------------------------------------------------------------
# RunResult.
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RunResult:
    """What one :meth:`Session.run` produced: the resumable final state,
    every per-round metric stacked along a leading (rounds,) axis, and
    wall time."""

    state: FedState
    metrics: Dict[str, torch.Tensor]
    rounds: int
    wall_time_s: float

    @property
    def final_params(self):
        """Node-stacked parameter views of the buffer after the last
        round."""
        return self.state.params


# --------------------------------------------------------------------------
# Batched fleet sweeps.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SweepAxes:
    """What varies across the V variants of a batched fleet sweep.

    Every axis is optional; the variant set is the CROSS PRODUCT of the
    given axes (last axis fastest, like nested loops):

    seeds:    an int N (seeds ``0..N-1``) or an explicit sequence — seed
              ``s`` inits params from a generator seeded with ``s`` and
              samples batches with sample seed ``s + 1``.
    lr:       per-variant learning rates (not available when the config's
              learning rate is a schedule).
    gamma:    per-variant consensus step-size caps (eq. 5's gamma,
              bounded per round by the stability bound as usual).
    mobility: per-variant ``MobilityConfig`` (or ``None`` for the static
              graph) — each variant runs its own kinematic scenario via a
              per-variant ``(V, R, K, K)`` / ``(V, R, K, D)`` stack.

    Everything else — fleet size, topology family, transport, local steps,
    fault plan, model — is shared by all variants. Sweep those by building
    one batch per config.
    """

    seeds: Any = None
    lr: Optional[Sequence[float]] = None
    gamma: Optional[Sequence[float]] = None
    mobility: Optional[Sequence[Any]] = None

    def seed_list(self) -> Optional[list]:
        if self.seeds is None:
            return None
        if isinstance(self.seeds, int):
            if self.seeds <= 0:
                raise ValueError(f"seeds count must be positive, got "
                                 f"{self.seeds}")
            return list(range(self.seeds))
        seeds = [int(s) for s in self.seeds]
        if not seeds:
            raise ValueError("seeds sequence is empty")
        return seeds

    def variants(self) -> list:
        """The cross product, as a list of dicts with the keys ``seed``,
        ``lr``, ``gamma`` and ``mobility``; unswept axes hold ``None``."""
        axes = [
            ("seed", self.seed_list()),
            ("lr", list(self.lr) if self.lr is not None else None),
            ("gamma", list(self.gamma) if self.gamma is not None
             else None),
            ("mobility", list(self.mobility) if self.mobility is not None
             else None),
        ]
        swept = [(name, vals) for name, vals in axes if vals is not None]
        if not swept:
            raise ValueError(
                "SweepAxes needs at least one axis (seeds / lr / gamma "
                "/ mobility)")
        for name, vals in swept:
            if len(vals) == 0:
                raise ValueError(f"sweep axis {name!r} is empty")
        out = [dict(seed=None, lr=None, gamma=None, mobility=None)]
        for name, vals in swept:
            out = [dict(v, **{name: val}) for v in out for val in vals]
        return out


@dataclasses.dataclass
class BatchResult(RunResult):
    """What one :meth:`BatchedSession.run_batch` produced: every tensor of
    ``state`` and every metric carries a leading (V,) variant axis
    (metrics: ``(V, R, K)``); ``variants`` names what each slot ran."""

    variants: Sequence[dict] = ()

    @property
    def num_variants(self) -> int:
        return len(self.variants)

    def select(self, i: int) -> RunResult:
        """The single-variant view: variant ``i``'s final state and
        ``(R, K)`` metrics as a plain :class:`RunResult`."""
        return RunResult(
            state=select_state(self.state, i),
            metrics={k: v[i] for k, v in self.metrics.items()},
            rounds=self.rounds, wall_time_s=self.wall_time_s)


# --------------------------------------------------------------------------
# Experiment.
# --------------------------------------------------------------------------

def _generator(rng, default: int) -> torch.Generator:
    """A CPU generator: ``rng`` itself, or seeded with ``rng`` (an int) or
    ``default``."""
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator().manual_seed(default if rng is None else rng)


def _seed(rng, default: int) -> int:
    """The sample seed of ``rng``: an int, a generator's initial seed, or
    ``default``."""
    if isinstance(rng, torch.Generator):
        return rng.initial_seed()
    return default if rng is None else int(rng)


class Experiment:
    """A declared C-DFL experiment: configs + model functions.

    :meth:`from_parts` wires explicit ``loss_fn(params, batch) -> (K,)`` /
    ``init_params(generator) -> params`` functions (the paper's MLP/VGG
    models, custom research models). ``Experiment(run_config)`` derives
    the token-LM loss and init from ``run_config.model``.

    The trainer is built lazily, once per distinct eval function (and,
    for a model-derived loss, sequence length), and shared by every
    :class:`Session` this experiment compiles. The cache holds at most 8
    trainers.
    """

    def __init__(self, config: Optional[RunConfig] = None, *,
                 fed: Optional[FedConfig] = None,
                 train: Optional[TrainConfig] = None,
                 model=None,
                 loss_fn: Optional[Callable] = None,
                 init_params: Optional[Callable] = None,
                 eval_fn: Optional[Callable] = None,
                 device=None):
        if config is None:
            config = RunConfig(model=model, fed=fed or FedConfig(),
                               train=train or TrainConfig())
        elif fed is not None or train is not None or model is not None:
            raise ValueError("pass EITHER a RunConfig or fed/train/model "
                             "parts, not both")
        self.config = config
        self.loss_fn = loss_fn
        self.init_params = init_params
        self.eval_fn = eval_fn
        self.device = resolve_device(device)
        self._trainers: dict = {}
        registry.ensure_plugins()

    @classmethod
    def from_parts(cls, loss_fn: Callable, init_params: Callable, *,
                   fed: Optional[FedConfig] = None,
                   train: Optional[TrainConfig] = None,
                   model=None,
                   eval_fn: Optional[Callable] = None,
                   device=None) -> "Experiment":
        """Declare an experiment from explicit model functions:
        ``loss_fn(params, batch) -> (K,)`` for node-stacked params and
        batch leaves ``(K, B, ...)``, and ``init_params(generator) ->
        params`` (one node's tree)."""
        return cls(fed=fed, train=train, model=model, loss_fn=loss_fn,
                   init_params=init_params, eval_fn=eval_fn, device=device)

    # -- convenience views --------------------------------------------------
    @property
    def fed(self) -> FedConfig:
        return self.config.fed

    @property
    def train(self) -> TrainConfig:
        return self.config.train

    # -- model derivation ---------------------------------------------------
    def _model_fns(self, data) -> tuple[Callable, Callable]:
        """(loss_fn, init_params): the explicit ones, or the token-LM pair
        derived from ``config.model`` (the loss one node at a time,
        :func:`repro_torch.models.transformer.node_losses`)."""
        if self.loss_fn is not None:
            if self.init_params is None:
                raise ValueError("loss_fn given without init_params")
            return self.loss_fn, self.init_params
        cfg = self.config.model
        if cfg is None or not hasattr(cfg, "vocab_size"):
            raise ValueError(
                "Experiment needs either loss_fn/init_params "
                "(Experiment.from_parts) or a ModelConfig on "
                "RunConfig.model to derive the token-LM loss from")
        from repro_torch.models import transformer

        def loss_fn(params, batch):
            return transformer.node_losses(params, cfg, batch)

        def init_params(gen):
            return transformer.init_params(cfg, gen, self.device)

        return loss_fn, init_params

    def trainer(self, data, eval_fn: Optional[Callable] = None) -> Trainer:
        """The trainer for this experiment, cached per eval function (the
        one thing that changes the per-round metrics) and, for a
        model-derived loss, per sequence length, as the JAX package keys
        it. The cache is bounded: a sweep passing a fresh eval lambda per
        run rebuilds the trainer but cannot grow memory without limit."""
        eval_fn = eval_fn if eval_fn is not None else self.eval_fn
        key = (eval_fn, None if self.loss_fn is not None
               else next(iter(data.values())).shape[-1])
        if key not in self._trainers:
            if len(self._trainers) >= 8:          # evict the oldest
                self._trainers.pop(next(iter(self._trainers)))
            loss_fn, _ = self._model_fns(data)
            self._trainers[key] = build_trainer(
                loss_fn, self.fed, self.train, eval_fn=eval_fn,
                device=self.device)
        return self._trainers[key]

    # -- compile ------------------------------------------------------------
    def compile(self, data, node_items, *, rng=None, sample_rng=None,
                n_items=None, same_init: bool = True) -> "Session":
        """Build a live :class:`Session`: trainer + device-resident data +
        initialized :class:`FedState`.

        data:       dict of node-stacked dataset arrays, leaves (K, N, ...),
                    keyed as ``loss_fn`` expects a batch.
        node_items: (K, n, f) int feature tokens per node — the CND
                    sketches (eqs. 6-7 weights) are built from these.
        rng:        the init generator (on the CPU, or on the card for a
                    model-derived init), or its seed (default
                    ``train.seed``, a CPU generator). With
                    ``same_init=False`` each node's params are the next
                    draw from it.
        sample_rng: the seed of batch sampling across ALL rounds, or a
                    generator whose initial seed it is (default
                    ``train.seed + 1``); round r's indices come from a
                    generator keyed on (seed, r).
        n_items:    optional (K,) true per-node item counts when the
                    resident arrays are padded to a common N (ragged
                    nodes, e.g. after CND dedup).
        """
        data = {name: torch.as_tensor(v, device=self.device)
                for name, v in data.items()}
        state = self._init(data, node_items, _generator(rng, self.train.seed),
                           same_init)
        return Session(self, data, state, n_items=n_items,
                       sample_rng=sample_rng)

    def _init(self, data, node_items, gen: torch.Generator,
              same_init: bool) -> FedState:
        """The initialized state of one run: params drawn from ``gen``
        (each node's the next draw with ``same_init=False``), then
        ``trainer.init`` with its CND sketch."""
        trainer = self.trainer(data)
        _, init_params = self._model_fns(data)
        if same_init:
            params = init_params(gen)
        else:
            trees = [flatten.leaves_with_paths(init_params(gen))
                     for _ in range(self.fed.num_nodes)]
            params = flatten.build_tree(
                [path for path, _ in trees[0]],
                [torch.stack([torch.as_tensor(t[i][1]) for t in trees])
                 for i in range(len(trees[0]))])
        return trainer.init(params, node_items, same_init=same_init)

    def compile_batch(self, data, node_items, axes: SweepAxes, *,
                      rng=None, sample_rng=None, n_items=None,
                      same_init: bool = True) -> "BatchedSession":
        """Build a :class:`BatchedSession`: V variant runs — the cross
        product of ``axes`` — over one (V,)-stacked :class:`FedState`.

        The dataset, node sketches and any fault plan are SHARED by all
        variants (one device copy); per-variant state costs ``V x (K, P)``
        params plus two Adam moment buffers of the same shape, so budget
        roughly ``3 V K P`` f32 on top of a single run. ``rng`` /
        ``sample_rng`` seed the variants only when the seed axis is
        unswept (a swept seed ``s`` inits from seed ``s`` and samples with
        seed ``s + 1``). There is one init, with its CND sketch, per
        unique seed.
        """
        if (axes.lr is not None and callable(self.train.learning_rate)):
            raise ValueError(
                "cannot sweep lr: this experiment's learning rate is a "
                "schedule (callable); per-variant rates only override "
                "constant rates")
        variants = axes.variants()
        data = {name: torch.as_tensor(v, device=self.device)
                for name, v in data.items()}
        # one init per UNIQUE seed (the only axis that changes init)
        inits: Dict[Any, FedState] = {}
        for v in variants:
            if v["seed"] not in inits:
                gen = _generator(rng if v["seed"] is None else v["seed"],
                                 self.train.seed)
                inits[v["seed"]] = self._init(data, node_items, gen,
                                              same_init)
        states = stack_states(inits[v["seed"]] for v in variants)
        seeds = [_seed(sample_rng, self.train.seed + 1) if v["seed"] is None
                 else v["seed"] + 1 for v in variants]
        return BatchedSession(self, data, states, variants, seeds, axes,
                              n_items=n_items)


# --------------------------------------------------------------------------
# Session.
# --------------------------------------------------------------------------

def _item_counts(n_items) -> Optional[torch.Tensor]:
    return (None if n_items is None
            else torch.as_tensor(n_items).to(torch.int64).cpu())


def _batch_indices(experiment: Experiment, data, n_items, seed: int,
                   start: int, rounds: int) -> torch.Tensor:
    """:meth:`Session.batch_indices` of sample seed ``seed``."""
    fed, train = experiment.fed, experiment.train
    shape = (fed.num_nodes, fed.local_steps, train.batch_size)
    max_items = next(iter(data.values())).shape[1]
    uniforms = fed.ingest is not None and fed.ingest.active and \
        fed.ingest.correct_sampling
    out = []
    for r in range(start, start + rounds):
        key = np.random.SeedSequence([seed, r]).generate_state(2, np.uint32)
        gen = torch.Generator().manual_seed((int(key[0]) << 32) | int(key[1]))
        if uniforms:
            out.append(torch.rand(shape, generator=gen))
        elif n_items is None:
            out.append(torch.randint(0, max_items, shape, generator=gen))
        else:
            u = torch.rand(shape, generator=gen)
            n = n_items[:, None, None]
            out.append(torch.minimum((u * n).to(torch.int64), n - 1))
    return torch.stack(out)


class Session:
    """A compiled, resumable run: live :class:`FedState` + resident data
    + the experiment's shared trainer. Not constructed directly — use
    :meth:`Experiment.compile`."""

    def __init__(self, experiment: Experiment, data, state: FedState, *,
                 n_items=None, sample_rng=None):
        self.experiment = experiment
        self.data = data
        self._state = state
        self._n_items = _item_counts(n_items)
        self._seed = _seed(sample_rng, experiment.train.seed + 1)

    @property
    def state(self) -> FedState:
        """The live federated state (params/opt/CND ratios/round/transport
        state)."""
        return self._state

    @property
    def rounds_completed(self) -> int:
        return int(self._state.round)

    def batch_indices(self, start: int, rounds: int,
                      seed: Optional[int] = None) -> torch.Tensor:
        """The (R, K, S, B) batch indices of absolute rounds ``[start,
        start + rounds)``: round r's from a CPU generator keyed on
        (``seed``, r), uniform over the resident items, or over each
        node's ``n_items`` as ``run_rounds`` draws them. Under
        duplicate-corrected ingest sampling, f32 uniforms in [0, 1) that
        ``run_rounds`` maps through each round's sketch."""
        return _batch_indices(self.experiment, self.data, self._n_items,
                              self._seed if seed is None else seed, start,
                              rounds)

    # -- running ------------------------------------------------------------
    def run(self, rounds: int, callbacks: Sequence[Callback] = (),
            rng=None, *, idx=None) -> RunResult:
        """Advance the session ``rounds`` federated rounds.

        With no periodic (``every=N``) callbacks this is ONE
        ``run_rounds`` call. Periodic callbacks split the run into
        boundary-aligned segments; metrics are concatenated across
        segments so the result is indistinguishable from one call.
        ``rng``: a sample seed (or generator) for this run only.
        ``idx``: explicit (R, K, S, B) batch indices of this run's rounds
        in place of the drawn ones (e.g. the JAX package's).
        """
        if rounds <= 0:
            raise ValueError(f"rounds must be positive, got {rounds}")
        callbacks = list(callbacks)
        eval_fns = [cb.eval_fn for cb in callbacks
                    if cb.eval_fn is not None]
        if len(eval_fns) > 1:
            raise ValueError("at most one EvalCallback per run")
        trainer = self.experiment.trainer(
            self.data, eval_fn=eval_fns[0] if eval_fns else None)
        start = self.rounds_completed
        if idx is None:
            idx = self.batch_indices(start, rounds,
                                     None if rng is None
                                     else _seed(rng, self._seed))
        idx = torch.as_tensor(idx)
        if idx.dim() < 1 or idx.shape[0] != rounds:
            raise ValueError(f"batch index stack {tuple(idx.shape)} does "
                             f"not hold the run's {rounds} rounds")

        marks = {rounds}
        for cb in callbacks:
            if cb.every:
                marks.update(range(cb.every, rounds + 1, cb.every))
        for cb in callbacks:
            cb.on_run_start(self, rounds)

        t0 = time.time()
        parts = []
        prev = 0
        for mark in sorted(marks):
            self._state, metrics = trainer.run_rounds(
                self._state, self.data, mark - prev, idx=idx[prev:mark],
                n_items=self._n_items)
            parts.append(metrics)
            prev = mark
            for cb in callbacks:
                if cb.every and mark % cb.every == 0 and mark < rounds:
                    cb.on_rounds(self, start + mark)
        metrics = {name: torch.cat([p[name] for p in parts])
                   for name in parts[0]}
        if self._state.buf.is_cuda:
            torch.cuda.synchronize(self._state.buf.device)
        result = RunResult(state=self._state, metrics=metrics,
                           rounds=rounds, wall_time_s=time.time() - t0)
        for cb in callbacks:
            cb.on_run_end(self, result)
        return result

    # -- checkpoint / resume -------------------------------------------------
    def save(self, path: str) -> str:
        """Checkpoint the FULL resumable state (params, optimizer, CND
        ratios/sizes, round counter, transport state such as gossip
        snapshots, straggle buffer, ingest sketches) to ``path``."""
        _ckpt_save(path, self._state, step=self.rounds_completed)
        return path

    def resume(self, path: str) -> "Session":
        """Restore a checkpoint written by :meth:`save` (or a
        :class:`CheckpointCallback`) into this session and continue the
        SAME run: the restored round counter keys batch sampling, the
        mobility trace and the fault schedules, so resumed rounds
        reproduce an unsegmented run exactly. Returns ``self`` for
        chaining."""
        try:
            self._state = _ckpt_restore(path, self._state)
        except Exception as e:
            raise ValueError(
                f"cannot resume from {path!r}: checkpoint does not match "
                f"this session's state layout (was it saved under a "
                f"different algorithm/transport/fault config or model "
                f"size, or is it corrupt?): {e}") from e
        return self


# --------------------------------------------------------------------------
# BatchedSession.
# --------------------------------------------------------------------------

class BatchedSession:
    """V variant runs over one (V,)-stacked :class:`FedState` and shared
    resident data, run by ``Trainer.run_rounds_batch``. Not constructed
    directly — use :meth:`Experiment.compile_batch`.

    Unlike :class:`Session` this is NOT resumable: a batched run is a
    one-shot sweep (checkpointing V entangled variants into the single-run
    checkpoint format would silently break the segmentation-invariance
    contract), so :meth:`save` and :meth:`resume` raise. Re-run the winning
    variant through a plain ``compile()`` Session when it needs
    checkpoints."""

    def __init__(self, experiment: Experiment, data, states: FedState,
                 variants: Sequence[dict], rngs: Sequence[int],
                 axes: SweepAxes, *, n_items=None):
        self.experiment = experiment
        self.data = data
        self._states = states
        self.variants = list(variants)
        self._rngs = list(rngs)          # each variant's sample seed
        self._axes = axes
        self._n_items = _item_counts(n_items)

    @property
    def num_variants(self) -> int:
        return len(self.variants)

    @property
    def states(self) -> FedState:
        """The live (V,)-stacked federated state."""
        return self._states

    @property
    def rounds_completed(self) -> int:
        return int(torch.as_tensor(self._states.round)[0])

    def batch_indices(self, start: int, rounds: int) -> torch.Tensor:
        """The (V, R, K, S, B) batch indices of absolute rounds ``[start,
        start + rounds)``: variant v's those a plain :class:`Session` with
        its sample seed draws (:meth:`Session.batch_indices`)."""
        return torch.stack([_batch_indices(self.experiment, self.data,
                                           self._n_items, seed, start,
                                           rounds) for seed in self._rngs])

    def run_batch(self, rounds: int,
                  callbacks: Sequence[Callback] = ()) -> BatchResult:
        """Advance ALL variants ``rounds`` federated rounds, V runs in the
        launches of one: variant v's batch indices are those a plain
        Session with its sample seed draws.

        Only run-boundary callbacks are allowed (one :class:`EvalCallback`,
        run-start and run-end hooks): periodic ``every=N`` callbacks
        segment the run with host-side work per variant, which defeats the
        batching — they raise here.
        """
        if rounds <= 0:
            raise ValueError(f"rounds must be positive, got {rounds}")
        callbacks = list(callbacks)
        for cb in callbacks:
            if cb.every:
                raise ValueError(
                    f"{type(cb).__name__}(every={cb.every}) needs "
                    f"host-side scan segmentation — unsupported on "
                    f"batched runs; use a plain Session per variant "
                    f"for periodic callbacks")
        eval_fns = [cb.eval_fn for cb in callbacks
                    if cb.eval_fn is not None]
        if len(eval_fns) > 1:
            raise ValueError("at most one EvalCallback per run")
        trainer = self.experiment.trainer(
            self.data, eval_fn=eval_fns[0] if eval_fns else None)
        for cb in callbacks:
            cb.on_run_start(self, rounds)
        t0 = time.time()
        start = self.rounds_completed
        etas = gammas = None
        mob_swept = self._axes.mobility is not None
        gamma_swept = self._axes.gamma is not None
        if mob_swept or gamma_swept:
            # per-variant graphs: build each UNIQUE (scenario, cap) stack
            # once, share when the cross product collapses to one
            state0 = select_state(self._states, 0)
            keys = [(v["mobility"] if mob_swept else "config",
                     v["gamma"] if gamma_swept else None)
                    for v in self.variants]
            uniq: Dict[Any, Any] = {}
            for key in keys:
                if key not in uniq:
                    uniq[key] = trainer.mixing_stack(
                        state0, rounds, start=start, mobility=key[0],
                        gamma_cap=key[1])
            if len(uniq) == 1:
                etas, gammas = next(iter(uniq.values()))
            else:
                from repro_torch.mobility import mixing as mobility_mixing
                etas = mobility_mixing.stack_variant_stacks(
                    [uniq[k][0] for k in keys])
                gammas = torch.stack([uniq[k][1].to(torch.float32)
                                      for k in keys])
        lrs = None
        if self._axes.lr is not None:
            lrs = torch.tensor([v["lr"] for v in self.variants],
                               dtype=torch.float32)
        self._states, metrics = trainer.run_rounds_batch(
            self._states, self.data, rounds, n_items=self._n_items,
            eta_stacks=etas, gamma_stacks=gammas, lrs=lrs,
            idx=self.batch_indices(start, rounds))
        if self._states.buf.is_cuda:
            torch.cuda.synchronize(self._states.buf.device)
        result = BatchResult(state=self._states, metrics=metrics,
                             rounds=rounds, wall_time_s=time.time() - t0,
                             variants=self.variants)
        for cb in callbacks:
            cb.on_run_end(self, result)
        return result

    # -- checkpoint / resume: deliberately unsupported ----------------------
    def save(self, path: str) -> str:
        raise ValueError(
            "cannot checkpoint a batched run: the (V,)-stacked state "
            "does not fit the single-run checkpoint format. Re-run the "
            "variant you want to keep through Experiment.compile() and "
            "save that Session.")

    def resume(self, path: str) -> "BatchedSession":
        raise ValueError(
            "cannot resume a batched run: batched sessions are one-shot "
            "sweeps. Resume single-run checkpoints through "
            "Experiment.compile().resume(path).")


# --------------------------------------------------------------------------
# Legacy bridge.
# --------------------------------------------------------------------------

def run_experiment(config: RunConfig, data, node_items, rounds: int, *,
                   device=None, **compile_kw) -> RunResult:
    """One-call convenience: declare, compile, run."""
    return Experiment(config, device=device).compile(
        data, node_items, **compile_kw).run(rounds)
