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
  batch indices itself, round r's from a generator keyed on (sample seed,
  absolute round r); mobility stacks and fault plans are keyed on the
  absolute round as well. So run(10) + save + resume + run(10) reproduces
  run(20) bit for bit, with no generator state in the checkpoint.
* **Callbacks.** Per-round eval is a trainer metric (:class:`EvalCallback`);
  host-side hooks (:class:`CheckpointCallback`, :class:`ChurnLogCallback`)
  fire at segment boundaries, and the metrics of the segments are
  concatenated along the rounds axis.

Batched sweeps (``SweepAxes``, ``BatchedSession``, ``compile_batch``) and
``IngestCallback`` are not ported yet (ROADMAP queue A items 21 and 19).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import registry
from repro_torch.checkpointing import restore as _ckpt_restore
from repro_torch.checkpointing import save as _ckpt_save
from repro_torch.configs.base import FedConfig, RunConfig, TrainConfig
from repro_torch.core import flatten
from repro_torch.core.cdfl import FedState, Trainer, build_trainer
from repro_torch.device import resolve_device

__all__ = [
    "Experiment", "Session", "RunResult",
    "Callback", "EvalCallback", "CheckpointCallback", "ChurnLogCallback",
    "DegreeStatsCallback", "HealthCallback",
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
    """The (R, K, K) radio links of the rounds a run covers, or None on a
    static topology (the ring transport, which would gate them to the
    ring, is not ported)."""
    fed = session.experiment.fed
    mob = fed.mobility
    if mob is None or mob.kind == "static":
        return None
    from repro_torch import mobility as mobility_lib
    return mobility_lib.adjacency_stack(mob, rounds, fed.num_nodes,
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
        trainer = self.trainer(data)
        _, init_params = self._model_fns(data)
        gen = _generator(rng, self.train.seed)
        if same_init:
            params = init_params(gen)
        else:
            trees = [flatten.leaves_with_paths(init_params(gen))
                     for _ in range(self.fed.num_nodes)]
            params = flatten.build_tree(
                [path for path, _ in trees[0]],
                [torch.stack([torch.as_tensor(t[i][1]) for t in trees])
                 for i in range(len(trees[0]))])
        state = trainer.init(params, node_items, same_init=same_init)
        return Session(self, data, state, n_items=n_items,
                       sample_rng=sample_rng)


# --------------------------------------------------------------------------
# Session.
# --------------------------------------------------------------------------

class Session:
    """A compiled, resumable run: live :class:`FedState` + resident data
    + the experiment's shared trainer. Not constructed directly — use
    :meth:`Experiment.compile`."""

    def __init__(self, experiment: Experiment, data, state: FedState, *,
                 n_items=None, sample_rng=None):
        self.experiment = experiment
        self.data = data
        self._state = state
        self._n_items = (None if n_items is None
                         else torch.as_tensor(n_items).to(torch.int64).cpu())
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
        node's ``n_items`` as ``run_rounds`` draws them."""
        seed = self._seed if seed is None else seed
        fed, train = self.experiment.fed, self.experiment.train
        shape = (fed.num_nodes, fed.local_steps, train.batch_size)
        max_items = next(iter(self.data.values())).shape[1]
        out = []
        for r in range(start, start + rounds):
            key = np.random.SeedSequence([seed, r]).generate_state(
                2, np.uint32)
            gen = torch.Generator().manual_seed(
                (int(key[0]) << 32) | int(key[1]))
            if self._n_items is None:
                out.append(torch.randint(0, max_items, shape, generator=gen))
            else:
                u = torch.rand(shape, generator=gen)
                n = self._n_items[:, None, None]
                out.append(torch.minimum((u * n).to(torch.int64), n - 1))
        return torch.stack(out)

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
        ratios/sizes, round counter, transport and straggle state) to
        ``path``."""
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
# Legacy bridge.
# --------------------------------------------------------------------------

def run_experiment(config: RunConfig, data, node_items, rounds: int, *,
                   device=None, **compile_kw) -> RunResult:
    """One-call convenience: declare, compile, run."""
    return Experiment(config, device=device).compile(
        data, node_items, **compile_kw).run(rounds)
