"""Algorithm plugins (paper Sec. 5.3), registered as
:class:`repro_torch.registry.AlgorithmSpec` entries so that all of them
see the same data and initialization through one trainer.

  C-DFL      — CND-weighted consensus (the paper's method).
  CFA        — consensus FedAvg (Savazzi et al. [20]): datasize weights,
               redundancy-blind.
  C-DFA      — consensus-driven FA (Barbieri et al. [21]): uniform weights
               on a fraction M of the layers (the paper compares M=100%).
  CDFA       — D-PSGD (Lian et al. [7]): gossip average every SGD step.
  FedAvg     — centralized reference: a server average every round.
  Metropolis — Metropolis-Hastings weights (doubly stochastic).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import FedConfig, TrainConfig
from repro_torch.core import topology
from repro_torch.core.cdfl import Trainer, build_trainer
from repro_torch.registry import AlgorithmSpec, algorithms


def _register(name: str):
    def make(loss_fn, fed: FedConfig, train: TrainConfig, **kw) -> Trainer:
        return build_trainer(loss_fn, dataclasses.replace(fed, algorithm=name),
                             train, **kw)

    algorithms.register(name, AlgorithmSpec(
        name=name, mixing=topology.ALGORITHM_MIXING[name],
        uses_transport=name not in ("fedavg", "dpsgd"), make=make))
    return make


cdfl = _register("cdfl")
cfa = _register("cfa")
dpsgd = _register("dpsgd")
fedavg = _register("fedavg")
metropolis = _register("metropolis")


def cdfa_m(loss_fn, fed: FedConfig, train: TrainConfig,
           fraction: float = 1.0, **kw) -> Trainer:
    f = dataclasses.replace(fed, algorithm="cdfa_m", cdfa_fraction=fraction)
    return build_trainer(loss_fn, f, train, **kw)


algorithms.register("cdfa_m", AlgorithmSpec(
    name="cdfa_m", mixing=topology.ALGORITHM_MIXING["cdfa_m"],
    uses_transport=True, make=cdfa_m))
