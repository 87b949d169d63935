"""Quickstart: C-DFL (consensus decentralized federated learning) through
the port's declarative ``repro_torch.experiment`` API — 4 base stations on
a ring, redundant local data, CND-weighted consensus + local Adam. The
twin of the JAX package's ``examples/quickstart.py``, on the card unless
asked for the CPU:

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.base import FedConfig, TrainConfig
from repro_torch.configs.paper_models import MLP_CONFIG
from repro_torch.data import pipeline, redundancy, synthetic
from repro_torch.experiment import Experiment, RunResult
from repro_torch.models import simple


def main(argv=None) -> RunResult:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    # 1. per-station datasets — V2X-style redundancy: only 10-80% distinct
    nodes = [redundancy.inject_duplicates(
        synthetic.synthetic_mnist(seed=i, n=320, noise=2.0), ratio, seed=i)
        for i, ratio in enumerate([0.1, 0.3, 0.5, 0.8])]
    data = {"x": np.stack([d.x for d in nodes]),
            "y": np.stack([d.y for d in nodes])}

    # 2. declare the experiment around any K-batched loss function (every
    #    config string — transport, wire codec, mixing, algorithm — is a
    #    registered plugin name, validated at construction)
    loss = simple.make_mlp_loss(MLP_CONFIG)
    exp = Experiment.from_parts(
        lambda p, b: loss(p, b),
        lambda g: simple.mlp_init(g, MLP_CONFIG, device=args.device),
        fed=FedConfig(num_nodes=4, topology="ring", gamma=0.5,
                      local_steps=10),
        train=TrainConfig(learning_rate=1e-3, batch_size=32),
        device=args.device)

    # 3. compile: CND sketches of each station's data drive the weights
    items = pipeline.FederatedBatcher(nodes, 32, 10, seed=0).node_items()
    session = exp.compile(data, items)
    print("CND distinct-data ratios (Ë_k, eq.7):",
          np.round(session.state.ratios.cpu().numpy(), 2))

    # 4. federated rounds: consensus + local steps, one run_rounds call
    result = session.run(10)
    loss_r = result.metrics["loss"].cpu().numpy()
    dis_r = result.metrics["disagreement"].cpu().numpy()
    for r in range(result.rounds):
        print(f"round {r}: loss/station={np.round(loss_r[r], 3)} "
              f"disagreement={dis_r[r]:.2e}")
    print("done — stations converged to a consensus model without any "
          "server.")
    return result


if __name__ == "__main__":
    main()
