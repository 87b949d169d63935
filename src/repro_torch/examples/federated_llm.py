"""End-to-end driver: federated training of a ~100M-parameter decoder-only
LM (qwen3-family reduced config) with C-DFL across 4 nodes on synthetic
token data with injected redundancy — the twin of the JAX package's
``examples/federated_llm.py``, on the card unless asked for the CPU.

The paper's technique as a first-class distributed-training feature: the
same trainer that reproduces the MLP/VGG tables wraps the assigned
architectures unchanged. On the card each local step's forward launches
kernel B9 for attention; the backward differentiates its plain version.

  PYTHONPATH=src python -m repro_torch.examples.federated_llm --rounds 300
  PYTHONPATH=src python -m repro_torch.examples.federated_llm --tiny \\
      [--device cpu]                                             # smoke
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpointing import save
from repro_torch.configs.base import FedConfig, TrainConfig
from repro_torch.configs.registry import get_arch
from repro_torch.core import baselines
from repro_torch.data import pipeline, redundancy, synthetic
from repro_torch.models import transformer


def model_100m():
    """qwen3-family scaled to ~100M params."""
    return dataclasses.replace(
        get_arch("qwen3-1.7b"), name="qwen3-100m", num_layers=8,
        d_model=640, num_heads=10, num_kv_heads=5, head_dim=64,
        d_ff=1792, vocab_size=8192, dtype="float32")


def model_tiny():
    return dataclasses.replace(
        model_100m(), name="qwen3-tiny", num_layers=2, d_model=128,
        num_heads=2, num_kv_heads=1, d_ff=256, vocab_size=512)


def main(argv=None):
    """Train, print progress lines and save the checkpoint; returns (final
    FedState, (R,) mean loss a round, (R,) seconds a round)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--redundancy", type=float, default=0.5)
    ap.add_argument("--checkpoint", default="ckpt_federated_llm")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = model_tiny() if args.tiny else model_100m()
    if args.tiny:
        args.rounds = min(args.rounds, 5)
        args.seq = 32

    nodes = [redundancy.inject_duplicates(
        synthetic.token_lm(seed=i, n_seqs=512, seq_len=args.seq,
                           vocab=cfg.vocab_size),
        1.0 - args.redundancy, seed=i) for i in range(args.nodes)]

    def loss_fn(params, batch):
        return transformer.node_losses(params, cfg, batch)

    fed = FedConfig(num_nodes=args.nodes, local_steps=args.local_steps)
    train = TrainConfig(learning_rate=3e-4, batch_size=args.batch)
    tr = baselines.cdfl(loss_fn, fed, train, device=args.device)
    batcher = pipeline.FederatedBatcher(nodes, args.batch, args.local_steps)
    state = tr.init(transformer.init_params(
        cfg, torch.Generator().manual_seed(0), tr.device),
        batcher.node_items())
    n_params = state.layout.total
    print(f"model={cfg.name} params/node={n_params/1e6:.1f}M "
          f"nodes={args.nodes} CND ratios="
          f"{np.round(state.ratios.cpu().numpy(), 2)}")

    t_start = time.time()
    means, seconds = [], []
    for r in range(args.rounds):
        t0 = time.time()
        batch = pipeline.lm_batches(nodes, args.batch, args.local_steps,
                                    seed=r)
        state, m = tr.round(state, batch)
        means.append(float(m["loss"].mean()))       # waits for the round
        seconds.append(time.time() - t0)
        if r % max(1, args.rounds // 20) == 0 or r == args.rounds - 1:
            print(f"round {r:4d} loss={means[-1]:.4f} "
                  f"disagree={float(m['disagreement']):.2e} "
                  f"elapsed={time.time() - t_start:.0f}s")

    save(args.checkpoint, state.params, step=args.rounds)
    print(f"checkpoint -> {args.checkpoint}")
    return state, np.asarray(means), np.asarray(seconds)


if __name__ == "__main__":
    main()
