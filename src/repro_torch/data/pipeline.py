"""Host-side batching pipeline feeding the federated trainer.

Produces node-stacked batches: every leaf is (K, local_steps, B, ...).
Deterministic per (seed, round). Numpy; a copy of the JAX package's
batcher, so both packages see the same arrays.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.data.synthetic import Dataset


class FederatedBatcher:
    """Samples per-node minibatches with replacement (paper trains with
    fixed-size local datasets of 120-320 items, far smaller than epochs)."""

    def __init__(self, node_datasets: list[Dataset], batch_size: int,
                 local_steps: int, seed: int = 0, kind: str = "image"):
        self.datasets = node_datasets
        self.batch = batch_size
        self.steps = local_steps
        self.kind = kind
        self.rng = np.random.default_rng(seed)

    @property
    def num_nodes(self) -> int:
        return len(self.datasets)

    def node_items(self) -> np.ndarray:
        """(K, n, F) int32 CND feature tokens (for trainer init). Nodes may
        have unequal sizes; pad by cycling."""
        n = max(d.features.shape[0] for d in self.datasets)
        out = []
        for d in self.datasets:
            f = d.features
            reps = int(np.ceil(n / f.shape[0]))
            out.append(np.tile(f, (reps, 1))[:n])
        return np.stack(out).astype(np.int32)

    def next_round(self) -> dict:
        """One round of batches: {"x": (K,S,B,...), "y": (K,S,B)}."""
        xs, ys = [], []
        for d in self.datasets:
            idx = self.rng.integers(0, d.x.shape[0],
                                    size=(self.steps, self.batch))
            xs.append(d.x[idx])
            ys.append(d.y[idx])
        return {"x": np.stack(xs), "y": np.stack(ys)}

    def rounds(self, n: int) -> Iterator[dict]:
        for _ in range(n):
            yield self.next_round()


def lm_batches(node_datasets: list[Dataset], batch_size: int,
               local_steps: int, seed: int = 0) -> dict:
    """Token-LM variant: {"tokens": (K,S,B,T), "labels": (K,S,B,T)}."""
    rng = np.random.default_rng(seed)
    toks, labs = [], []
    for d in node_datasets:
        idx = rng.integers(0, d.x.shape[0], size=(local_steps, batch_size))
        seqs = d.x[idx]                        # (S, B, T+1)
        toks.append(seqs[..., :-1])
        labs.append(seqs[..., 1:])
    return {"tokens": np.stack(toks), "labels": np.stack(labs)}
