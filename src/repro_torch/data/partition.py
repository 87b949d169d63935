"""Partitioning a dataset across federated nodes (non-IID options). Numpy;
a copy of the JAX package's, so both packages see the same arrays."""
from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import Dataset


def iid_partition(ds: Dataset, k: int, seed: int = 0) -> list[Dataset]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(ds.x.shape[0])
    chunks = np.array_split(perm, k)
    return [Dataset(ds.x[c], ds.y[c], ds.features[c]) for c in chunks]


def dirichlet_partition(ds: Dataset, k: int, alpha: float = 0.5,
                        seed: int = 0) -> list[Dataset]:
    """Label-skewed non-IID split (Dirichlet over class proportions)."""
    rng = np.random.default_rng(seed)
    classes = np.unique(ds.y)
    node_idx: list[list[int]] = [[] for _ in range(k)]
    for c in classes:
        idx = np.flatnonzero(ds.y == c)
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * k)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for node, part in enumerate(np.split(idx, cuts)):
            node_idx[node].extend(part.tolist())
    out = []
    for node in range(k):
        sel = np.array(sorted(node_idx[node]), dtype=int)
        if sel.size == 0:                      # guarantee non-empty
            sel = np.array([rng.integers(0, ds.x.shape[0])])
        out.append(Dataset(ds.x[sel], ds.y[sel], ds.features[sel]))
    return out
