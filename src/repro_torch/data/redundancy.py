"""Redundancy injection — the data condition the paper studies.

In V2X, nearby vehicles capture overlapping scenes, so a base station's
local dataset contains near/exact duplicates (paper Sec. 4.2). We model it
with exact-duplicate injection: a node's dataset of size E_k holds only
E_k' distinct items, E_k'/E_k = distinct_ratio.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import sketch
from repro_torch.data.synthetic import Dataset


def cnd_dedup(ds: Dataset, num_hashes: int = 3, m: int = 8192) -> Dataset:
    """CND-based redundant-data filtering (paper Sec. 4.2: 'base stations
    can filter redundant data and thus speed up local updating').

    The CND bitmap doubles as a Bloom filter: an item whose ``num_hashes``
    bucket bits are all already set is (w.h.p.) a duplicate and is
    dropped. The filter is evaluated exactly through the hash triples
    (collision probability ~ (n/m)^H, negligible at the paper's m); the
    first copy of each triple is kept, in the original order. Host work on
    the CPU."""
    idx = sketch.hash_items(torch.as_tensor(np.asarray(ds.features)),
                            num_hashes, m).numpy()       # (H, n)
    _, first = np.unique(idx.T, axis=0, return_index=True)
    keep = np.sort(first)
    return Dataset(x=ds.x[keep], y=ds.y[keep], features=ds.features[keep])


def inject_duplicates(ds: Dataset, distinct_ratio: float,
                      seed: int = 0) -> Dataset:
    """Keep ``distinct_ratio`` of items distinct; fill the rest by
    resampling (with replacement) from the distinct pool. Size preserved."""
    n = ds.x.shape[0]
    n_distinct = max(1, int(round(n * distinct_ratio)))
    rng = np.random.default_rng(seed)
    dup_idx = rng.integers(0, n_distinct, size=n - n_distinct)
    idx = np.concatenate([np.arange(n_distinct), dup_idx])
    rng.shuffle(idx)
    return Dataset(x=ds.x[idx], y=ds.y[idx], features=ds.features[idx])


def cross_node_overlap(datasets: list[Dataset], overlap: float,
                       seed: int = 0) -> list[Dataset]:
    """Make ``overlap`` fraction of each node's items copies of its ring
    predecessor's items (adjacent vehicles see the same scene)."""
    if overlap <= 0:
        return datasets
    rng = np.random.default_rng(seed)
    out = []
    k = len(datasets)
    for i, ds in enumerate(datasets):
        prev = datasets[(i - 1) % k]
        n = ds.x.shape[0]
        n_copy = int(round(n * overlap))
        take = rng.integers(0, prev.x.shape[0], size=n_copy)
        keep = rng.choice(n, size=n - n_copy, replace=False)
        x = np.concatenate([ds.x[keep], prev.x[take]])
        y = np.concatenate([ds.y[keep], prev.y[take]])
        f = np.concatenate([ds.features[keep], prev.features[take]])
        perm = rng.permutation(n)
        out.append(Dataset(x=x[perm], y=y[perm], features=f[perm]))
    return out


def true_distinct_count(features: np.ndarray) -> int:
    """Ground truth |distinct| (for validating the CND estimate)."""
    return np.unique(features, axis=0).shape[0]
