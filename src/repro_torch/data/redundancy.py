"""Redundancy injection — the data condition the paper studies.

In V2X, nearby vehicles capture overlapping scenes, so a base station's
local dataset contains near/exact duplicates (paper Sec. 4.2). We model it
with exact-duplicate injection: a node's dataset of size E_k holds only
E_k' distinct items, E_k'/E_k = distinct_ratio.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import Dataset


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


def true_distinct_count(features: np.ndarray) -> int:
    """Ground truth |distinct| (for validating the CND estimate)."""
    return np.unique(features, axis=0).shape[0]
