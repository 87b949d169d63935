"""Deterministic synthetic datasets (numpy; a copy of the JAX package's
generator, so both packages see the same arrays).

MNIST/BIRD-400 are not downloadable offline; these generators produce
class-structured data with the same shapes and — crucially for this paper —
**controllable redundancy** (exact-duplicate injection), which is the
variable C-DFL's CND sketch exploits. Class templates + bounded noise make
the classification tasks learnable at paper-comparable rates.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Dataset(NamedTuple):
    x: np.ndarray            # (N, ...) inputs
    y: np.ndarray            # (N,) int labels
    features: np.ndarray     # (N, F) int32 CND feature tokens per item


def _cnd_features(x: np.ndarray, n_features: int = 16) -> np.ndarray:
    """Quantize each item into int32 feature tokens (paper Alg. 1 tokenizes
    items into features). Exact duplicates -> identical feature rows."""
    flat = x.reshape(x.shape[0], -1)
    # pool into n_features buckets, quantize to 12 bits
    n = flat.shape[1]
    pad = (-n) % n_features
    if pad:
        flat = np.pad(flat, ((0, 0), (0, pad)))
    pooled = flat.reshape(x.shape[0], n_features, -1).mean(axis=2)
    lo, hi = pooled.min(), pooled.max() + 1e-9
    q = ((pooled - lo) / (hi - lo) * 4095).astype(np.int32)
    return q


def synthetic_mnist(seed: int, n: int, num_classes: int = 10,
                    image_dim: int = 28, noise: float = 0.6,
                    classes: list | None = None) -> Dataset:
    """Class-template images, 28x28x1 flattened to 784 (paper Sec. 5.2).

    noise: template SNR knob (higher = harder task).
    classes: restrict to a label subset (non-IID per-node skew, paper
    Fig. 3/4 show per-station class imbalance)."""
    rng = np.random.default_rng(seed)
    d = image_dim * image_dim
    # fixed random class templates (shared across nodes via fixed seed 1234)
    trng = np.random.default_rng(1234)
    templates = trng.normal(0, 1, size=(num_classes, d)).astype(np.float32)
    pool = np.asarray(classes if classes is not None
                      else range(num_classes))
    y = pool[rng.integers(0, len(pool), size=n)].astype(np.int32)
    noise_arr = rng.normal(0, noise, size=(n, d)).astype(np.float32)
    x = templates[y] + noise_arr
    return Dataset(x=x, y=y, features=_cnd_features(x))


def synthetic_bird(seed: int, n: int, num_classes: int = 5,
                   image_size: int = 32, channels: int = 3,
                   noise: float = 0.5,
                   classes: list | None = None) -> Dataset:
    """Class-template color images (BIRD-400 stand-in, reduced 32x32)."""
    rng = np.random.default_rng(seed)
    shape = (image_size, image_size, channels)
    trng = np.random.default_rng(4321)
    templates = trng.normal(0, 1, size=(num_classes,) + shape
                            ).astype(np.float32)
    pool = np.asarray(classes if classes is not None
                      else range(num_classes))
    y = pool[rng.integers(0, len(pool), size=n)].astype(np.int32)
    noise_arr = rng.normal(0, noise, size=(n,) + shape).astype(np.float32)
    x = templates[y] + noise_arr
    return Dataset(x=x, y=y, features=_cnd_features(x))


def token_lm(seed: int, n_seqs: int, seq_len: int,
             vocab: int = 512) -> Dataset:
    """Zipf-ish synthetic token sequences for LM federated training."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1)
    probs = (1.0 / ranks) / (1.0 / ranks).sum()
    x = rng.choice(vocab, size=(n_seqs, seq_len + 1), p=probs
                   ).astype(np.int32)
    y = np.zeros(n_seqs, np.int32)
    # CND features: leading token 4-grams, hashed
    feats = (x[:, :16] * np.int32(31) + np.roll(x[:, :16], 1, axis=1)
             ).astype(np.int32)
    return Dataset(x=x, y=y, features=feats)
