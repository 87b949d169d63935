"""Deterministic vehicle kinematics: position traces over federated rounds.

A copy of the JAX package's ``repro/mobility/traces.py`` (numpy only):
the same seeds give identical arrays in both packages.

Every generator returns a float32 ``(R, K, 2)`` array of xy positions in
meters — one snapshot per federated round — produced with host numpy from
a seeded ``default_rng``. Traces are pure functions of their arguments,
so the per-round communication graphs (repro_torch.mobility.links) and mixing
stacks derived from them are reproducible across processes: benchmarks
and tests regenerate them instead of shipping arrays around.

Three canonical vehicular scenarios (Elbir et al., arXiv:2006.01412):

* :func:`platoon_trace` — highway platoon: vehicles strung along a road
  with per-vehicle speed spread, so gaps drift apart over time — the
  split/merge + sparse-highway-partition scenario.
* :func:`manhattan_trace` — Manhattan grid: vehicles drive street
  segments of a ``block``-spaced grid and turn at intersections — the
  intersection-crossing / urban-canyon churn scenario.
* :func:`waypoint_trace` — random waypoint over a square area — the
  classical mobility-model baseline (uniformly mixing contact pattern).
"""
from __future__ import annotations

import numpy as np

from repro_torch.registry import mobility_traces


def _rng(seed: int, tag: str) -> np.random.Generator:
    """Seeded generator, decorrelated per scenario kind (crc32 of the
    tag, not ``hash`` — string hashing is salted per process)."""
    import zlib
    return np.random.default_rng(
        np.random.SeedSequence([seed, zlib.crc32(tag.encode())]))


def platoon_trace(rounds: int, k: int, *, speed: float = 20.0,
                  speed_jitter: float = 0.3, headway: float = 100.0,
                  lanes: int = 2, lane_gap: float = 4.0, dt: float = 1.0,
                  seed: int = 0) -> np.ndarray:
    """Highway platoon: K vehicles spaced ``headway`` apart along x,
    each holding a constant per-vehicle speed ~ N(speed, jitter*speed).

    Relative drift between vehicles is (v_i - v_j) * t: fast vehicles
    pull away, so radio links across the growing gaps drop — platoon
    split — while vehicles at similar speeds keep a connected cluster.
    """
    rng = _rng(seed, "platoon")
    v = speed * (1.0 + speed_jitter * rng.standard_normal(k))
    v = np.maximum(v, 0.1 * speed)                    # no reversing trucks
    x0 = -headway * np.arange(k, dtype=np.float64)
    y = lane_gap * (np.arange(k) % max(lanes, 1))
    t = dt * np.arange(rounds, dtype=np.float64)
    pos = np.empty((rounds, k, 2), np.float32)
    pos[:, :, 0] = (x0[None, :] + t[:, None] * v[None, :]).astype(np.float32)
    pos[:, :, 1] = y[None, :].astype(np.float32)
    return pos


# Manhattan headings: +x, -x, +y, -y.
_HEADINGS = np.asarray([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]])
_TURN_PROB = 0.5          # probability of turning at an intersection


def manhattan_trace(rounds: int, k: int, *, speed: float = 15.0,
                    area: float = 1000.0, block: float = 200.0,
                    dt: float = 1.0, seed: int = 0) -> np.ndarray:
    """Manhattan grid: vehicles start at random intersections of a
    ``block``-spaced street grid and drive along streets, choosing a
    random turn (prob. ``_TURN_PROB``, never a U-turn) each time they
    cross an intersection. Positions wrap around the ``area`` torus so
    density stays constant."""
    rng = _rng(seed, "manhattan")
    n_int = max(int(area // block), 1)
    pos = np.empty((rounds, k, 2), np.float32)
    p = block * rng.integers(0, n_int, size=(k, 2)).astype(np.float64)
    h = rng.integers(0, 4, size=k)
    for r in range(rounds):
        pos[r] = p.astype(np.float32)
        step = speed * dt
        # distance to the next intersection along the current heading
        along = np.where(_HEADINGS[h][:, 0] != 0, p[:, 0], p[:, 1])
        to_next = block - np.mod(along, block)
        for i in range(k):
            left = step
            while left > 0:
                d = min(left, to_next[i])
                p[i] += _HEADINGS[h[i]] * d
                left -= d
                to_next[i] -= d
                if to_next[i] <= 1e-9:                 # at an intersection
                    to_next[i] = block
                    if rng.random() < _TURN_PROB:
                        # turn onto the cross street (no U-turn)
                        h[i] = rng.choice([2, 3] if h[i] < 2 else [0, 1])
        p = np.mod(p, area)
    return pos


def waypoint_trace(rounds: int, k: int, *, speed: float = 20.0,
                   area: float = 1000.0, dt: float = 1.0,
                   seed: int = 0) -> np.ndarray:
    """Random waypoint: each vehicle moves at ``speed`` toward a uniform
    random target in the ``area`` square, drawing a new target on
    arrival."""
    rng = _rng(seed, "waypoint")
    p = area * rng.random((k, 2))
    target = area * rng.random((k, 2))
    pos = np.empty((rounds, k, 2), np.float32)
    for r in range(rounds):
        pos[r] = p.astype(np.float32)
        left = np.full(k, speed * dt)
        for i in range(k):
            while left[i] > 0:
                d = target[i] - p[i]
                dist = float(np.hypot(d[0], d[1]))
                if dist <= left[i]:
                    p[i] = target[i]
                    left[i] -= dist
                    target[i] = area * rng.random(2)
                else:
                    p[i] += d / dist * left[i]
                    left[i] = 0.0
    return pos


mobility_traces.register("platoon", platoon_trace)
mobility_traces.register("manhattan", manhattan_trace)
mobility_traces.register("waypoint", waypoint_trace)


def trace(kind: str, rounds: int, k: int, **kw) -> np.ndarray:
    """Dispatch on scenario kind — a ``repro_torch.registry.mobility_traces``
    plugin lookup. ``kw`` is forwarded to the generator (unknown keys
    for that generator are dropped, so one MobilityConfig drives any
    registered trace)."""
    fn = mobility_traces.get(kind)
    import inspect
    allowed = set(inspect.signature(fn).parameters)
    return fn(rounds, k, **{kk: v for kk, v in kw.items() if kk in allowed})
