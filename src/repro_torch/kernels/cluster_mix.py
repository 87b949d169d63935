"""Wrapper of the B6 ``cluster_mix`` CUDA kernel (``csrc/sparse_mix.cu``),
which replaces the Pallas kernel of ``src/repro/kernels/cluster_mix.py``:
the B5 gather with a per-node step size and a separate self payload.

CUDA tensors only (see :mod:`repro_torch.kernels.consensus_mix` for the
conventions). The wrapper counts its launches in its ``launches``
attribute.

A :class:`ClusterPlan` of the index table lets the kernel stage each
receiver group's distinct wire rows once per column tile in shared memory
instead of gathering every slot (the intra tier of hierarchical mixing:
every member of a cluster lists the same co-members). The plan depends on
the indices alone, never on the weights, so any edit of ``val`` (fault
masks, the wire guard) keeps it valid. :func:`plan_stack` builds it on the
host, once per horizon.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.consensus_mix import _check_cuda, _require, _stream
from repro_torch.kernels.sparse_mix import _LIB, _WIRE_SUFFIX, \
    check_gather_args

# distinct wire rows one group stages, 1 KB of each a column tile in
# shared memory (48 KB at 48)
PLAN_MAX_ROWS = 48
PLAN_MAX_MEMBERS = 64            # receivers of one group (slots 8 B each)
_SMEM_LIMIT = 232448             # csrc/sparse_mix.cu kSmemLimit
_TILE_BYTES = 64 * 16            # csrc/sparse_mix.cu kTileVecs vectors
_THREADS = 256                   # csrc/sparse_mix.cu kStagedThreads


class ClusterPlan(NamedTuple):
    """Receiver groups of a (K, D) gather table; leading axes stack rounds
    (``(R, G, M)`` ...) and slice field by field. Group g's receivers
    ``members[g, :counts[g, 0]]`` gather only from the rows
    ``rows[g, :counts[g, 1]]`` (ascending: every slot's row, padding slots
    included, and each member's own row), slot (k, d) reads
    ``rows[g, pos[k, d]]`` = ``idx[k, d]`` and receiver k's own row is
    ``rows[g, own[k]]`` = k."""

    members: torch.Tensor         # (..., G, M) int32 receivers of a group
    rows: torch.Tensor            # (..., G, S) int32 its distinct rows
    counts: torch.Tensor          # (..., G, 2) int32 (members, rows)
    pos: torch.Tensor             # (..., K, D) int32 slot -> place in rows
    own: torch.Tensor             # (..., K) int32 own row -> place in rows


def group_plan(idx: np.ndarray, groups: np.ndarray):
    """One table's plan in numpy: idx (K, D), groups (K,) a label per
    receiver (cluster ids: co-members gather the same rows). A label's
    receivers are taken in ascending order and split where their distinct
    rows (their own included) would exceed ``PLAN_MAX_ROWS`` or their
    count ``PLAN_MAX_MEMBERS``. Returns ``(members, rows, pos, own)``: a
    list of int32 arrays per group, likewise, (K, D) and (K,) int32."""
    idx = np.asarray(idx)
    groups = np.asarray(groups)
    k, d = idx.shape
    own_rows = [set(r) | {rcv} for rcv, r in enumerate(idx.tolist())]
    if max(map(len, own_rows), default=0) > PLAN_MAX_ROWS:
        raise ValueError(f"a receiver gathers more than {PLAN_MAX_ROWS} "
                         f"distinct rows")
    order = np.argsort(groups, kind="stable")
    cuts = np.flatnonzero(np.diff(groups[order])) + 1
    members, rows = [], []
    pos = np.empty((k, d), np.int32)
    own = np.empty(k, np.int32)

    def close(mem):
        mem = np.asarray(mem, np.int64)
        r = np.unique(np.concatenate([idx[mem].ravel(), mem]))
        pos[mem] = np.searchsorted(r, idx[mem])
        own[mem] = np.searchsorted(r, mem)
        members.append(mem.astype(np.int32))
        rows.append(r.astype(np.int32))

    for label in np.split(order, cuts):
        cur, seen = [], set()
        for rcv in label:
            union = seen | own_rows[rcv]
            if cur and (len(union) > PLAN_MAX_ROWS
                        or len(cur) == PLAN_MAX_MEMBERS):
                close(cur)
                cur, union = [], own_rows[rcv]
            cur.append(rcv)
            seen = union
        close(cur)
    return members, rows, pos, own


def plan_stack(idx: np.ndarray, groups: np.ndarray,
               device=None) -> ClusterPlan | None:
    """Per-round plans of idx (R, K, D) under groups (R, K), padded to the
    largest group count, group and row list of the horizon, as one
    :class:`ClusterPlan` of ``(R, ...)`` int32 tensors on ``device``.
    None for a table of ``PLAN_MAX_ROWS`` slots or more: a receiver alone
    could not be staged, and B6 walks its slots instead."""
    idx = np.asarray(idx)
    if idx.shape[-1] >= PLAN_MAX_ROWS:
        return None
    per_round = [group_plan(i, g) for i, g in zip(idx, groups)]
    n_groups = max(len(m) for m, _, _, _ in per_round)
    m_cap = max(len(a) for m, _, _, _ in per_round for a in m)
    s_cap = max(len(a) for _, r, _, _ in per_round for a in r)
    rounds = len(per_round)
    members = np.zeros((rounds, n_groups, m_cap), np.int32)
    rows = np.zeros((rounds, n_groups, s_cap), np.int32)
    counts = np.zeros((rounds, n_groups, 2), np.int32)
    for t, (mem, row, _, _) in enumerate(per_round):
        for g, (m, r) in enumerate(zip(mem, row)):
            members[t, g, :len(m)] = m
            rows[t, g, :len(r)] = r
            counts[t, g] = (len(m), len(r))
    pos = np.stack([p for _, _, p, _ in per_round])
    own = np.stack([o for _, _, _, o in per_round])
    return ClusterPlan(*(torch.as_tensor(a, device=device)
                         for a in (members, rows, counts, pos, own)))


def check_plan(plan: ClusterPlan, k: int, d: int) -> tuple[int, int, int]:
    """Shape, type and shared-memory checks of one round's plan for a (K,
    D) table; returns (groups, M, S)."""
    _require(plan.members.dim() == 2 and plan.rows.dim() == 2,
             "plan must be one round's (G, M) members and (G, S) rows")
    g, m_cap = plan.members.shape
    s_cap = plan.rows.shape[1]
    _require(plan.rows.shape[0] == g and tuple(plan.counts.shape) == (g, 2),
             f"plan rows {tuple(plan.rows.shape)} / counts "
             f"{tuple(plan.counts.shape)} must have {g} groups")
    _require(tuple(plan.pos.shape) == (k, d)
             and tuple(plan.own.shape) == (k,),
             f"plan pos {tuple(plan.pos.shape)} / own "
             f"{tuple(plan.own.shape)} must be ({k}, {d}) / ({k},)")
    _require(all(t.dtype == torch.int32 and t.is_contiguous()
                 for t in plan), "plan tensors must be contiguous int32")
    _require(m_cap <= _THREADS and s_cap <= _THREADS,
             f"plan groups of {m_cap} members and {s_cap} rows exceed the "
             f"kernel's {_THREADS} threads a block")
    smem = (s_cap * _TILE_BYTES + m_cap * ((d + 1) // 2) * 16
            + m_cap * 12 + s_cap * 4)
    _require(smem <= _SMEM_LIMIT,
             f"plan of {s_cap} rows and {m_cap} members needs {smem} "
             f"bytes of shared memory (at most {_SMEM_LIMIT})")
    return g, m_cap, s_cap


def cluster_mix(idx: torch.Tensor, val: torch.Tensor, master: torch.Tensor,
                wself: torch.Tensor, wire: torch.Tensor,
                gamma_node: torch.Tensor, *,
                plan: ClusterPlan | None = None) -> torch.Tensor:
    """``OUT_k = M_k + g[k] * (sum_d val[k,d] W[idx[k,d]] - rowsum_k
    WSELF_k)``.

    As :func:`repro_torch.kernels.sparse_mix.sparse_mix`, plus wself
    (K, P) of the wire's dtype and gamma_node (K,) f32. ``plan``, one
    round's :class:`ClusterPlan` of ``idx``, selects the staged walk."""
    dev = _check_cuda(idx, val, master, wself, wire, gamma_node)
    k, d, p = check_gather_args(idx, val, master, wire)
    _require(wself.shape == wire.shape and wself.dtype == wire.dtype,
             f"wself {tuple(wself.shape)} {wself.dtype} must match the "
             f"wire {tuple(wire.shape)} {wire.dtype}")
    _require(gamma_node.shape == (k,) and gamma_node.dtype == torch.float32,
             f"gamma_node must be ({k},) float32")
    if plan is None:
        ptrs, dims = (None,) * len(ClusterPlan._fields), (0, 0, 0)
    else:
        _check_cuda(*plan)
        dims = check_plan(plan, k, d)
        ptrs = tuple(t.data_ptr() for t in plan)
    fn = f"repro_cluster_mix_{_WIRE_SUFFIX[wire.dtype]}"
    out = torch.empty_like(master)
    lib = _build.library(_LIB)
    code = getattr(lib, fn)(idx.data_ptr(), val.data_ptr(),
                            master.data_ptr(), wself.data_ptr(),
                            wire.data_ptr(), gamma_node.data_ptr(),
                            out.data_ptr(), *ptrs, k, d, p, *dims,
                            _stream(dev))
    cluster_mix.launches += 1
    _build.check(_LIB, fn, code)
    return out


cluster_mix.launches = 0
