"""The receiver-group plan of kernel B6 (``kernels/cluster_mix.py``) and a
numpy emulation of the staged walk it drives (``csrc/sparse_mix.cu``):
the groups partition the receivers, every slot and every receiver's own
row resolve through the plan, weight edits (fault masks, the wire guard)
keep the plan, and the emulation (rows staged from the plan, slots in
slot order, f32 fma) agrees with the plain ``ref.cluster_mix`` at the
card's rtol 1e-5 / atol 1e-6 on a small hierarchical stack and on the
K=1024 Manhattan fleet's round-0 intra table. The CUDA kernel runs only on
the card (``chip_smoke.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import MobilityConfig
from repro_torch.core.cdfl import round_slice
from repro_torch.faults import models as faults
from repro_torch.hierarchy import mixing as hier
from repro_torch.kernels import cluster_mix as clm
from repro_torch.kernels import ref
from repro_torch.mobility import links, traces

RTOL, ATOL = 1e-5, 1e-6      # chip_smoke.py's B6 gate
FLEET_K = 1024


def _random_geometry(rng, k, rounds, density=0.5):
    pos = rng.uniform(0, 60, size=(rounds, k, 2)).astype(np.float32)
    adj = (rng.random((rounds, k, k)) < density).astype(np.float32)
    adj = adj * adj.transpose(0, 2, 1)
    adj[:, np.eye(k, dtype=bool)] = 0.0
    return adj, pos


def _small_stack(rounds=3, k=14):
    rng = np.random.default_rng(3)
    adj, pos = _random_geometry(rng, k, rounds)
    geo = hier.hier_geometry(adj, pos, max_cluster_size=5,
                             leader_policy="degree", inter_degree=2)
    side = dict(ratios=torch.tensor(rng.uniform(0.2, 1.0, k),
                                    dtype=torch.float32),
                sizes=torch.tensor(rng.uniform(20, 200, k),
                                   dtype=torch.float32))
    return hier.build_hier_stacks(geo, rule="cnd", gamma_cap=0.5, **side)


@pytest.fixture(scope="module")
def fleet_round0():
    """Round 0 of the K=1024 Manhattan fleet (benchmarks/paper_tables.py's
    scenario, chip_smoke.py's fleet): hier_geometry's intra table and its
    clusters."""
    mob = MobilityConfig(kind="manhattan", speed=10.0, radio_range=500.0,
                         area=800.0, dt=2.0, seed=0)
    pos = traces.trace(mob.kind, 1, FLEET_K, speed=mob.speed,
                       speed_jitter=mob.speed_jitter, area=mob.area,
                       dt=mob.dt, seed=mob.seed)
    adj = links.radio_adjacency(pos, mob.radio_range,
                                link_quality=mob.link_quality,
                                min_quality=mob.min_quality)
    cluster, _, _, idx, w, _, _ = hier.hier_geometry(
        adj, pos, max_cluster_size=16, leader_policy="degree",
        inter_degree=4)
    return cluster[0], idx[0], w[0]


def _tables(fleet_round0):
    h, _ = _small_stack()
    small = [(h.cluster[r].numpy(), h.intra.idx[r].numpy(),
              h.intra.val[r].numpy()) for r in range(h.cluster.shape[0])]
    return {"small": small, "fleet": [fleet_round0]}


def _plan(cluster, idx):
    return round_slice(clm.plan_stack(idx[None], cluster[None], "cpu"), 0)


def _fma(a, b, c):
    """f32 fmaf through f64: the product of two f32 is exact in f64."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def staged_walk(idx, val, master, wself, wire, gamma, plan):
    """The staged walk's arithmetic in numpy: each group's rows staged from
    the plan, each member's slots read through ``pos`` in slot order with
    one fma a slot and the row sum beside it, and the self payload (and an
    f32 master) read from the member's own staged row where they are the
    wire's buffer. Columns are independent, so the tiles are not cut."""
    members, rows, counts, pos, own = (t.numpy() for t in plan)
    w32 = wire.float().numpy()
    ms, ws32 = master.numpy(), wself.float().numpy()
    g32, v32 = gamma.numpy(), val.numpy()
    out = np.full_like(ms, np.nan)
    for g, (n_mem, n_rows) in enumerate(counts):
        mem = members[g, :n_mem]
        stage = w32[rows[g, :n_rows]]
        acc = np.zeros((n_mem, ms.shape[1]), np.float32)
        row = np.zeros(n_mem, np.float32)
        for e in range(idx.shape[1]):
            a = v32[mem, e]
            row = row + a
            acc = _fma(a[:, None], stage[pos[mem, e]], acc)
        ws = stage[own[mem]] if wself is wire else ws32[mem]
        mv = stage[own[mem]] if master is wire else ms[mem]
        out[mem] = mv + g32[mem, None] * (acc - row[:, None] * ws)
    return out


@pytest.mark.parametrize("which", ["small", "fleet"])
def test_groups_partition_receivers_and_slots_resolve(which, fleet_round0):
    for cluster, idx, _ in _tables(fleet_round0)[which]:
        plan = _plan(cluster, idx)
        members, rows, counts, pos, own = (t.numpy() for t in plan)
        assert all(t.dtype == torch.int32 for t in plan)
        got = np.concatenate([members[g, :n] for g, (n, _) in
                              enumerate(counts)])
        np.testing.assert_array_equal(np.sort(got), np.arange(len(idx)))
        for g, (n_mem, n_rows) in enumerate(counts):
            mem, r = members[g, :n_mem], rows[g, :n_rows]
            assert (np.diff(r) > 0).all()                # ascending, distinct
            np.testing.assert_array_equal(r[pos[mem]], idx[mem])
            np.testing.assert_array_equal(r[own[mem]], mem)
            assert len(set(cluster[mem].tolist())) == 1  # one cluster each
            assert n_rows <= clm.PLAN_MAX_ROWS
            assert n_mem <= clm.PLAN_MAX_MEMBERS


def test_fleet_table_stages_a_quarter_of_its_gathers_or_less(fleet_round0):
    cluster, idx, _ = fleet_round0
    counts = _plan(cluster, idx).counts.numpy()
    k, d = idx.shape
    # rows staged per column tile against the K * Di rows the walk gathers
    assert counts[:, 1].sum() * 4 <= k * d
    assert (counts[:, 0] > 0).sum() == len(np.unique(cluster))


@pytest.mark.parametrize("case", ["rows", "members"])
def test_groups_split_at_the_row_and_member_caps(case):
    rng = np.random.default_rng(0)
    if case == "rows":      # 40 receivers of one label, 300 rows to pick
        idx = rng.integers(0, 300, (40, 6)).astype(np.int32)
    else:                   # 150 receivers of one label, the same 6 rows
        idx = np.tile(np.arange(6, dtype=np.int32), (150, 1))
    members, rows, pos, own = clm.group_plan(idx, np.zeros(len(idx)))
    assert len(members) > 1
    for mem, r in zip(members, rows):
        assert len(mem) <= clm.PLAN_MAX_MEMBERS
        assert len(r) <= clm.PLAN_MAX_ROWS
        np.testing.assert_array_equal(r[pos[mem]], idx[mem])
        np.testing.assert_array_equal(r[own[mem]], mem)
    assert sum(map(len, members)) == len(idx)


def test_a_receiver_wider_than_a_group_is_refused():
    wide = np.arange(2 * clm.PLAN_MAX_ROWS, dtype=np.int32).reshape(2, -1)
    with pytest.raises(ValueError, match="distinct rows"):
        clm.group_plan(wide, np.zeros(2))


def test_plan_stack_pads_rounds_and_skips_wide_tables():
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 30, (3, 30, 4)).astype(np.int32)
    groups = rng.integers(0, 4, (3, 30))
    groups[1] = 0                                    # one round, one group
    plan = clm.plan_stack(idx, groups, "cpu")
    n_groups = [int((c[:, 0] > 0).sum()) for c in plan.counts.numpy()]
    assert plan.members.shape[:2] == (3, max(n_groups)) and n_groups[1] == 1
    assert plan.counts[..., 0].sum(dim=1).tolist() == [30, 30, 30]
    assert tuple(plan.pos.shape) == (3, 30, 4)
    assert tuple(plan.own.shape) == (3, 30)
    wide = np.tile(np.arange(clm.PLAN_MAX_ROWS, dtype=np.int32), (1, 2, 1))
    assert clm.plan_stack(wide, np.zeros((1, 2)), "cpu") is None


def test_check_plan_refuses_mismatched_plans():
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 20, (20, 3)).astype(np.int32)
    plan = _plan(rng.integers(0, 3, 20), idx)
    assert clm.check_plan(plan, 20, 3) == (plan.members.shape[0],
                                           plan.members.shape[1],
                                           plan.rows.shape[1])
    with pytest.raises(ValueError, match="pos"):
        clm.check_plan(plan, 20, 4)
    with pytest.raises(ValueError, match="int32"):
        clm.check_plan(plan._replace(pos=plan.pos.long()), 20, 3)
    with pytest.raises(ValueError, match="groups"):
        clm.check_plan(plan._replace(counts=plan.counts[:1]), 20, 3)
    n_groups = plan.rows.shape[0]
    big = plan._replace(rows=torch.zeros((n_groups, 240), dtype=torch.int32))
    with pytest.raises(ValueError, match="shared memory"):
        clm.check_plan(big, 20, 3)
    crowd = plan._replace(members=torch.zeros((n_groups, 300),
                                               dtype=torch.int32))
    with pytest.raises(ValueError, match="threads"):
        clm.check_plan(crowd, 20, 3)


def test_plan_survives_weight_edits_and_slices():
    h, _ = _small_stack(rounds=4)
    assert isinstance(h.plan, clm.ClusterPlan)
    k = h.cluster.shape[1]
    mask = torch.ones((4, k, k))
    mask[:, 2, :] = 0.0
    mask[:, :, 2] = 0.0
    masked = hier.masked_hier_stack(h, mask)
    assert masked.plan is h.plan
    assert not torch.equal(masked.intra.val, h.intra.val)
    h0 = round_slice(h, 0)
    sent = torch.randn((k, 8))
    sent[h0.intra.idx[0, 0]] = torch.nan
    _, guarded, bad = faults.wire_guard(sent, torch.zeros((k, 8)), h0)
    assert bad.any() and guarded.plan is h0.plan
    for f, full in zip(h0.plan, h.plan):
        assert torch.equal(f, full[0])
    assert round_slice(h._replace(plan=None), 1).plan is None
    const, _ = hier.constant_hier_stacks(h0, 0.5, 3)
    assert tuple(const.plan.pos.shape) == (3,) + tuple(h0.plan.pos.shape)


@pytest.mark.parametrize("which,wire_dtype,separate_self", [
    ("small", torch.float32, False), ("small", torch.bfloat16, False),
    ("small", torch.float32, True), ("small", torch.bfloat16, True),
    ("fleet", torch.float32, False), ("fleet", torch.bfloat16, False)])
def test_staged_walk_emulation_matches_ref(which, wire_dtype, separate_self,
                                          fleet_round0):
    rng = np.random.default_rng(4)
    for cluster, idx, val in _tables(fleet_round0)[which]:
        k, d = idx.shape
        p = 48 if which == "fleet" else 96
        master = torch.tensor(rng.standard_normal((k, p)), dtype=torch.float32)
        wire = master if wire_dtype == torch.float32 else \
            master.to(wire_dtype)
        wself = wire
        if separate_self:
            wire = torch.tensor(rng.standard_normal((k, p)),
                                dtype=torch.float32).to(wire_dtype)
        vt = torch.tensor(val)
        if which == "fleet":      # the table's link weights, row-stochastic
            vt = vt / vt.sum(dim=1, keepdim=True).clamp_min(1e-6)
        gamma = torch.tensor(rng.uniform(0.2, 0.9, k), dtype=torch.float32)
        it = torch.tensor(idx)
        got = staged_walk(it, vt, master, wself, wire, gamma,
                          _plan(cluster, idx))
        want = ref.cluster_mix(it, vt, master, wself, wire, gamma).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_staged_walk_emulation_keeps_nan_of_zero_weight_slots():
    h, _ = _small_stack(rounds=1)
    h0 = round_slice(h, 0)
    idx, val = h0.intra
    zero = (val == 0).nonzero()
    assert len(zero)
    k, e = (int(v) for v in zero[0])
    master = torch.randn((idx.shape[0], 64))
    master[idx[k, e], 5] = torch.nan
    got = staged_walk(idx, val, master, master, master, h0.gamma_node,
                      h0.plan)
    want = ref.cluster_mix(idx, val, master, master, master,
                           h0.gamma_node).numpy()
    assert np.isnan(got[k, 5])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               equal_nan=True)
