"""Kernel B7 ``robust_agg`` of the port against the JAX package: the plain
version (the CPU path of ``ops.robust_agg``) against ``robust_agg_xla``,
the Pallas kernel in interpret mode and a numpy oracle, at the 1e-5 of
tests/test_faults.py, over that test's sweep; the column chunking; the
position weights; ``robust_exchange`` with an isolated row; and the checks
the CUDA wrapper makes before it launches. The CUDA kernel runs only on the
card (``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.faults.robust import robust_exchange as j_robust_exchange
from repro.faults.robust import sorted_weights as j_sorted_weights
from repro.kernels import ops as jops
from repro.kernels.robust_agg import robust_agg_xla
from repro_torch.faults import robust as trobust
from repro_torch.kernels import ops, ref
from repro_torch.kernels import robust_agg as tra

TOL = 1e-5      # tests/test_faults.py:332-337
MODES = [("median", 0), ("trimmed_mean", 1), ("trimmed_mean", 2)]


def _np_robust(mask, buf, sent, mode, trim):
    """The numpy oracle of tests/test_faults.py."""
    k, p = buf.shape
    out = np.zeros((k, p), np.float32)
    for i in range(k):
        cand = [buf[i] if j == i else sent[j] for j in range(k) if mask[i, j]]
        if not cand:
            continue
        c = np.sort(np.stack(cand), axis=0)
        n = len(cand)
        if mode == "median":
            out[i] = (c[(n - 1) // 2] + c[n // 2]) / 2
        else:
            t = trim if n > 2 * trim else 0
            out[i] = c[t:n - t].mean(axis=0)
    return out


def _inputs(k, trim, p=256):
    """The reference test's inputs: density about 0.6, own slot live, one
    drained row."""
    rng = np.random.default_rng(trim * 10 + k)
    buf = rng.normal(size=(k, p)).astype(np.float32)
    sent = rng.normal(size=(k, p)).astype(np.float32)
    mask = (rng.random((k, k)) < 0.6) | np.eye(k, dtype=bool)
    mask[k // 2] = False
    return buf, sent, mask


@pytest.mark.parametrize("mode,trim", MODES)
@pytest.mark.parametrize("k", [3, 8])
def test_plain_robust_agg_matches_reference(mode, trim, k):
    buf, sent, mask = _inputs(k, trim)
    jw = j_sorted_weights(jnp.asarray(mask), mode, trim)
    tmask = torch.tensor(mask).to(torch.float32)
    tw = trobust.sorted_weights(tmask, mode, trim)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    got = ops.robust_agg(tw, tmask, torch.tensor(buf), torch.tensor(sent))
    want = _np_robust(mask, buf, sent, mode, trim)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    jm, jb, js = (jnp.asarray(a) for a in (mask, buf, sent))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(robust_agg_xla(jw, jm, jb, js)),
                               atol=TOL, rtol=0)
    kernel = jops.robust_agg(jw, jm, jb, js, force_kernel=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("chunk", [1, 5 * 16, 16 * 16 * 7])
def test_column_chunks_equal_one_pass(monkeypatch, chunk):
    """Chunking over P (ragged last chunk too) changes nothing beyond the
    summation order of the weighted sum (f32 rounding)."""
    buf, sent, mask = _inputs(16, 1)
    tmask = torch.tensor(mask).to(torch.float32)
    w = trobust.sorted_weights(tmask, "trimmed_mean", 1)
    args = (w, tmask, torch.tensor(buf), torch.tensor(sent))
    whole = ref.robust_agg(*args)
    monkeypatch.setattr(ref, "ROBUST_CHUNK_ELEMS", chunk)
    np.testing.assert_allclose(ref.robust_agg(*args).numpy(), whole.numpy(),
                               atol=1e-6, rtol=0)


def test_non_finite_live_values_are_zeroed_after_the_sort():
    """A live -inf sorts first, +inf and NaN after every finite value; all
    three contribute 0, as in the reference's sort-then-scrub."""
    k, p = 6, 128
    rng = np.random.default_rng(4)
    buf = rng.normal(size=(k, p)).astype(np.float32)
    sent = rng.normal(size=(k, p)).astype(np.float32)
    sent[1, :5] = np.inf
    sent[2, 3:9] = -np.inf
    sent[3, 7:12] = np.nan
    mask = np.ones((k, k), bool)
    jw = j_sorted_weights(jnp.asarray(mask), "trimmed_mean", 1)
    tmask = torch.ones((k, k))
    got = ops.robust_agg(torch.tensor(np.asarray(jw)), tmask,
                         torch.tensor(buf), torch.tensor(sent))
    want = robust_agg_xla(jw, jnp.asarray(mask), jnp.asarray(buf),
                          jnp.asarray(sent))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("mode,trim", MODES)
def test_robust_exchange_matches_reference_with_an_isolated_row(mode, trim):
    rng = np.random.default_rng(5)
    k = 6
    buf = rng.normal(size=(k, 128)).astype(np.float32)
    sent = rng.normal(size=(k, 128)).astype(np.float32)
    eta = rng.random((k, k)).astype(np.float32)
    eta[rng.random((k, k)) < 0.3] = 0.0
    eta[1] = 0.0                           # node 1 heard nobody
    want = j_robust_exchange(jnp.asarray(buf), jnp.asarray(sent),
                             jnp.asarray(eta), 0.4, mode=mode, trim=trim)
    got = trobust.robust_exchange(torch.tensor(buf), torch.tensor(sent),
                                  torch.tensor(eta), torch.tensor(0.4),
                                  mode=mode, trim=trim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    assert torch.equal(got[1], torch.tensor(buf[1]))


def test_sign_flip_neighbor_rejected_by_trimmed_mean():
    """One sign-flipped sender among 5: every coordinate of the trimmed
    mean falls inside the honest value range (tests/test_faults.py:357)."""
    k = 5
    rng = np.random.default_rng(9)
    buf = torch.tensor(rng.normal(size=(k, 64)).astype(np.float32))
    sent = buf.clone()
    sent[2] *= -25.0
    eta = torch.ones((k, k)) - torch.eye(k)
    out = trobust.robust_exchange(buf, sent, eta, 1.0, mode="trimmed_mean",
                                  trim=1)
    lo = torch.clamp_max(buf.min(dim=0).values, 0)
    hi = torch.clamp_min(buf.max(dim=0).values, 0)
    assert (out >= lo[None] - 1e-5).all() and (out <= hi[None] + 1e-5).all()


def test_unknown_mode_and_negative_trim_are_refused():
    with pytest.raises(ValueError, match="unknown robust mode"):
        trobust.sorted_weights(torch.ones((3, 3)), "krum", 0)

    class Fed:
        robust, trim = "trimmed_mean", -1

    with pytest.raises(ValueError, match="trim must be"):
        trobust.make_robust(Fed())


def test_cuda_wrapper_refuses_cpu_tensors_and_ops_uses_plain_version():
    before = tra.robust_agg.launches
    buf, sent, mask = _inputs(4, 1, p=128)
    tmask = torch.tensor(mask).to(torch.float32)
    w = trobust.sorted_weights(tmask, "median", 0)
    args = (w, tmask, torch.tensor(buf), torch.tensor(sent))
    with pytest.raises(ValueError, match="CUDA kernel"):
        tra.robust_agg(*args)
    assert torch.equal(ops.robust_agg(*args), ref.robust_agg(*args))
    assert tra.robust_agg.launches == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.robust_agg(w, tmask, torch.empty((4, 128), device="meta"),
                       args[3])


def test_wrapper_checks_reject_bad_shapes_before_any_launch():
    w, mask = torch.zeros((4, 4)), torch.zeros((4, 4))
    buf = torch.zeros((4, 256))
    assert tra.check_args(w, mask, buf, buf) == (4, 256)
    with pytest.raises(ValueError, match="multiple of 128"):
        tra.check_args(w, mask, buf[:, :200], buf[:, :200])
    with pytest.raises(ValueError, match="must be"):
        tra.check_args(w[:3], mask, buf, buf)
    with pytest.raises(ValueError, match="sent"):
        tra.check_args(w, mask, buf, buf[:3])
    with pytest.raises(ValueError, match="float32"):
        tra.check_args(w, mask, buf, buf.double())
    big = torch.zeros((1025, 128))
    with pytest.raises(ValueError, match="outside"):
        tra.check_args(torch.zeros((1025, 1025)), torch.zeros((1025, 1025)),
                       big, big)


# -- the CUDA kernel's receiver-group walk, emulated in numpy -------------

def _sort_key(x):
    """csrc/robust_agg.cu::sort_key: a uint32 that sorts like the float,
    NaN last."""
    u = x.view(np.uint32)
    key = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    return np.where(np.isnan(x), np.uint32(0xFFFFFFFF), key).astype(np.uint32)


def _key_value(key):
    u = np.where(key & np.uint32(0x80000000), key & np.uint32(0x7FFFFFFF),
                 ~key)
    return u.astype(np.uint32).view(np.float32)


def _scrub(v):
    return np.where(np.isfinite(v), v, np.float32(0)).astype(np.float32)


def _group_walk(weights, mask, buf, sent):
    """The index arithmetic of ``group_walk_kernel``, vectorised over the
    columns: each column's (key, sender) pairs sorted once; per receiver r
    the walk row of (scrubbed value, live) pairs (r's own sender slot
    cleared, padded to an even length), the branch-free lower bound T of
    r's own key (-1 when the own slot is masked off), then for every slot s

        at = s == T: own_pos = pos; pos += at
        live: acc += W[r, pos] * v; pos += live

    and W[r, own_pos] * scrub(own) after the walk (own_pos = pos when T is
    past the row)."""
    k, p = buf.shape
    kr = k + (k & 1)
    pairs = (_sort_key(sent).astype(np.uint64) << np.uint64(32)) | \
        np.arange(k, dtype=np.uint64)[:, None]
    pairs = np.sort(pairs, axis=0)
    keys = (pairs >> np.uint64(32)).astype(np.uint32)
    sender = (pairs & np.uint64(0xFFFFFFFF)).astype(np.int64)
    vals = _scrub(_key_value(keys))
    cols = np.arange(p)
    w_pad = np.concatenate([weights, np.zeros((k, 1), np.float32)], axis=1)
    out = np.zeros((k, p), np.float32)
    for r in range(k):
        hears = (mask[r] > 0) & (np.arange(k) != r)
        live_rows = np.concatenate([hears[sender],
                                    np.zeros((kr - k, p), bool)])
        val_rows = np.concatenate([vals, np.zeros((kr - k, p), np.float32)])
        own = buf[r]
        own_key = _sort_key(own)
        lo, n = np.zeros(p, np.int64), k
        while n > 1:
            half = n >> 1
            lo = np.where(keys[lo + half, cols] < own_key, lo + half, lo)
            n -= half
        lo = lo + (keys[lo, cols] < own_key)
        own_live = mask[r, r] > 0
        t = lo if own_live else np.full(p, -1)
        pos, own_pos = np.zeros(p, np.int64), np.zeros(p, np.int64)
        acc = np.zeros(p, np.float32)
        for s in range(kr):
            at = t == s
            own_pos = np.where(at, pos, own_pos)
            pos = pos + at
            live = live_rows[s]
            acc = np.where(live, w_pad[r, pos] * val_rows[s] + acc, acc)
            pos = pos + live
        own_pos = np.where(t == kr, pos, own_pos)
        if own_live:
            acc = acc + w_pad[r, own_pos] * _scrub(own)
        out[r] = acc
    return out


def _walk_inputs(k, seed, p=128):
    """Values on a coarse grid in the first half of the columns (ties
    between the own slot and senders, and among senders), live -inf, +inf
    and NaN payloads, an empty row, a row
    whose own slot is masked off, density about 0.6."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(-4, 5, size=(k, p)).astype(np.float32) / 2
    sent = rng.integers(-4, 5, size=(k, p)).astype(np.float32) / 2
    sent[:, p // 2:] += rng.normal(size=(k, p - p // 2)).astype(np.float32)
    if k > 3:
        sent[1, :40] = np.inf
        sent[2, 20:60] = -np.inf
        sent[3, 50:90] = np.nan
        buf[0, 5:15] = -np.inf
    mask = (rng.random((k, k)) < 0.6) | np.eye(k, dtype=bool)
    if k > 1:
        mask[k // 2] = False                 # an empty row
        mask[k - 1, k - 1] = False           # own slot masked off
    return buf, sent, mask


@pytest.mark.parametrize("rule", ["median", "trim1", "trim2", "random"])
@pytest.mark.parametrize("k", [1, 8, 33, 100])
def test_group_walk_emulation_matches_plain_and_xla(k, rule):
    buf, sent, mask = _walk_inputs(k, seed=k * 7 + len(rule))
    tmask = torch.tensor(mask).to(torch.float32)
    if rule == "random":                     # position weights, not a band
        w = np.random.default_rng(k).normal(size=(k, k)).astype(np.float32)
        tw = torch.tensor(w)
    else:
        mode, trim = (("median", 0) if rule == "median"
                      else ("trimmed_mean", int(rule[-1])))
        tw = trobust.sorted_weights(tmask, mode, trim)
    got = _group_walk(tw.numpy(), mask.astype(np.float32), buf, sent)
    assert np.isfinite(got).all()
    plain = ref.robust_agg(tw, tmask, torch.tensor(buf), torch.tensor(sent))
    np.testing.assert_allclose(got, plain.numpy(), atol=TOL, rtol=TOL)
    xla = robust_agg_xla(jnp.asarray(tw.numpy()), jnp.asarray(mask),
                         jnp.asarray(buf), jnp.asarray(sent))
    np.testing.assert_allclose(got, np.asarray(xla), atol=TOL, rtol=TOL)
    if k > 1:
        assert (got[k // 2] == 0).all()     # the empty row


# -- the CUDA kernel's bitonic schedule, emulated -------------------------

THREADS = 256   # csrc/robust_agg.cu::kThreads


def _sort_tile(tile, kp):
    """``sort_columns`` on a tile of columns of kp elements: thread e % 256
    of warp (e % 256) // 32 owns pair e = (column e >> log2(kp/2), pair
    e & (kp/2 - 1)). A stage of a stride of 64 or more has a block barrier
    before and after it; between the others only ``__syncwarp``, so from
    one block barrier to the next every element must stay with one warp."""
    half = kp // 2
    if half == 0:
        return
    lh = half.bit_length() - 1
    owner = {}
    size = 2
    while size <= kp:
        st = size >> 1
        while st > 0:
            if st >= 64:
                owner = {}
            for e in range(half * len(tile)):
                col, j = tile[e >> lh], e & (half - 1)
                lo = 2 * j - (j & (st - 1))
                a, b = col[lo], col[lo + st]
                up = (lo & size) == 0
                col[lo], col[lo + st] = (min(a, b), max(a, b)) if up else \
                    (max(a, b), min(a, b))
                if st < 64:
                    warp = (e % THREADS) // 32
                    for x in (lo, lo + st):
                        assert owner.setdefault((e >> lh, x), warp) == warp
            st >>= 1
        size <<= 1


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 13, 16, 33, 100, 256, 300,
                               1024])
def test_bitonic_schedule_sorts_key_sender_pairs(k):
    """The kernel's sort of (key << 32 | sender) words over a tile of
    columns (padding to a power of two included) ascends every column, and
    its barrier-free stages keep each element to one warp."""
    rng = np.random.default_rng(k)
    kp = 1 << (k - 1).bit_length()
    tc = max(1, min(32, 4096 // kp))
    tile = []
    for _ in range(tc):
        keys = _sort_key(rng.integers(-3, 4, k).astype(np.float32))
        tile.append([int(key) << 32 | i for i, key in enumerate(keys)] +
                    [(1 << 64) - 1] * (kp - k))
    want = [sorted(col) for col in tile]
    _sort_tile(tile, kp)
    assert tile == want
