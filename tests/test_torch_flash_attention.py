"""Kernel B9 ``flash_attention``: the port's plain version against the JAX
package's Pallas kernel in interpret mode and its reference ``attend``, on
the CPU.

The cases are those of tests/test_kernels.py (the causal sweep over MHA,
GQA 2:1, MQA and a wide head in f32 and bf16; sliding windows 32/64/128;
non-causal Sq=128 Sk=256) at that file's tolerances (2e-5 f32, 2e-2
bf16), plus ragged lengths, which the Pallas kernel's block asserts
refuse, against ``repro.models.attention.attend``, and rows with no live
key. Inputs are made with numpy. The CUDA kernel itself runs only on the
card (``chip_smoke.py``); here its wrapper's checks run up to the launch,
a torch emulation of the bf16 kernel's arithmetic (p passed to the p.v
product as two bf16 terms) is held to the card's one-ulp gate, and one of
the f32 kernel's (its key tiles, exp2 fold and order of the denominator's
partial sums) to the Pallas kernel and ``attend`` at 2e-5, with the Python
twin of its block order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import attention as jattention
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattention

_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return 2e-2 if dtype == "bf16" else 2e-5


def _qkv(b, sq, sk, h, kv, d, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]
    jdt, tdt = _DT[dtype]
    # both sides see the same values: round to the dtype once, on the JAX
    # side, and hand the rounded numbers across
    jx = [jnp.asarray(a).astype(jdt) for a in arrs]
    tx = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(tdt) for a in jx]
    return jx, tx


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# tests/test_kernels.py::test_flash_attention_sweep
@pytest.mark.parametrize("b,sq,sk,h,kv,d", [
    (1, 128, 128, 2, 2, 64),     # MHA
    (2, 256, 256, 4, 2, 64),     # GQA 2:1
    (1, 128, 128, 8, 1, 32),     # MQA
    (1, 512, 512, 2, 2, 128),    # long, wide head
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_b9_matches_pallas_sweep(b, sq, sk, h, kv, d, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(b, sq, sk, h, kv, d, dtype, sq + h)
    pallas = pallas_flash(jq, jk, jv, causal=True, window=None, block_q=64,
                          block_k=64, interpret=True)
    got = ref.flash_attention(q, k, v, causal=True, window=None)
    assert got.dtype == q.dtype and tuple(got.shape) == (b, sq, h, d)
    _close(got, pallas, _tol(dtype))
    _close(got, jref.flash_attention(jq, jk, jv, causal=True, window=None),
           _tol(dtype))


# tests/test_kernels.py::test_flash_attention_sliding_window
@pytest.mark.parametrize("window", [32, 64, 128])
def test_plain_b9_matches_pallas_sliding_window(window):
    (jq, jk, jv), (q, k, v) = _qkv(1, 256, 256, 2, 2, 64, "f32", window)
    pallas = pallas_flash(jq, jk, jv, causal=True, window=window, block_q=64,
                          block_k=64, interpret=True)
    _close(ref.flash_attention(q, k, v, causal=True, window=window), pallas,
           2e-5)


# tests/test_kernels.py::test_flash_attention_non_square_blocks
def test_plain_b9_matches_pallas_non_causal_cross():
    (jq, jk, jv), (q, k, v) = _qkv(1, 128, 256, 2, 2, 64, "f32", 0)
    pallas = pallas_flash(jq, jk, jv, causal=False, window=None, block_q=32,
                          block_k=128, interpret=True)
    _close(ref.flash_attention(q, k, v, causal=False, window=None), pallas,
           2e-5)


@pytest.mark.parametrize("window,dtype", [(None, "f32"), (24, "f32"),
                                          (None, "bf16")])
def test_plain_b9_ragged_lengths_match_attend(window, dtype):
    """Sq = Sk = 100, GQA 2:1: lengths the Pallas kernel's block asserts
    refuse and the CUDA kernel takes."""
    (jq, jk, jv), (q, k, v) = _qkv(2, 100, 100, 4, 2, 64, dtype, 100)
    want = jattention.attend(jq, jk, jv, causal=True, window=window)
    _close(ops.flash_attention(q, k, v, causal=True, window=window), want,
           _tol(dtype))


def test_rows_without_a_live_key_average_v_as_the_pallas_kernel_does():
    """Causal with a window and Sk < Sq: queries past Sk + window - 1 see
    no live key. The Pallas kernel's -1e30 scores make every probability
    exactly 1 until a live key arrives, so such a row is the uniform
    average of v over all keys, as in ``attend``; B9 on the card gives the
    same (chip_smoke.py checks it)."""
    (jq, jk, jv), (q, k, v) = _qkv(1, 128, 64, 2, 1, 32, "f32", 7)
    pallas = pallas_flash(jq, jk, jv, causal=True, window=16, block_q=32,
                          block_k=32, interpret=True)
    got = ref.flash_attention(q, k, v, causal=True, window=16)
    _close(got, pallas, 2e-5)
    dead = got[0, 100:, 0]                       # rows 79.. have no key
    mean_v = v[0, :, 0].mean(dim=0)
    np.testing.assert_allclose(dead.numpy(),
                               mean_v.expand_as(dead).numpy(), atol=2e-6)


def test_ops_dispatch_cpu_to_attend_and_refuse_other_devices():
    _, (q, k, v) = _qkv(1, 16, 16, 4, 2, 32, "f32", 3)
    before = tfa.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=True, window=None)
    assert torch.equal(got, tattention.attend(q, k, v, causal=True,
                                              window=None))
    meta = torch.empty((1, 16, 4, 32), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.flash_attention(meta, meta[:, :, :2], meta[:, :, :2])
    assert tfa.flash_attention.launches == before


def test_wrapper_refuses_inputs_that_require_grad():
    """No backward kernel exists (nor in the JAX package), so the wrapper
    refuses a tensor that requires grad before it looks at the device."""
    _, (q, k, v) = _qkv(1, 16, 16, 2, 2, 32, "f32", 4)
    before = tfa.flash_attention.launches
    for i in range(3):
        args = [q, k, v]
        args[i] = args[i].clone().requires_grad_(True)
        with pytest.raises(ValueError, match="no backward"):
            tfa.flash_attention(*args)
    with pytest.raises(ValueError, match="CUDA kernel got a tensor on cpu"):
        tfa.flash_attention(q, k, v)
    assert tfa.flash_attention.launches == before


@pytest.mark.parametrize("bad,msg", [
    ("q3d", "must be \\(B, S, H, D\\)"), ("kv_shape", "must be"),
    ("heads", "multiple of KV"), ("d48", "head dim 48"),
    ("f16", "not supported"), ("mixed", "dtypes differ"),
    ("window0", "window must be"),
])
def test_wrapper_checks_before_launch(bad, msg, monkeypatch):
    """With the device check passed, every malformed call raises on its
    shape, dtype or window before any launch."""
    monkeypatch.setattr(tfa, "_check_cuda", lambda *t: t[0].device)
    q, k = torch.zeros((1, 8, 4, 32)), torch.zeros((1, 8, 2, 32))
    args, kw = [q, k, k.clone()], {}
    if bad == "q3d":
        args[0] = torch.zeros((8, 4, 32))
    elif bad == "kv_shape":
        args[2] = torch.zeros((1, 9, 2, 32))
    elif bad == "heads":
        args[1] = args[2] = torch.zeros((1, 8, 3, 32))
    elif bad == "d48":
        args = [torch.zeros((1, 8, 4, 48)), torch.zeros((1, 8, 2, 48)),
                torch.zeros((1, 8, 2, 48))]
    elif bad == "f16":
        args = [a.half() for a in args]
    elif bad == "mixed":
        args[2] = args[2].to(torch.bfloat16)
    elif bad == "window0":
        kw["window"] = 0
    before = tfa.flash_attention.launches
    with pytest.raises(ValueError, match=msg):
        tfa.flash_attention(*args, **kw)
    assert tfa.flash_attention.launches == before


# -- the bf16 kernel's arithmetic, emulated ---------------------------------
# On the card the bf16 kernel multiplies p by v on the tensor cores, which
# take p in bf16. It splits p into two bf16 terms, p_hi = bf16(p) and
# p_lo = bf16(p - p_hi), and adds both products into one f32 accumulator.
# chip_smoke.py holds bf16 B9 to one bf16 ulp of the f32 plain version where
# |value| >= 2**-7 (one ulp + 2e-5 below). The emulation below repeats the
# kernel's steps in torch on the CPU (key tiles of 64, online softmax in
# f32 with exp2 and scale * log2 e folded in, l summed per quad lane and
# the four partial sums added at the end, the f32 accumulator rescaled by
# alpha, bf16 output) and shows that the split keeps that gate and a p
# rounded once to bf16 does not. These tests pin that numerical argument;
# they run none of the CUDA kernel, which only chip_smoke.py checks.

def _emulate_bf16_kernel(q, k, v, *, causal, window, split, tile=64):
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qf = q.float().permute(0, 2, 1, 3)                       # (B, H, Sq, D)
    kf = k.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    qp = torch.arange(sq)[:, None]
    scale_log2 = torch.tensor(d ** -0.5, dtype=torch.float32) * torch.tensor(
        1.4426950408889634, dtype=torch.float32)
    m = torch.full((b, h, sq, 1), -torch.inf)
    l = torch.zeros((b, h, sq, 4))          # one share per lane of a quad
    o = torch.zeros((b, h, sq, d))
    for k0 in range(0, sk, tile):
        kp = torch.arange(k0, min(k0 + tile, sk))[None, :]
        live = torch.ones((sq, kp.shape[1]), dtype=torch.bool)
        if causal:
            live &= kp <= qp
        if window is not None:
            live &= kp > qp - window
        s = qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2)
        s = torch.where(live, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
        alpha = torch.exp2((m - m_use) * scale_log2)
        p = torch.exp2(s * scale_log2 - m_use * scale_log2)
        # lane t of a quad holds the columns 8i + 2t and 8i + 2t + 1
        width = p.shape[-1]
        pad = torch.nn.functional.pad(p, (0, tile - width))
        l = l * alpha + pad.view(b, h, sq, tile // 8, 4, 2).sum(dim=(3, 5))
        p_hi = p.to(torch.bfloat16).float()
        pv = p_hi @ vf[:, :, k0:k0 + tile]
        if split:
            p_lo = (p - p_hi).to(torch.bfloat16).float()
            pv = pv + p_lo @ vf[:, :, k0:k0 + tile]
        o = o * alpha + pv
        m = m_new
    l = (l[..., 0:1] + l[..., 1:2]) + (l[..., 2:3] + l[..., 3:4])
    out = o / l.clamp_min(1e-30)
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


def _ulps_over_gate(out, want):
    """(outputs past the card's gate, worst error in ulps where
    |value| >= 2**-7), as chip_smoke.py's check of bf16 B9 counts them:
    one bf16 ulp where |value| >= 2**-7, one ulp + 2e-5 below."""
    diff = (out.float() - want).abs()
    a = want.abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(a)) - 7)
    big = want.abs() >= 2 ** -7
    over = int((diff[big] > ulp[big]).sum()) + int(
        (diff[~big] > ulp[~big] + 2e-5).sum())
    return over, (diff / ulp)[big].max().item()


@pytest.mark.parametrize("b,sq,sk,h,kv,d", [
    (1, 128, 128, 2, 2, 64),     # tests/test_kernels.py's sweep
    (2, 256, 256, 4, 2, 64),
    (1, 128, 128, 8, 1, 32),
    (1, 512, 512, 2, 2, 128),
    (1, 256, 256, 16, 8, 128),   # qwen3-1.7b's heads
])
def test_split_p_keeps_the_one_ulp_gate_and_one_rounding_breaks_it(
        b, sq, sk, h, kv, d):
    _, (q, k, v) = _qkv(b, sq, sk, h, kv, d, "bf16", sq + h + d)
    want = ref.flash_attention(q.float(), k.float(), v.float(), causal=True,
                               window=None)
    split = _emulate_bf16_kernel(q, k, v, causal=True, window=None,
                                 split=True)
    over, worst = _ulps_over_gate(split, want)
    assert over == 0 and worst < 0.6, (over, worst)
    once = _emulate_bf16_kernel(q, k, v, causal=True, window=None,
                                split=False)
    over, worst = _ulps_over_gate(once, want)
    assert over > 0 and worst > 2.0, (over, worst)


@pytest.mark.parametrize("window", [32, 128])
def test_split_p_keeps_the_one_ulp_gate_under_a_window(window):
    """tests/test_kernels.py's sliding windows: tiles that are partly dead,
    and rows whose running max moves from tile to tile."""
    _, (q, k, v) = _qkv(1, 256, 256, 2, 2, 64, "bf16", window)
    want = ref.flash_attention(q.float(), k.float(), v.float(), causal=True,
                               window=window)
    split = _emulate_bf16_kernel(q, k, v, causal=True, window=window,
                                 split=True)
    over, worst = _ulps_over_gate(split, want)
    assert over == 0 and worst < 0.6, (over, worst)


@pytest.mark.parametrize("name", ["q", "k", "v"])
def test_wrapper_refuses_bf16_tensors_off_a_16_byte_boundary(name,
                                                             monkeypatch):
    """TMA reads the bf16 kernel's inputs from 16-byte aligned addresses
    only. A contiguous view that starts one element into its storage is
    refused before any launch; a view 8 elements (16 bytes) in is not."""
    monkeypatch.setattr(tfa, "_check_cuda", lambda *t: t[0].device)
    shapes = {"q": (1, 8, 4, 32), "k": (1, 8, 2, 32), "v": (1, 8, 2, 32)}
    args = {n: torch.zeros(s, dtype=torch.bfloat16)
            for n, s in shapes.items()}
    n = int(np.prod(shapes[name]))
    flat = torch.zeros(n + 8, dtype=torch.bfloat16)
    args[name] = flat[1:1 + n].view(shapes[name])
    assert args[name].is_contiguous() and args[name].storage_offset() == 1
    before = tfa.flash_attention.launches
    with pytest.raises(ValueError, match=f"{name} must be 16-byte aligned"):
        tfa.flash_attention(args["q"], args["k"], args["v"])
    assert tfa.flash_attention.launches == before
    tfa.check_aligned(**{name: flat[8:8 + n].view(shapes[name])})


def test_tma_aligned_copies_only_unaligned_bf16_views():
    """``ops.tma_aligned`` gives B9 an aligned copy, equal in value, of a
    bf16 view one element past a 16-byte boundary; an aligned bf16 view
    and an f32 view pass as they are, a strided view becomes contiguous."""
    flat = torch.arange(1, 1 + 2 * 4 * 32 + 8, dtype=torch.float32)
    flat16 = flat.to(torch.bfloat16)
    view = flat16[1:1 + 2 * 4 * 32].view(2, 4, 32)
    assert view.data_ptr() % 16 == 2
    got = ops.tma_aligned(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
    aligned = flat16[8:8 + 2 * 4 * 32].view(2, 4, 32)
    assert ops.tma_aligned(aligned).data_ptr() == aligned.data_ptr()
    f32 = flat[1:1 + 2 * 4 * 32].view(2, 4, 32)
    assert ops.tma_aligned(f32).data_ptr() == f32.data_ptr()
    strided = torch.arange(2 * 4 * 64).to(torch.bfloat16).view(
        2, 4, 64)[..., ::2]
    got = ops.tma_aligned(strided)
    assert got.is_contiguous() and torch.equal(got, strided)


@pytest.mark.parametrize("name", ["q", "k", "v"])
def test_ops_hands_b9_aligned_copies_of_unaligned_bf16_views(name,
                                                            monkeypatch):
    """The reference's ``ops.flash_attention`` takes any array: the port's
    gives the kernel wrapper, which refuses views off a 16-byte boundary,
    aligned copies of them (the kernel still runs; no plain fallback)."""
    seen = {}

    def kernel(q, k, v, *, causal, window):
        tfa.check_aligned(q=q, k=k, v=v)
        seen.update(q=q, k=k, v=v)
        return torch.zeros_like(q)

    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(ops._fa, "flash_attention", kernel)
    shapes = {"q": (1, 8, 4, 32), "k": (1, 8, 2, 32), "v": (1, 8, 2, 32)}
    args = {n: torch.randn(s).to(torch.bfloat16) for n, s in shapes.items()}
    n = int(np.prod(shapes[name]))
    flat = torch.randn(n + 8).to(torch.bfloat16)
    args[name] = flat[1:1 + n].view(shapes[name])
    ops.flash_attention(args["q"], args["k"], args["v"])
    assert torch.equal(seen[name], args[name])
    assert seen[name].data_ptr() != args[name].data_ptr()


# -- the f32 kernel's arithmetic, emulated ----------------------------------
# On the card the f32 kernel walks the keys in tiles of F32_KEYS for q tiles
# of F32_ROWS flattened (position, head) rows, two q tiles a block. Per key
# tile it takes the raw scores q . k in f32, masks the dead pairs, keeps the
# running max m in raw score units and p = 2^(s * scale * log2 e - m *
# scale * log2 e) (the scale folded into exp2), rescales the accumulator by
# alpha, and adds p . v. A row is shared by L = f32_lanes(D) lanes; lane x
# holds the keys x + L j of a tile and keeps its own share of the
# denominator l, its p added in the order j = 0, 1, ...; the L shares are
# added at the end by a butterfly (xor 1, 2, 4, ..). A row with no live key
# gets the sum of v over all Sk keys over Sk. The emulation below repeats
# those steps in torch on the CPU and is held to the Pallas kernel in
# interpret mode and to ``attend`` at the card's 2e-5 gate; it runs none of
# the CUDA kernel, which chip_smoke.py checks on the card.

def _emulate_f32_kernel(q, k, v, *, causal, window, skip_dead=False):
    """``skip_dead``: leave out, row by row, the key tiles with no live key
    for the row, as the kernel leaves out the key chunks with no live pair
    for a warp's rows; it must change no bit."""
    tile = tfa.F32_KEYS
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g, lanes = h // kvh, tfa.f32_lanes(d)
    qf = q.permute(0, 2, 1, 3)                               # (B, H, Sq, D)
    kf = k.repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    vf = v.repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    qp = torch.arange(sq)[:, None]
    c = torch.tensor(d ** -0.5, dtype=torch.float32) * torch.tensor(
        1.4426950408889634, dtype=torch.float32)
    m = torch.full((b, h, sq, 1), -torch.inf)
    l = torch.zeros((b, h, sq, lanes))      # one share per lane x
    o = torch.zeros((b, h, sq, d))
    for k0 in range(0, sk, tile):
        kp = torch.arange(k0, min(k0 + tile, sk))[None, :]
        live = torch.ones((sq, kp.shape[1]), dtype=torch.bool)
        if causal:
            live &= kp <= qp
        if window is not None:
            live &= kp > qp - window
        s = qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2)
        s = torch.where(live, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
        alpha = torch.exp2((m - m_use) * c)
        p = torch.exp2(s * c + (-m_use * c))
        pad = torch.nn.functional.pad(p, (0, tile - p.shape[-1]))
        pj = pad.view(b, h, sq, tile // lanes, lanes)        # [.., j, x]
        rs = pj[..., 0, :]
        for j in range(1, tile // lanes):
            rs = rs + pj[..., j, :]
        l_new = l * alpha + rs
        o_new = o * alpha + p @ vf[:, :, k0:k0 + tile]
        if skip_dead:
            keep = ~live.any(dim=-1)[None, None, :, None]
            l_new = torch.where(keep, l, l_new)
            o_new = torch.where(keep, o, o_new)
            m_new = torch.where(keep, m, m_new)
        l, o, m = l_new, o_new, m_new
    while l.shape[-1] > 1:                   # the butterfly, as lane 0 sums
        l = l[..., 0::2] + l[..., 1::2]
    lo = (qp - window + 1).clamp_min(0) if window is not None else 0 * qp
    hi = qp.clamp_max(sk - 1) if causal else torch.full_like(qp, sk - 1)
    dead = (lo > hi)[None, None]                             # (1, 1, Sq, 1)
    o = torch.where(dead, vf.sum(dim=2, keepdim=True), o)
    l = torch.where(dead, torch.tensor(float(sk)), l)
    out = o * (1.0 / l.clamp_min(1e-30))
    return out.permute(0, 2, 1, 3)


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window,bq,bk", [
    (1, 128, 128, 2, 2, 64, True, None, 64, 64),    # tests/test_kernels.py
    (2, 256, 256, 4, 2, 64, True, None, 64, 64),
    (1, 128, 128, 8, 1, 32, True, None, 64, 64),
    (1, 512, 512, 2, 2, 128, True, None, 64, 64),
    (1, 256, 256, 2, 2, 64, True, 32, 64, 64),
    (1, 256, 256, 2, 2, 64, True, 64, 64, 64),
    (1, 256, 256, 2, 2, 64, True, 128, 64, 64),
    (1, 128, 256, 2, 2, 64, False, None, 32, 128),
])
def test_f32_kernel_arithmetic_matches_pallas(b, sq, sk, h, kv, d, causal,
                                              window, bq, bk):
    (jq, jk, jv), (q, k, v) = _qkv(b, sq, sk, h, kv, d, "f32",
                                   sq + h + d + (window or 0))
    pallas = pallas_flash(jq, jk, jv, causal=causal, window=window,
                          block_q=bq, block_k=bk, interpret=True)
    got = _emulate_f32_kernel(q, k, v, causal=causal, window=window)
    _close(got, pallas, 2e-5)


_T, _R = tfa.F32_KEYS, tfa.F32_ROWS


@pytest.mark.parametrize("sq,sk,h,kv,d,causal,window", [
    (_T - 1, _T - 1, 4, 2, 64, True, None),          # key tile edges, GQA 2:1
    (_T + 1, _T + 1, 4, 2, 64, True, None),
    (2 * _T + 1, 2 * _T + 1, 4, 2, 32, True, None),   # 8 lanes a row
    (2 * _T + 1, 2 * _T + 1, 8, 2, 128, True, None),  # GQA 4:1
    (_R // 2 + 1, _R // 2 + 1, 4, 2, 64, True, None),  # one past a q tile
    (3 * _R // 2, 3 * _R // 2, 4, 2, 64, True, None),  # 3 q tiles: one alone
    (_R + 1, _R + 1, 6, 2, 64, True, None),          # G = 3
    (100, 100, 4, 2, 64, True, 20),                  # window starts mid-tile
    (2 * _T + 1, 2 * _T + 1, 4, 4, 32, True, _T + 3),
    (128, 64, 2, 1, 32, True, 16),                   # rows with no live key
    (_T + 1, 2 * _T + 1, 4, 2, 64, False, None),     # non-causal Sq < Sk
    (_T - 1, 3 * _T + 5, 8, 1, 32, False, 24),       # non-causal window, MQA
])
def test_f32_kernel_arithmetic_matches_attend_on_tile_edges(sq, sk, h, kv,
                                                            d, causal,
                                                            window):
    (jq, jk, jv), (q, k, v) = _qkv(2, sq, sk, h, kv, d, "f32", sq * sk + h)
    want = jattention.attend(jq, jk, jv, causal=causal, window=window)
    got = _emulate_f32_kernel(q, k, v, causal=causal, window=window)
    _close(got, want, 2e-5)
    skipped = _emulate_f32_kernel(q, k, v, causal=causal, window=window,
                                  skip_dead=True)
    assert torch.equal(skipped, got)


@pytest.mark.parametrize("b,sq,h,kv", [
    (4, 128, 16, 8), (1, 1, 2, 2), (2, 33, 6, 2), (3, 100, 16, 1),
    (1, 17, 64, 1), (2, 500, 4, 4), (1, 48, 4, 2),
])
def test_f32_block_order_pairs_every_q_tile_once(b, sq, h, kv):
    """The f32 kernel's grid formula (its Python twin): each block owns
    q tiles p and nt - 1 - p of one (batch, kv head), so every q tile of
    every (batch, kv head) is owned once, and a causal block's work (the
    keys its rows reach) is about the same in every block."""
    blocks = tfa.f32_blocks(b, sq, h, kv)
    g = h // kv
    nt = -(-sq * g // tfa.F32_ROWS)
    owned = sorted((bb, kk, t) for bb, kk, ta, tb in blocks
                   for t in sorted({ta, tb}))
    assert owned == [(bb, kk, t) for bb in range(b) for kk in range(kv)
                     for t in range(nt)]
    assert all(ta <= tb and ta + tb == nt - 1 for _, _, ta, tb in blocks)
    # the tiles of one (batch, kv head) hold each of its flattened rows R
    # (position R // G of query head kv head * G + R % G) once
    for bb in range(b):
        for kk in range(kv):
            rows = sorted(r for b2, k2, ta, tb in blocks if (b2, k2) == (bb, kk)
                          for t in sorted({ta, tb})
                          for r in range(t * tfa.F32_ROWS,
                                         min((t + 1) * tfa.F32_ROWS, sq * g)))
            assert rows == list(range(sq * g))
            assert sorted((r // g, kk * g + r % g) for r in rows) == [
                (pos, kk * g + j) for pos in range(sq) for j in range(g)]
    # causal: keys a block's rows reach, summed over its two tiles; blocks
    # of a full pair differ by at most one q tile's width in positions
    reach = [sum(min(sq, (t + 1) * tfa.F32_ROWS // g) for t in {ta, tb})
             for _, _, ta, tb in blocks if ta < tb]
    if reach:
        assert max(reach) - min(reach) <= tfa.F32_ROWS // g + 1


def test_wrapper_counts_f32_and_bf16_launches_apart(monkeypatch):
    """``launches`` keeps the total; ``launches_f32`` and
    ``launches_bf16`` split it by dtype (a stand-in library replaces the
    CUDA one, so the count runs on the CPU)."""
    class Lib:
        def __getattr__(self, fn):
            return lambda *args: 0

    monkeypatch.setattr(tfa, "_check_cuda", lambda *t: t[0].device)
    monkeypatch.setattr(tfa, "_stream", lambda dev: 0)
    monkeypatch.setattr(tfa._build, "library", lambda name: Lib())
    before = (tfa.flash_attention.launches, tfa.flash_attention.launches_f32,
              tfa.flash_attention.launches_bf16)
    q, k = torch.zeros((1, 8, 4, 32)), torch.zeros((1, 8, 2, 32))
    tfa.flash_attention(q, k, k)
    tfa.flash_attention(q, k, k)
    tfa.flash_attention(q.bfloat16(), k.bfloat16(), k.bfloat16())
    after = (tfa.flash_attention.launches, tfa.flash_attention.launches_f32,
             tfa.flash_attention.launches_bf16)
    assert [a - b for a, b in zip(after, before)] == [3, 2, 1]
