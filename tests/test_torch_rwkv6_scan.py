"""Kernel B10 ``rwkv6_scan``: the port's plain version against the JAX
package's Pallas kernel in interpret mode and its model forms, on the CPU.

The Pallas cases are those of tests/test_kernels.py (chunks 16, 32 and 64,
head sizes 64 and 128) at that file's tolerance (2e-3). With an initial
state, the plain version is held to ``repro.models.rwkv.chunked`` (the
same function in another f32 order: 2e-4 absolute, 1e-5 relative, against
|y| up to about 100) and ``scan_reference`` at
tests/test_ssm.py's 5e-4 / 1e-3. Inputs are made with numpy. The CUDA
kernel itself runs only on the card (``chip_smoke.py``); here its
wrapper's checks run up to the launch, and a torch emulation of its
arithmetic order is held to the card's gate (2e-5 of max |value|).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_rwkv6
from repro.models import rwkv as jrwkv
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rwkv6_scan as trw


def _inputs(b, s, h, d, seed, w_kind):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32)
               for _ in range(3))
    z = rng.normal(size=(b, s, h, d))
    if w_kind == "kernel":      # tests/test_kernels.py: sigmoid * 0.9 + 0.05
        w = 0.9 / (1.0 + np.exp(-z)) + 0.05
    else:                       # the model's clamp (tests/test_ssm.py)
        w = np.exp(-np.clip(np.exp(z), 1e-6, jrwkv.MAX_LOG_DECAY))
    u = rng.normal(size=(h, d)) * 0.1
    s0 = rng.normal(size=(b, h, d, d)) * 0.3
    return [a.astype(np.float32) for a in (r, k, v, w, u, s0)]


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=rtol)


# tests/test_kernels.py::test_rwkv6_kernel_sweep
@pytest.mark.parametrize("b,s,h,d,chunk", [
    (1, 64, 1, 64, 16), (2, 128, 3, 64, 32), (1, 256, 2, 128, 64),
])
def test_plain_b10_matches_pallas_sweep(b, s, h, d, chunk):
    r, k, v, w, u, _ = _inputs(b, s, h, d, s + h, "kernel")
    jy, js = pallas_rwkv6(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                          chunk=chunk, interpret=True)
    y, sf = ref.rwkv6_scan(*(torch.tensor(a) for a in (r, k, v, w, u)),
                           chunk=chunk)
    assert y.dtype == sf.dtype == torch.float32
    assert tuple(y.shape) == (b, s, h, d) and tuple(sf.shape) == (b, h, d, d)
    _close(y, jy, 2e-3, 2e-3)
    _close(sf, js, 2e-3, 2e-3)
    ye, se = jref.rwkv6_scan(*(jnp.asarray(a) for a in (r, k, v, w, u)))
    _close(y, ye, 2e-3, 2e-3)
    _close(sf, se, 2e-3, 2e-3)


# tests/test_ssm.py::test_rwkv_chunked_matches_scan, from a non-zero state
@pytest.mark.parametrize("b,s,h,d", [(1, 16, 1, 32), (2, 64, 3, 64),
                                     (1, 128, 2, 16)])
def test_plain_b10_from_a_state_matches_chunked_and_scan(b, s, h, d):
    arrs = _inputs(b, s, h, d, s, "model")
    jarrs = [jnp.asarray(a) for a in arrs]
    y, sf = ref.rwkv6_scan(*(torch.tensor(a) for a in arrs))
    jy, js = jrwkv.chunked(*jarrs)
    _close(y, jy, 2e-4, 1e-5)
    _close(sf, js, 2e-4, 1e-5)
    ry, rs = jrwkv.scan_reference(*jarrs)
    _close(y, ry, 5e-4, 1e-3)
    _close(sf, rs, 5e-4, 1e-3)


def test_plain_b10_bf16_inputs_are_upcast():
    """bf16 r/k/v (as the bf16 model hands them over) give the f32 result
    of the same rounded values: the arithmetic is f32 throughout."""
    r, k, v, w, u, s0 = (torch.tensor(a) for a in
                         _inputs(2, 32, 2, 64, 9, "model"))
    r16, k16, v16 = (t.to(torch.bfloat16) for t in (r, k, v))
    y, sf = ops.rwkv6_scan(r16, k16, v16, w, u, s0=s0, chunk=16)
    want_y, want_s = ref.rwkv6_scan(r16.float(), k16.float(), v16.float(),
                                    w, u, s0)
    assert y.dtype == torch.float32
    assert torch.equal(y, want_y) and torch.equal(sf, want_s)


def test_ops_dispatch_cpu_to_the_plain_version():
    r, k, v, w, u, s0 = (torch.tensor(a) for a in
                         _inputs(1, 32, 2, 32, 3, "model"))
    before = trw.rwkv6_scan.launches
    for state in (None, s0):
        got = ops.rwkv6_scan(r, k, v, w, u, s0=state, chunk=16)
        want = ref.rwkv6_scan(r, k, v, w, u, state, chunk=16)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    meta = torch.empty((1, 16, 2, 32), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.rwkv6_scan(meta, meta, meta, meta, meta[0, 0])
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ref.rwkv6_scan(r[:, :24], k[:, :24], v[:, :24], w[:, :24], u)
    assert trw.rwkv6_scan.launches == before


def test_wrapper_refuses_cpu_tensors_and_inputs_that_require_grad():
    """No backward kernel exists (nor in the JAX package), so the wrapper
    refuses a tensor that requires grad before it looks at the device; a
    CPU tensor is refused (ops sends those to the plain version)."""
    args = [torch.tensor(a) for a in _inputs(1, 16, 2, 32, 4, "model")]
    before = trw.rwkv6_scan.launches
    for i in range(6):
        bad = list(args)
        bad[i] = bad[i].clone().requires_grad_(True)
        with pytest.raises(ValueError, match="no backward"):
            trw.rwkv6_scan(*bad)
    with pytest.raises(ValueError, match="CUDA kernel got a tensor on cpu"):
        trw.rwkv6_scan(*args)
    assert trw.rwkv6_scan.launches == before


@pytest.mark.parametrize("bad,msg", [
    ("r3d", "must be \\(B, S, H, D\\)"), ("k_shape", "!= r"),
    ("u_shape", "u \\("), ("s0_shape", "s0 \\("),
    ("d48", "head size 48"), ("chunk8", "chunk 8 not supported"),
    ("ragged", "multiple of the chunk"), ("f16", "not supported"),
    ("mixed", "dtypes differ"), ("w16", "w must be float32"),
    ("s0_64", "s0 must be float32"),
])
def test_wrapper_checks_before_launch(bad, msg, monkeypatch):
    """With the device check passed, every malformed call raises on its
    shape, dtype, head size or chunk before any launch."""
    monkeypatch.setattr(trw, "_check_cuda", lambda *t: t[0].device)
    x = torch.zeros((1, 32, 2, 32))
    args = [x, x.clone(), x.clone(), x.clone(), torch.zeros((2, 32)),
            torch.zeros((1, 2, 32, 32))]
    kw = {"chunk": 16}
    if bad == "r3d":
        args[0] = torch.zeros((32, 2, 32))
    elif bad == "k_shape":
        args[1] = torch.zeros((1, 32, 2, 16))
    elif bad == "u_shape":
        args[4] = torch.zeros((3, 32))
    elif bad == "s0_shape":
        args[5] = torch.zeros((1, 2, 32, 16))
    elif bad == "d48":
        args = [torch.zeros((1, 32, 2, 48))] * 4 + [
            torch.zeros((2, 48)), None]
    elif bad == "chunk8":
        kw["chunk"] = 8
    elif bad == "ragged":
        args[:4] = [torch.zeros((1, 24, 2, 32))] * 4
    elif bad == "f16":
        args[:3] = [a.half() for a in args[:3]]
    elif bad == "mixed":
        args[2] = args[2].to(torch.bfloat16)
    elif bad == "w16":
        args[3] = args[3].to(torch.bfloat16)
    elif bad == "s0_64":
        args[5] = args[5].double()
    before = trw.rwkv6_scan.launches
    with pytest.raises(ValueError, match=msg):
        trw.rwkv6_scan(*args, **kw)
    assert trw.rwkv6_scan.launches == before


# -- the CUDA kernel's arithmetic, emulated ---------------------------------
# On the card, B10 (csrc/rwkv6_scan.cu) takes log2 w and its cumulative sum
# L with a scan across the G = 256 / D lanes of a channel, row by row of G
# tokens; forms the carry-in operand r 2^{L_{t-1}}, the update operand
# k 2^{L_C - L_t} and the state's decay 2^{L_C}; sums each causal score
# pairwise (one exp2 of L_{t-1} - L_i <= 0 per pair and channel) over four
# interleaved quarters of the channels, added (q0 + q1) + (q2 + q3), and
# each bonus over two halves; computes y as one product [A | r~] @ [v ; S]
# whose K = C + D rows are summed in KS consecutive groups and the groups
# added in order; and updates S as e^{L_C} S plus the tokens' outer
# products in token order. chip_smoke.py holds the kernel to its plain
# version within 2e-5 of max |value| (B10_TOL). The emulation below repeats
# those steps in torch on the CPU and holds them to the same gate; it
# pins the numerical argument (every exponent <= 0, decays that underflow
# to zero harmlessly) and runs none of the CUDA kernel.

_B10_TOL = 2e-5


def _emulate_b10(r, k, v, w, u, s0, chunk):
    b, seq, h, d = r.shape
    lanes = 256 // d
    ks = max(1, 256 // ((chunk // 4) * (d // 4)))
    r, k, v = (x.float() for x in (r, k, v))
    lw = torch.log2(torch.clamp(w.float(), min=1e-38))
    s = (torch.zeros((b, h, d, d)) if s0 is None else s0.float()).clone()
    quarter = (torch.arange(d) // 4) % 4      # channel d = 16 j + 4 q + c
    half = (torch.arange(d) // 4) % 2         # channel d = 8 j + 4 h + c
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool), -1)
    ys = []
    for c0 in range(0, seq, chunk):
        rc, kc, vc = (x[:, c0:c0 + chunk] for x in (r, k, v))
        # L: a Hillis-Steele scan across the lanes of each row, then the
        # rows' carry in order
        x = lw[:, c0:c0 + chunk].reshape(b, chunk // lanes, lanes, h, d)
        off = 1
        while off < lanes:
            shifted = torch.zeros_like(x)
            shifted[:, :, off:] = x[:, :, :-off]
            x = torch.where((torch.arange(lanes) >= off)[:, None, None],
                            x + shifted, x)
            off *= 2
        carry = torch.zeros((b, h, d))
        rows = []
        for j in range(chunk // lanes):
            rows.append(carry[:, None] + x[:, j])
            carry = rows[-1][:, -1]
        el = torch.cat(rows, dim=1)                         # L_t (b,C,h,d)
        el_prev = torch.cat([torch.zeros_like(el[:, :1]), el[:, :-1]], 1)
        r_til = rc * torch.exp2(el_prev)
        k_til = kc * torch.exp2(carry[:, None] - el)
        dec = torch.exp2(carry)                             # (b,h,d)
        # scores, pairwise, by quarters of the channels in their order
        parts = []
        for q in range(4):
            acc = torch.zeros((b, chunk, chunk, h))
            for c in torch.nonzero(quarter == q).flatten().tolist():
                expo = el_prev[:, :, None, :, c] - el[:, None, :, :, c]
                dec_ti = torch.exp2(torch.where(causal[None, :, :, None],
                                                expo, -torch.inf))
                acc = acc + (rc[:, :, None, :, c] * kc[:, None, :, :, c]) \
                    * dec_ti
            parts.append(acc)
        a = (parts[0] + parts[1]) + (parts[2] + parts[3])   # (b,t,i,h)
        bonus = []
        for hh in range(2):
            acc = torch.zeros((b, chunk, h))
            for c in torch.nonzero(half == hh).flatten().tolist():
                acc = acc + (rc[..., c] * u[:, c]) * kc[..., c]
            bonus.append(acc)
        idx = torch.arange(chunk)
        a[:, idx, idx] = bonus[0] + bonus[1]
        # y = [A | r~] @ [v ; S]: K rows in KS groups, the groups in order
        xa = torch.cat([a.permute(0, 2, 1, 3), r_til.permute(0, 3, 1, 2)],
                       dim=1)                               # (b,K,t,h)
        xb = torch.cat([vc, s.permute(0, 2, 1, 3)], dim=1)  # (b,K,h,e)
        klen = (chunk + d) // ks
        y = None
        for kp in range(ks):
            part = torch.zeros((b, chunk, h, d))
            for kk in range(kp * klen, (kp + 1) * klen):
                part = part + xa[:, kk, :, :, None] * xb[:, kk, None]
            y = part if y is None else y + part
        ys.append(y)
        # S <- e^{L_C} S + sum_t k~_t v_t^T, token by token
        s = dec[..., None] * s
        for t in range(chunk):
            s = s + k_til[:, t, :, :, None] * vc[:, t, :, None, :]
    return torch.cat(ys, dim=1), s


def _within_b10_gate(got, want):
    for g, wv in zip(got, want):
        diff = (g - wv).abs().max().item()
        assert diff <= _B10_TOL * wv.abs().max().item(), diff


@pytest.mark.parametrize("chunk,w_kind,with_s0", [
    (16, "model", True), (16, "kernel", False), (64, "model", True),
    (64, "kernel", True),
])
def test_kernel_order_emulated_holds_b10_gate(chunk, w_kind, with_s0):
    """The model's decays (w >= e^-4) and tests/test_kernels.py's (0.05 to
    0.95), from zeros and from a state, at the model's chunk and the
    largest: the kernel's order stays within the card's gate."""
    arrs = [torch.tensor(a) for a in _inputs(2, 128, 2, 64, chunk, w_kind)]
    r, k, v, w, u, s0 = arrs
    s0 = s0 if with_s0 else None
    got = _emulate_b10(r, k, v, w, u, s0, chunk)
    _within_b10_gate(got, ref.rwkv6_scan(r, k, v, w, u, s0, chunk))


@pytest.mark.parametrize("chunk", [16, 64])
def test_kernel_order_emulated_with_underflowing_decays(chunk):
    """w within 1% of e^-4 (the model's floor): a 64-token chunk's decays
    reach e^-256, which f32 holds as zero. Every exponent the kernel forms
    is <= 0, so those products underflow to zero and the result stays in
    the gate; the model path's k e^{-L} factorisation overflows there."""
    r, k, v, _, u, s0 = (torch.tensor(a)
                         for a in _inputs(1, 128, 2, 64, 7, "model"))
    rng = np.random.default_rng(11)
    w = torch.tensor(np.exp(-4.0 + 0.01 * rng.random(r.shape)),
                     dtype=torch.float32)
    got = _emulate_b10(r, k, v, w, u, s0, chunk)
    assert all(torch.isfinite(t).all() for t in got)
    _within_b10_gate(got, ref.rwkv6_scan(r, k, v, w, u, s0, chunk))
    el = torch.cumsum(torch.log(w[:, :chunk]), dim=1)
    assert torch.isfinite(k[:, :chunk] * torch.exp(-el)).all() == \
        (chunk == 16)


@pytest.mark.parametrize("d", [16, 32, 128])
def test_kernel_order_emulated_at_other_head_sizes(d):
    """Head sizes 16, 32 and 128 scan over 16, 8 and 2 lanes a channel and
    split y's sum over 16, 8 and 2 groups."""
    r, k, v, w, u, s0 = (torch.tensor(a)
                         for a in _inputs(1, 64, 2, d, d, "model"))
    got = _emulate_b10(r, k, v, w, u, s0, 16)
    _within_b10_gate(got, ref.rwkv6_scan(r, k, v, w, u, s0, 16))
