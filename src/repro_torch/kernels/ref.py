"""Plain PyTorch versions of the B1-B10 kernels: the CPU path of
:mod:`repro_torch.kernels.ops` and the yardstick the CUDA kernels are held
against on the card. Device-agnostic tensor code."""
from __future__ import annotations

import torch

from repro_torch.core import sketch as _sketch


def flat_mix(eta: torch.Tensor, master: torch.Tensor, wire: torch.Tensor,
             gamma) -> torch.Tensor:
    """``OUT = MASTER + gamma * (ETA @ WIRE - rowsum(ETA) * WIRE)`` with the
    wire upcast to f32 before the product. With a variant axis (the batched
    sweeps): master and wire (V, K, P), eta (K, K) shared by every variant
    or (V, K, K), gamma (V,)."""
    eta32 = eta.float()
    w32 = wire.float()
    g = torch.as_tensor(gamma, dtype=torch.float32, device=master.device)
    g = g.reshape(-1, 1, 1) if master.dim() == 3 else g.reshape(())
    row = eta32.sum(dim=-1)
    mixed = eta32 @ w32
    return master + g * (mixed - row[..., None] * w32)


def flat_consensus(matrix: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
    """``OUT = A @ BUF`` in f32; buf (K, P), or (V, K, P) with A (K, K)
    shared or (V, K, K)."""
    return matrix.float() @ buf.float()


def consensus_mix(w: torch.Tensor, neighbors: torch.Tensor, eta,
                  gamma) -> torch.Tensor:
    """``OUT = W + gamma * sum_i eta_i (NB_i - W)`` in f32, cast to ``w``'s
    dtype: w (rows, L), neighbors (N, rows, L), eta (N,)."""
    w32 = w.float()
    delta = neighbors.float() - w32[None]
    eta32 = torch.as_tensor(eta, dtype=torch.float32, device=w.device)
    acc = torch.einsum("n,nrl->rl", eta32, delta)
    g = torch.as_tensor(gamma, dtype=torch.float32, device=w.device)
    return (w32 + g.reshape(()) * acc).to(w.dtype)


def sparse_neighbor_sum(idx: torch.Tensor, val: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """``sum_d val[k,d] * W[idx[k,d]]`` in f32: D gather-axpy passes over
    the (K, P) buffer. Zero-weight slots gather a row and multiply it
    away."""
    w32 = w.float()
    val32 = val.float()
    rows = idx.long()
    acc = val32[:, 0:1] * w32[rows[:, 0]]
    for dd in range(1, rows.shape[1]):
        acc = acc + val32[:, dd:dd + 1] * w32[rows[:, dd]]
    return acc


def sparse_mix(idx: torch.Tensor, val: torch.Tensor, master: torch.Tensor,
               wire: torch.Tensor, gamma) -> torch.Tensor:
    """``OUT_k = M_k + gamma * (sum_d val[k,d] W[idx[k,d]] - rowsum_k W_k)``
    for (K, D) idx/val, f32 master, f32 or bf16 wire."""
    val32 = val.float()
    w32 = wire.float()
    g = torch.as_tensor(gamma, dtype=torch.float32, device=master.device)
    row = val32.sum(dim=1)
    mixed = sparse_neighbor_sum(idx, val32, w32)
    return master + g.reshape(()) * (mixed - row[:, None] * w32)


def cluster_mix(idx: torch.Tensor, val: torch.Tensor, master: torch.Tensor,
                wself: torch.Tensor, wire: torch.Tensor,
                gamma_node: torch.Tensor) -> torch.Tensor:
    """``OUT_k = M_k + g[k] * (sum_d val[k,d] W[idx[k,d]] - rowsum_k
    WSELF_k)``: the sparse mix with a per-node step size and a separate
    self payload."""
    val32 = val.float()
    g = gamma_node.float()
    row = val32.sum(dim=1)
    mixed = sparse_neighbor_sum(idx, val32, wire)
    return master + g[:, None] * (mixed - row[:, None] * wself.float())


# --- the per-leaf consensus path (oracle for the flat-buffer engine) --------
# Trees are dicts (str keys) and lists of (K, ...) tensors, their leaves in
# the order ``jax.tree.flatten`` gives (``core.flatten.leaves_with_paths``).

def apply_matrix_pytree(params, matrix: torch.Tensor):
    """Leaf at a time phi = A @ W: one einsum a leaf, in the leaf's dtype.
    The ground truth the flat path is held against."""
    from repro_torch.core import flatten

    def mix(leaf):
        flat = leaf.reshape(leaf.shape[0], -1)
        out = torch.einsum("ki,id->kd", matrix.to(flat.dtype), flat)
        return out.reshape(leaf.shape)
    return flatten.tree_map(mix, params)


def consensus_step_pytree(params, eta: torch.Tensor, gamma,
                          self_weight: float = 1.0):
    """Paper eq. (5) per leaf: phi_k = sw*W_k + g * sum_i eta_ki (W_i-W_k),
    the operator A = sw*I + g*(eta - diag(rowsum))."""
    from repro_torch.core import topology
    k = eta.shape[0]
    a = topology.consensus_matrix(eta, gamma)
    if self_weight != 1.0:
        a = a + (self_weight - 1.0) * torch.eye(k, dtype=a.dtype,
                                                device=a.device)
    return apply_matrix_pytree(params, a)


def partial_consensus_step_pytree(params, eta: torch.Tensor, gamma,
                                  fraction: float):
    """C-DFA(M) per leaf: mix the first max(1, round(f * n_leaves))
    leaves, keep the rest."""
    from repro_torch.core import flatten, topology
    pairs = flatten.leaves_with_paths(params)
    n_mix = max(1, int(round(fraction * len(pairs))))
    a = topology.consensus_matrix(eta, gamma)
    return flatten.build_tree(
        [path for path, _ in pairs],
        [apply_matrix_pytree(leaf, a) if i < n_mix else leaf
         for i, (_, leaf) in enumerate(pairs)])


def disagreement_pytree(params) -> torch.Tensor:
    """Per-leaf mean squared deviation from the node mean, summed over the
    leaves (each leaf's sum in its dtype) and divided by the element
    count."""
    from repro_torch.core import flatten
    leaves = [leaf for _, leaf in flatten.leaves_with_paths(params)]
    total = sum(torch.sum((leaf - leaf.mean(dim=0, keepdim=True)) ** 2)
                for leaf in leaves)
    return total / sum(leaf.numel() for leaf in leaves)


# candidates per column chunk of robust_agg: 2**25 f32 values, 128 MB
ROBUST_CHUNK_ELEMS = 1 << 25


def robust_sorted(mask: torch.Tensor, buf: torch.Tensor,
                  sent: torch.Tensor) -> torch.Tensor:
    """The sorted (K, K, C) candidates of one column chunk of
    :func:`robust_agg`: receiver k's own slot read from ``buf``, masked
    slots at +inf, sorted over the sender axis, non-finite values
    zeroed."""
    k = buf.shape[0]
    eye = torch.eye(k, dtype=torch.bool, device=buf.device)[:, :, None]
    cand = torch.where(eye, buf[None, :, :], sent[None, :, :])
    cand = torch.where(mask[:, :, None] > 0, cand, torch.inf)
    v = torch.sort(cand, dim=1).values
    return torch.where(torch.isfinite(v), v, torch.zeros_like(v))


def robust_agg(weights: torch.Tensor, mask: torch.Tensor, buf: torch.Tensor,
               sent: torch.Tensor) -> torch.Tensor:
    """``OUT[k] = sum_j weights[k, j] * sort_i({payload_i : mask[k, i]})[j]``
    with payload_i = ``sent[i]``, except receiver k's own slot, which is
    ``buf[k]``. Masked slots sort to the tail as +inf and every non-finite
    value is zeroed after the sort, as the JAX package's
    ``robust_agg_xla`` computes it. The (K, K, C) candidate tensor is
    built over column chunks of at most ``ROBUST_CHUNK_ELEMS`` elements,
    so the whole (K, K, P) tensor never exists (6.3 GB at K=256,
    P=23,936)."""
    w32, m32 = weights.float(), mask.float()
    b32, s32 = buf.float(), sent.float()
    k, p = b32.shape
    step = max(1, ROBUST_CHUNK_ELEMS // (k * k))
    out = [(w32[:, :, None] * robust_sorted(
                m32, b32[:, c:c + step], s32[:, c:c + step])).sum(dim=1)
           for c in range(0, p, step)]
    return torch.cat(out, dim=1).to(buf.dtype)


def cnd_bitmaps(items: torch.Tensor, num_hashes: int = 3,
                m: int = 8192) -> torch.Tensor:
    """Packed CND bitmaps — identical to the core sketch module."""
    return _sketch.build_bitmaps(items, num_hashes, m)


def cnd_popcount(bitmaps: torch.Tensor) -> torch.Tensor:
    return _sketch.set_bits(bitmaps)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, KV, D) -> the model's reference
    attention, :func:`repro_torch.models.attention.attend`."""
    from repro_torch.models import attention
    return attention.attend(q, k, v, causal=causal, window=window)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               s0: torch.Tensor | None = None,
               chunk: int = 16) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked RWKV6 wkv scan, the function of the JAX model's
    ``rwkv.chunked``: r/k/v/w (B, S, H, D), u (H, D), s0 (B, H, D, D) or
    None (zeros) -> (y (B, S, H, D) f32, final state (B, H, D, D) f32),
    everything in f32.

    Per chunk of ``chunk`` tokens, with L_t = cumsum(log w) inside the
    chunk: the strictly causal pairwise scores
    ``sum_d r_td k_id e^{L_{t-1,d} - L_{i,d}}`` (every exponent <= 0, the
    TPU kernel's form), the ``u`` bonus on the diagonal, the carry-in
    term ``(r e^{L_{t-1}}) @ S`` and the per-chunk summaries ``d_c =
    e^{L_C}``, ``u_c = (k e^{L_C - L})^T v``. A loop over the chunks takes
    the place of the reference's associative scan for the chunk-start
    states: the same sums in another f32 order."""
    b, seq, h, d = r.shape
    if seq % chunk:
        raise ValueError(f"sequence length {seq} is not a multiple of the "
                         f"chunk {chunk}")
    nc = seq // chunk

    def rs(x):
        return x.float().reshape(b, nc, chunk, h, d)

    rc, kc, vc, wc = rs(r), rs(k), rs(v), rs(w)
    logw = torch.log(torch.clamp(wc, min=1e-38))
    el = torch.cumsum(logw, dim=2)                       # L_t     (b,n,C,h,d)
    el_prev = el - logw                                  # L_{t-1}
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=r.device), -1)[:, :, None, None]
    expo = el_prev[:, :, :, None] - el[:, :, None, :]    # (b,n,t,i,h,d)
    dec = torch.exp(torch.where(causal, expo, -torch.inf))
    scores = torch.einsum("bnthd,bntihd->bnhti", rc,
                          dec * kc[:, :, None])
    del expo, dec
    diag = torch.einsum("bnthd,hd,bnthd->bnth", rc, u.float(), kc)
    y = torch.einsum("bnhti,bnihd->bnthd", scores, vc) + diag[..., None] * vc

    k_dec = kc * torch.exp(el[:, :, -1:] - el)
    u_c = torch.einsum("bnihd,bnihe->bnhde", k_dec, vc)  # (b,n,h,d,d)
    d_c = torch.exp(el[:, :, -1])                        # (b,n,h,d)
    s = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device) \
        if s0 is None else s0.float()
    starts = []
    for c in range(nc):
        starts.append(s)
        s = d_c[:, c, :, :, None] * s + u_c[:, c]
    s_start = torch.stack(starts, dim=1)
    y = y + torch.einsum("bnthd,bnhde->bnthe", rc * torch.exp(el_prev),
                         s_start)
    return y.reshape(b, seq, h, d), s
