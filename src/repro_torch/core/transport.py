"""Consensus transport — how the flat ``(K, P)`` buffer moves.

    state        = transport.init_state(buf)
    buf', state' = transport.exchange(buf, eta, gamma, state, rnd)

Transports are ``fed -> Transport`` factories in
:data:`repro_torch.registry.transports`, and :func:`make_transport` is that
lookup. The built-ins:

* :class:`DenseTransport` — the fused ``(K, K) @ (K, P)`` mix (kernel B1),
  or the top-D gather (B5) under the sparse format.
* :class:`RingShardTransport` — the exchange restricted to the ring
  ``{k-1, k+1}``: two shifted copies of the wire buffer instead of a dense
  product, in the reference's order of operations (plain tensor ops; the
  reference computes it outside any kernel too).
* :class:`GossipTransport` — bounded-delay exchange: the neighbor terms
  read a snapshot of the wire buffer ``staleness`` rounds old, kept in a
  circular buffer of encoded snapshots in the transport state (kernel B2
  on the dense format, B6 on the sparse one). ``staleness=0`` is the dense
  transport, bit for bit.

What travels the wire is a :class:`WireCodec`: ``f32`` (identity) or
``bf16``, which halves the exchanged bytes; the delta-form mix keeps the
wire precision on the neighbor differences, which vanish at consensus.
On the card a bf16 wire is a real cast that kernels B1, B5 and B6 read as
bf16. The port casts on every backend, so there is no switch that skips
the cast on the CPU.

A ``(V, K, P)`` buffer exchanges V variants at once (the batched sweeps):
the ring rolls the node axis of every variant, and a gossip state holds
``(V, s, K, P)`` snapshots.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import flatten
from repro_torch.core.topology import SparseEta
from repro_torch.registry import transports, wire_codecs


# --------------------------------------------------------------------------
# Wire codecs: the buffer's on-the-wire representation.
# --------------------------------------------------------------------------

class WireCodec:
    """f32 flat buffer <-> wire representation.

    ``encode(buf)`` returns the wire form, ``decode(wire, dtype)`` what a
    receiver reconstructs. ``cast_dtype`` is set when ``encode`` is a pure
    dtype cast, so the fused mix kernel may read the encoded buffer
    directly."""

    name: str = "?"
    cast_dtype = None

    def encode(self, buf: torch.Tensor):
        raise NotImplementedError

    def decode(self, wire, dtype=torch.float32) -> torch.Tensor:
        raise NotImplementedError

    def wire_bytes(self, layout: flatten.FlatLayout) -> int:
        """Bytes one node sends over one link per round."""
        raise NotImplementedError

    def roundtrip(self, buf: torch.Tensor) -> torch.Tensor:
        """``buf`` as it survives the wire, back in ``buf``'s dtype."""
        return self.decode(self.encode(buf), buf.dtype)


@dataclasses.dataclass(frozen=True)
class CastCodec(WireCodec):
    """Pure dtype cast: ``f32`` (identity) and ``bf16``."""

    name: str = "f32"
    dtype: torch.dtype = torch.float32

    @property
    def cast_dtype(self):
        return self.dtype

    def encode(self, buf: torch.Tensor) -> torch.Tensor:
        return buf.to(self.dtype)

    def decode(self, wire, dtype=torch.float32) -> torch.Tensor:
        return wire.to(dtype)

    def wire_bytes(self, layout: flatten.FlatLayout) -> int:
        return layout.padded * self.dtype.itemsize


wire_codecs.register("f32", CastCodec("f32", torch.float32))
wire_codecs.register("bf16", CastCodec("bf16", torch.bfloat16))


def wire_codec(name: str) -> WireCodec:
    """Look up a registered :class:`WireCodec` (listing names on a miss)."""
    return wire_codecs.get(name)


def _wire_dtype(name: str):
    """The torch dtype of a pure-cast codec."""
    codec = wire_codec(name)
    if codec.cast_dtype is None:
        raise ValueError(f"wire codec {name!r} is not a pure dtype cast")
    return codec.cast_dtype


# --------------------------------------------------------------------------
# Transports.
# --------------------------------------------------------------------------

class _FlatTransport:
    """Shared transport behavior: one full wire-codec payload per link per
    round, and no state unless a subclass says otherwise."""

    wire_dtype: str = "f32"

    @property
    def codec(self) -> WireCodec:
        return wire_codec(self.wire_dtype)

    @property
    def stateful(self) -> bool:
        """False: :meth:`init_state` returns ``()``."""
        return False

    def init_state(self, buf: torch.Tensor) -> Any:
        return ()

    def wire_bytes(self, layout: flatten.FlatLayout) -> int:
        """Bytes one node sends over one link per round."""
        return self.codec.wire_bytes(layout)

    def wire(self, buf: torch.Tensor) -> torch.Tensor | None:
        """What the mix kernels read as the exchanged buffer: ``None`` for
        the identity codec, else the cast buffer (the registered codecs
        are pure casts; the kernels upcast it themselves)."""
        codec = self.codec
        return None if codec.cast_dtype == buf.dtype else codec.encode(buf)


def _gamma(gamma, buf: torch.Tensor) -> torch.Tensor:
    """The step size as a tensor that broadcasts over ``buf``: a scalar, or
    (V, 1, 1) for a (V, K, P) buffer."""
    g = torch.as_tensor(gamma, dtype=buf.dtype, device=buf.device)
    return g.reshape(-1, 1, 1) if buf.dim() == 3 else g


def _received_mix(buf, eta, gamma, w_nb, w_self):
    """``buf + gamma * (eta @ w_nb - rowsum(eta) * w_self)`` with the
    neighbor rows ``w_nb`` (f32) read through kernel B2; dense eta (K, K),
    or for a (V, K, P) buffer (K, K) shared or (V, K, K)."""
    eta32 = eta.to(buf.dtype)
    row = eta32.sum(dim=-1)
    mixed = flatten.apply_matrix_flat(w_nb.contiguous(), eta32)
    return buf + _gamma(gamma, buf) * (mixed - row[..., None] * w_self)


def _received_sparse(buf, eta: SparseEta, gamma, wire, wire_self):
    """The sparse twin of :func:`_received_mix` through kernel B6: the
    gathered rows read ``wire``, the self rescale ``wire_self`` (both at
    the wire dtype, upcast by the kernel), the step size broadcast to
    every node."""
    if buf.dim() == 3:
        return flatten.sparse_mix_variants(buf, eta.idx, eta.val, gamma,
                                           wire=wire, wire_self=wire_self)
    g = torch.as_tensor(gamma, dtype=buf.dtype, device=buf.device)
    gamma_node = g.reshape(1).expand(buf.shape[0]).contiguous()
    return flatten.cluster_mix_flat(buf, eta.idx, eta.val, gamma_node,
                                    wire=wire.contiguous(),
                                    wire_self=wire_self.contiguous())


@dataclasses.dataclass(frozen=True)
class DenseTransport(_FlatTransport):
    """Fused dense exchange: every node mixes every neighbor in one
    ``(K, K) @ (K, P)`` operation (the eta matrix encodes the topology)."""

    wire_dtype: str = "f32"

    def exchange(self, buf, eta, gamma, state=(), rnd=None, sent=None):
        """Eq. 5 on ``buf`` with dense (K, K) weights or a
        :class:`repro_torch.core.topology.SparseEta`. ``sent`` overrides
        the per-node wire payloads (fault injection): the neighbor terms
        then read the codec'd payloads while the self term keeps each
        node's own buffer through the codec (a node never receives
        itself). The sparse form is kernel B6 with the step size broadcast
        to every node: the gathered rows come from ``sent``, the self
        rescale from ``buf``.

        A ``(V, K, P)`` buffer exchanges V variants at once (the batched
        sweeps): dense weights (K, K) or (V, K, K) through one B1 or B2
        launch, sparse tables (K, D) or (V, K, D) through one B6 launch on
        the (V·K, P) rows, gamma (V,)."""
        sparse = isinstance(eta, SparseEta)
        if sent is None:
            wire = self.wire(buf)
            if sparse and buf.dim() == 3:
                out = flatten.sparse_mix_variants(buf, eta.idx, eta.val,
                                                  gamma, wire=wire)
            elif sparse:
                out = flatten.sparse_mix_flat(buf, eta.idx, eta.val, gamma,
                                              wire=wire)
            else:
                out = flatten.mix_flat(buf, eta, gamma, wire=wire)
            return out, state
        codec = self.codec
        if sparse:
            return _received_sparse(buf, eta, gamma, codec.encode(sent),
                                    codec.encode(buf)), state
        return _received_mix(buf, eta, gamma, codec.roundtrip(sent),
                             codec.roundtrip(buf)), state


@dataclasses.dataclass(frozen=True)
class RingShardTransport(_FlatTransport):
    """Eq. 5 on the ring ``{k-1, k+1}``: two shifted wire buffers, no dense
    product. Needs K >= 3 (on K=2 both shifts alias the single neighbor and
    its weight would be counted twice). Dense eta only: the shifts ARE its
    topology, so only the ``(k, k-1)`` and ``(k, k+1)`` weights are read."""

    wire_dtype: str = "f32"

    def exchange(self, buf, eta, gamma, state=(), rnd=None, sent=None):
        k = buf.shape[-2]
        if k < 3:
            raise ValueError(f"ring transport needs K >= 3 nodes, got {k}")
        if isinstance(eta, SparseEta):
            raise ValueError(
                "ring transport is physically degree-2 (the {k-1, k+1} "
                "shifts ARE its topology) — sparse top-D eta has nothing "
                "to gather here; use the dense or gossip transport with "
                "mixing_format='sparse'")
        idx = torch.arange(k, device=buf.device)
        eta32 = eta.to(buf.dtype)
        ep = eta32[..., idx, (idx - 1) % k][..., None]     # weight for k-1
        en = eta32[..., idx, (idx + 1) % k][..., None]     # weight for k+1
        # fault injection swaps the payload the shifts move (the
        # self-cancellation term stays the node's own buffer)
        codec = self.codec
        enc = codec.encode(buf if sent is None else sent)
        w_self = codec.roundtrip(buf)
        w_prev = codec.decode(torch.roll(enc, 1, dims=-2), buf.dtype)
        w_next = codec.decode(torch.roll(enc, -1, dims=-2), buf.dtype)
        out = buf + _gamma(gamma, buf) * (ep * (w_prev - w_self)
                                          + en * (w_next - w_self))
        return out, state


@dataclasses.dataclass(frozen=True)
class GossipTransport(_FlatTransport):
    """Bounded-delay gossip: the neighbor terms read a buffer snapshot
    ``staleness`` rounds old, from a circular buffer of ENCODED snapshots
    in the transport state (``(s, K, P)`` at the wire dtype; ``(V, s, K,
    P)`` batched). ``staleness=0`` is stateless and bit-identical to
    :class:`DenseTransport`."""

    staleness: int = 0
    wire_dtype: str = "f32"

    @property
    def stateful(self) -> bool:
        return self.staleness > 0

    def init_state(self, buf: torch.Tensor) -> Any:
        if self.staleness == 0:
            return ()
        enc = self.codec.encode(buf)
        return enc[None].expand((self.staleness,) + tuple(enc.shape)).clone()

    def exchange(self, buf, eta, gamma, state=(), rnd=None, sent=None):
        """Round ``rnd`` reads snapshot slot ``rnd % s``, last written at
        round ``rnd - s``, and returns a state whose slot holds this
        round's encoded payload (``sent``, scrubbed by the wire guard, or
        ``buf``). The neighbor terms mix the decoded snapshot with the
        CURRENT round's weights; the self term is the current buffer
        through the codec, so ``s -> 0`` recovers the synchronous delta
        form term by term."""
        if self.staleness == 0:
            return DenseTransport(self.wire_dtype).exchange(
                buf, eta, gamma, state, rnd, sent=sent)
        if rnd is None:
            raise ValueError("stale gossip needs the round index (rnd)")
        slot = int(rnd) % self.staleness
        axis = buf.dim() - 2              # the slot axis: 0, or 1 batched
        stale = state.select(axis, slot)
        codec = self.codec
        if isinstance(eta, SparseEta):
            out = _received_sparse(buf, eta, gamma, stale, codec.encode(buf))
        else:
            out = _received_mix(buf, eta, gamma,
                                codec.decode(stale, buf.dtype),
                                codec.roundtrip(buf))
        new_state = state.clone()
        new_state.select(axis, slot).copy_(
            codec.encode(buf if sent is None else sent))
        return out, new_state


# --------------------------------------------------------------------------
# Registration + config factory.
# --------------------------------------------------------------------------

@transports.register("dense")
def _make_dense(fed) -> DenseTransport:
    return DenseTransport(wire_dtype=fed.wire_dtype)


@transports.register("ring")
def _make_ring(fed) -> RingShardTransport:
    if fed.num_nodes < 3:
        raise ValueError("ring transport needs num_nodes >= 3")
    if fed.topology != "ring":
        raise ValueError(
            f"ring transport moves data only between ring neighbors; "
            f"topology={fed.topology!r} needs the dense transport")
    return RingShardTransport(wire_dtype=fed.wire_dtype)


@transports.register("gossip")
def _make_gossip(fed) -> GossipTransport:
    return GossipTransport(staleness=fed.staleness,
                           wire_dtype=fed.wire_dtype)


# the registered transport names, live
TRANSPORTS = transports.view()


def make_transport(fed) -> Any:
    """The transport a :class:`repro_torch.configs.base.FedConfig` asks
    for: a registry lookup."""
    wire_codec(fed.wire_dtype)          # validate early
    return transports.get(fed.transport)(fed)


# --------------------------------------------------------------------------
# Mesh mode: the ring transport over the fed group (one node per rank).
# --------------------------------------------------------------------------

def ring_exchange_shard(vec: torch.Tensor, eta_prev: torch.Tensor,
                        eta_next: torch.Tensor, gamma, axis, *,
                        wire_dtype: str = "f32", shards: int = 1,
                        perms=None, mesh=None) -> torch.Tensor:
    """Eq. 5 on the physical ring for ONE node's flat ``(P,)`` vector (one
    node per rank of the ring over the mesh dimensions ``axis``).

    The vector is cast to the wire dtype and split into LANE-aligned
    column chunks, and every chunk is sent in both directions before any
    is mixed (the permutes are asynchronous collectives, so the mix of
    chunk j can overlap the transfer of chunk j+1). ``shards=1`` is ONE
    permute per direction per round. The node's own value goes through
    the wire cast too (``w_self``), so only the difference terms see the
    wire precision and they vanish at consensus.

    Only pure-cast wire codecs are supported (one tensor moves per chunk).
    ``perms``: optional precomputed (fwd, bwd) (src, dst) pairs from
    :func:`repro_torch.launch.mesh.fed_ring_perms`. ``mesh``: the
    DeviceMesh whose dimensions ``axis`` names (port-only)."""
    from repro_torch.core.consensus import ring_neighbors

    wdt = _wire_dtype(wire_dtype)
    wire = vec.to(wdt)
    n = flatten.column_shards(wire.shape[-1], shards)
    width = wire.shape[-1] // n
    chunks = wire.split(width, dim=-1)
    # issue every transfer before any mix so they can all be in flight
    moved = [ring_neighbors(c, axis, perms=perms, mesh=mesh) for c in chunks]
    g = torch.as_tensor(gamma, dtype=vec.dtype, device=vec.device)
    ep = eta_prev.to(vec.dtype)
    en = eta_next.to(vec.dtype)
    outs = []
    for c, (w_prev, w_next) in zip(vec.split(width, dim=-1), moved):
        w_self = c.to(wdt).to(vec.dtype)
        outs.append(c + g * (ep * (w_prev.to(vec.dtype) - w_self)
                             + en * (w_next.to(vec.dtype) - w_self)))
    return outs[0] if n == 1 else torch.cat(outs, dim=-1)
