"""Consensus transport — how the flat ``(K, P)`` buffer moves.

    buf', state' = transport.exchange(buf, eta, gamma, state, rnd)

What travels the wire is a :class:`WireCodec`: ``f32`` (identity) or
``bf16``, which halves the exchanged bytes; the delta-form mix keeps the
wire precision on the neighbor differences, which vanish at consensus.
On the card a bf16 wire is a real cast that kernels B1, B5 and B6 read
as bf16.
Transports are ``fed -> Transport`` factories in
:data:`repro_torch.registry.transports`; only the dense transport is
ported so far.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import flatten
from repro_torch.core.topology import SparseEta
from repro_torch.registry import transports, wire_codecs


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


wire_codecs.register("f32", CastCodec("f32", torch.float32))
wire_codecs.register("bf16", CastCodec("bf16", torch.bfloat16))


@dataclasses.dataclass(frozen=True)
class DenseTransport:
    """Fused dense exchange: every node mixes every neighbor in one
    ``(K, K) @ (K, P)`` operation (the eta matrix encodes the topology)."""

    wire_dtype: str = "f32"

    @property
    def codec(self) -> WireCodec:
        return wire_codecs.get(self.wire_dtype)

    def init_state(self, buf: torch.Tensor) -> Any:
        return ()

    def wire(self, buf: torch.Tensor) -> torch.Tensor | None:
        """What the mix kernels read as the exchanged buffer: ``None`` for
        the identity codec, else the cast buffer (the registered codecs
        are pure casts; the kernels upcast it themselves)."""
        codec = self.codec
        return None if codec.cast_dtype == buf.dtype else codec.encode(buf)

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
        batched = buf.dim() == 3
        if sent is None:
            wire = self.wire(buf)
            if sparse and batched:
                out = flatten.sparse_mix_variants(buf, eta.idx, eta.val,
                                                  gamma, wire=wire)
            elif sparse:
                out = flatten.sparse_mix_flat(buf, eta.idx, eta.val, gamma,
                                              wire=wire)
            else:
                out = flatten.mix_flat(buf, eta, gamma, wire=wire)
            return out, state
        codec = self.codec
        g = torch.as_tensor(gamma, dtype=buf.dtype, device=buf.device)
        if sparse and batched:
            out = flatten.sparse_mix_variants(
                buf, eta.idx, eta.val, g, wire=codec.encode(sent),
                wire_self=codec.encode(buf))
            return out, state
        if sparse:
            gamma_node = g.reshape(1).expand(buf.shape[0]).contiguous()
            out = flatten.cluster_mix_flat(
                buf, eta.idx, eta.val, gamma_node,
                wire=codec.encode(sent).contiguous(),
                wire_self=codec.encode(buf))
            return out, state
        w_nb = codec.roundtrip(sent)
        w_self = codec.roundtrip(buf)
        eta32 = eta.to(buf.dtype)
        row = eta32.sum(dim=-1)
        mixed = flatten.apply_matrix_flat(w_nb.contiguous(), eta32)
        if batched:
            g = g.reshape(-1, 1, 1)
        return buf + g * (mixed - row[..., None] * w_self), state


@transports.register("dense")
def _make_dense(fed) -> DenseTransport:
    return DenseTransport(wire_dtype=fed.wire_dtype)


def make_transport(fed) -> Any:
    """The transport a :class:`repro_torch.configs.base.FedConfig` asks
    for: a registry lookup."""
    wire_codecs.get(fed.wire_dtype)
    return transports.get(fed.transport)(fed)
