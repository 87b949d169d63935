"""Registered fault models + host-side schedule compilation.

A fault model is a plugin in :data:`repro_torch.registry.fault_models`
with signature ``model(plan: dict, cfg: FaultConfig, rng) -> None``
mutating the plan arrays in place. :func:`compile_plan` seeds each
selected model with its own deterministic stream (``SeedSequence([seed,
crc32(kind)])``, the mobility-trace convention), always generates from
round 0, and slices ``[start:]``: a run resumed at round r replays exactly
the faults an unbroken run would see. The numpy half is a copy of the JAX
package's ``repro.faults.models``, so both compile identical arrays.

The compiled :class:`FaultPlan` is plain numpy. ``run_rounds`` folds
``link_mask`` into the per-round eta stacks on the host and moves the
``(R, K)`` stacks to the device once per run; the tensor helpers at the
bottom (:func:`corrupt_rows`, :func:`wire_guard`) are the per-round
injection / self-healing half. They gate on device tensors with
``torch.where``, never on a host read, so a round issues no
synchronization.
"""
from __future__ import annotations

import zlib
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.registry import fault_models


class FaultPlan(NamedTuple):
    """Per-round fault schedules, all numpy, rounds-first.

    ``link_mask``: (R, K, K) 0/1 — surviving directed links (crashed
    nodes have their row AND column zeroed; drops are symmetric).
    ``health``: (R, K) 1=alive — crashed nodes freeze (no local steps,
    no exchange). ``byz``: (R, K) wire multiplier (1=honest; -1
    sign-flip; ``byzantine_scale`` for scaled attacks). ``corrupt``:
    (R, K) 0/1 — the node's wire payload is poisoned this round.
    ``straggle``: (R, K) 0/1 — the node replays its previous-round
    buffer instead of the fresh one.
    """

    link_mask: np.ndarray
    health: np.ndarray
    byz: np.ndarray
    corrupt: np.ndarray
    straggle: np.ndarray

    @property
    def is_noop(self) -> bool:
        """True when no fault ever fires."""
        return (bool(np.all(self.link_mask == 1.0))
                and bool(np.all(self.health == 1.0))
                and bool(np.all(self.byz == 1.0))
                and not np.any(self.corrupt)
                and not np.any(self.straggle))

    @property
    def uses_wire(self) -> bool:
        """Whether any per-node wire behavior (byz/corrupt/straggle)
        fires."""
        return (bool(np.any(self.byz != 1.0)) or bool(np.any(self.corrupt))
                or bool(np.any(self.straggle)))


def _rng(seed: int, kind: str) -> np.random.Generator:
    """Deterministic per-kind stream (mobility-trace convention)."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed), zlib.crc32(kind.encode())]))


@fault_models.register("link_drop")
def link_drop(plan: dict, cfg, rng: np.random.Generator) -> None:
    """i.i.d. per-round undirected link erasures: a V2V transfer that
    fails CRC / times out beyond what the radio-range model captures."""
    r, k = plan["health"].shape
    drop = rng.random((r, k, k)) < cfg.drop_rate
    drop |= np.swapaxes(drop, 1, 2)               # erasures are symmetric
    plan["link_mask"] *= (~drop).astype(np.float32)


@fault_models.register("crash")
def crash(plan: dict, cfg, rng: np.random.Generator) -> None:
    """Two-state Markov crash/recover schedule per node. A crashed node
    neither sends nor receives (link row+col zeroed at compile time) and
    its parameters freeze for the outage (trainer-side)."""
    r, k = plan["health"].shape
    u = rng.random((r, k))
    alive = np.ones(k, dtype=bool)
    health = np.empty((r, k), dtype=np.float32)
    for t in range(r):
        crashed_now = alive & (u[t] < cfg.crash_rate)
        recovered = ~alive & (u[t] < cfg.recover_rate)
        alive = (alive & ~crashed_now) | recovered
        health[t] = alive
    plan["health"] *= health


@fault_models.register("corrupt")
def corrupt(plan: dict, cfg, rng: np.random.Generator) -> None:
    """i.i.d. per-node per-round wire corruption. The payload mutation
    itself (NaN/Inf fill or exponent bit-flip) happens per round in
    :func:`corrupt_rows`; here we only schedule who fires when."""
    r, k = plan["health"].shape
    plan["corrupt"] = np.maximum(
        plan["corrupt"],
        (rng.random((r, k)) < cfg.corrupt_rate).astype(np.float32))


@fault_models.register("straggle")
def straggle(plan: dict, cfg, rng: np.random.Generator) -> None:
    """i.i.d. per-node per-round stale-buffer replay: a straggler whose
    round-r broadcast is still the round r-1 snapshot."""
    r, k = plan["health"].shape
    plan["straggle"] = np.maximum(
        plan["straggle"],
        (rng.random((r, k)) < cfg.straggle_rate).astype(np.float32))


@fault_models.register("byzantine")
def byzantine(plan: dict, cfg, rng: np.random.Generator) -> None:
    """Fixed adversarial senders: ``sign_flip`` broadcasts the negated
    buffer, ``scale`` a ``byzantine_scale``-times blown-up one. Both stay
    finite, so the wire guard does NOT catch them: they are what the
    robust_rules plugins (trimmed_mean / median) are for."""
    k = plan["health"].shape[1]
    bad = [b for b in cfg.byzantine if b < k]
    if not bad:
        return
    scale = -1.0 if cfg.byzantine_mode == "sign_flip" else cfg.byzantine_scale
    plan["byz"][:, bad] = scale


# Per-kind activity predicates for the BUILT-IN models: a selected kind
# whose rate is zero can never fire, and a config whose every kind is
# inert builds the exact fault-free trainer (bit-identical runs). Unknown
# (user-registered) kinds are conservatively treated as always active.
_KIND_ACTIVE = {
    "link_drop": lambda c: c.drop_rate > 0,
    "crash": lambda c: c.crash_rate > 0,
    "corrupt": lambda c: c.corrupt_rate > 0,
    "straggle": lambda c: c.straggle_rate > 0,
    "byzantine": lambda c: bool(c.byzantine),
}


def config_active(cfg) -> bool:
    """Whether any selected fault kind can ever fire."""
    return any(_KIND_ACTIVE.get(kind, lambda c: True)(cfg)
               for kind in cfg.kinds)


def wire_kinds(cfg) -> tuple:
    """(has_byz, has_corrupt, has_straggle): which per-node WIRE
    behaviors the round must build (straggle also needs the previous
    round's buffer in the state). Unknown plugin kinds conservatively
    enable all three."""
    unknown = any(kind not in _KIND_ACTIVE for kind in cfg.kinds)

    def on(kind):
        return unknown or (kind in cfg.kinds and _KIND_ACTIVE[kind](cfg))

    return on("byzantine"), on("corrupt"), on("straggle")


def compile_plan(cfg, rounds: int, k: int, start: int = 0) -> FaultPlan:
    """Compile ``cfg`` into per-round schedules for rounds
    ``[start, start + rounds)``, generated from round 0 and sliced."""
    total = int(start) + int(rounds)
    plan = {
        "link_mask": np.ones((total, k, k), dtype=np.float32),
        "health": np.ones((total, k), dtype=np.float32),
        "byz": np.ones((total, k), dtype=np.float32),
        "corrupt": np.zeros((total, k), dtype=np.float32),
        "straggle": np.zeros((total, k), dtype=np.float32),
    }
    for kind in cfg.kinds:
        fault_models.get(kind)(plan, cfg, _rng(cfg.seed, kind))
    # crashed nodes neither send nor receive: zero their row and column
    alive = plan["health"]
    plan["link_mask"] = plan["link_mask"] * alive[:, :, None] * alive[:, None, :]
    # a crashed node has no fresh payload to corrupt / attack with this
    # round — health gates the wire schedules too
    plan["corrupt"] *= alive
    plan["byz"] = np.where(alive > 0, plan["byz"], 1.0).astype(np.float32)
    plan["straggle"] *= alive
    return FaultPlan(**{name: arr[start:] for name, arr in plan.items()})


# -- per-round injection / self-healing (tensors, on the device) -------------

def corrupt_rows(sent: torch.Tensor, flags: torch.Tensor,
                 mode: str) -> torch.Tensor:
    """Poison the flagged nodes' wire rows.

    ``nan``/``inf`` fill the row (a mangled frame); ``bitflip`` XORs the
    top exponent bit of every f32 word — values in [1, 2) become Inf,
    small weights become astronomically large but FINITE garbage, which
    is why the wire guard also has a magnitude threshold.
    """
    on = flags[:, None] > 0
    if mode == "nan":
        return torch.where(on, torch.nan, sent)
    if mode == "inf":
        return torch.where(on, torch.inf, sent)
    bits = sent.contiguous().view(torch.int32) ^ 0x40000000
    return torch.where(on, bits.view(torch.float32), sent)


def wire_guard(sent: torch.Tensor, buf: torch.Tensor, eta,
               threshold: float = 1e12):
    """Receive-side self-healing: quarantine poisoned payloads.

    A payload row is *bad* when it holds NaN/Inf or (``threshold > 0``)
    any element above ``threshold`` in magnitude. Quarantine zeroes the
    sender's eta column, renormalizes each receiver row over its
    surviving neighbors to the row's original mass (drained rows fall back
    to a pure self-update), and scrubs the bad rows to the sender's clean
    buffer, so no NaN reaches the mix (0 * NaN is NaN).

    Returns ``(sent_clean, eta_used, quarantined)``, ``quarantined`` the
    (K,) 0/1 indicator. Everything is gated on an ``any_bad`` device flag
    with ``torch.where``: a clean round passes eta and sent through bit for
    bit, and no round reads the device from the host.

    ``eta`` may be a dense (K, K) matrix, a ``topology.SparseEta`` (each
    kept edge gathers its sender's flag, an O(K·D) edit) or a
    ``hierarchy.mixing.HierEta`` (both tiers edited: a quarantined
    leader's cluster skips inter-cluster mixing this round).

    V variants guard at once (the batched sweeps): ``sent``/``buf`` (V, K,
    P) with dense eta (K, K) or (V, K, K), or sparse tables (K, D) or (V,
    K, D); each variant gates on its own payloads, and eta comes back one
    a variant, ``quarantined`` (V, K).
    """
    from repro_torch.core.topology import SparseEta, renormalize_rows

    if hasattr(eta, "intra"):   # HierEta: guard each tier's SparseEta
        sent_clean, intra_used, quarantined = wire_guard(
            sent, buf, eta.intra, threshold)
        _, inter_used, _ = wire_guard(sent, buf, eta.inter, threshold)
        return (sent_clean, eta._replace(intra=intra_used, inter=inter_used),
                quarantined)

    finite = torch.isfinite(sent).all(dim=-1)
    if threshold and threshold > 0:
        blown = torch.nan_to_num(sent.abs(), nan=torch.inf).amax(dim=-1) \
            > threshold
        bad = ~finite | blown
    else:
        bad = ~finite
    # one gate a variant: (1,) for a (K, P) payload, (V, 1) for (V, K, P)
    any_bad = bad.any(dim=-1, keepdim=True)
    if isinstance(eta, SparseEta):
        ok = (~bad).to(eta.val.dtype)
        idx = eta.idx.long().expand(bad.shape[:-1] + eta.idx.shape[-2:])
        ok_edge = torch.gather(ok, -1, idx.flatten(-2)).view(idx.shape)
        masked = eta.val * ok_edge
        val_used = torch.where(any_bad[..., None],
                               renormalize_rows(masked, eta.val.sum(dim=-1)),
                               eta.val)
        eta_used = SparseEta(eta.idx, val_used)
    else:
        ok = (~bad).to(eta.dtype)
        masked = eta * ok[..., None, :]
        eta_used = torch.where(any_bad[..., None],
                               renormalize_rows(masked, eta.sum(dim=-1)), eta)
    sent_clean = torch.where(any_bad[..., None],
                             torch.where(bad[..., None], buf, sent), sent)
    return sent_clean, eta_used, bad.to(torch.float32)
