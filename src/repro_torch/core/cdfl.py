"""C-DFL trainer (paper Algorithm 2), model-agnostic.

One federated round =
  1. the eq. 5 consensus exchange with CND-derived weights (eqs. 5-7) on
     the flat ``(K, P)`` buffer, through the transport (cdfl, cfa,
     metropolis; cdfa_m sends only a column prefix, its first layers) or
     the fedavg server average (kernel B2). The weights come in three
     formats (``FedConfig.mixing_format``): dense ``(K, K)`` eta (kernel
     B1), sparse top-D :class:`topology.SparseEta` (kernel B5), or
     two-tier :class:`hierarchy.mixing.HierEta` (kernels B6 and B5). The
     transport (``FedConfig.transport``) is dense, the ring's two shifted
     copies (plain tensor ops), or bounded-delay gossip, whose neighbor
     terms read a snapshot ``staleness`` rounds old carried in
     ``FedState.tstate`` (kernel B2 dense, B6 sparse);
  2. ``local_steps`` flat-Adam updates (eq. 8) on minibatches gathered on
     the device from the resident datasets.

dpsgd has no once-per-round exchange: it gossips the f32 buffer before
every local step instead, in the config's format (B1, B5, or B6 then B5
without a re-merge burst).

Params live in the flat buffer for the whole run: the forward and
backward read views of it, all K nodes at once, and the gradient of the
summed per-node losses IS the ``(K, P)`` flat gradient (node parameters
are disjoint). ``init`` sketches every node's data in one launch of
kernel B3 and reads the bit counts through kernel B4.

``Trainer.round`` runs one round on the static graph from host-fed
batches (leaves ``(K, S, B, ...)``), as the reference's ``round`` does;
``run_rounds`` is a Python loop over rounds. Round r's exchange reads
slice r of per-round mixing stacks (:func:`mixing_stack`): the static
graph broadcast, or a mobility scenario's radio-range graphs re-derived
every round. Stacks are keyed on the absolute round ``state.round``, so
two segments of a run equal one unsegmented run. It takes an explicit
``(R, K, S, B)`` batch-index stack, so a run can replay the JAX
package's batches exactly, or samples one from a ``torch.Generator``.

Faults (``FedConfig.faults``) compile on the host into per-round
schedules (:mod:`repro_torch.faults.models`): the link mask edits the
stacks once per run, and each round builds what every node puts on the
wire (a straggler's stale replay, an attacker's flipped or scaled buffer,
a corrupted frame), quarantines poisoned payloads, mixes, and afterwards
rolls crashed or diverged nodes back to their round-entry params and Adam
state. Robust mixing (``FedConfig.robust``) replaces eq. 5 with a
coordinate-wise trimmed mean or median over the neighbor payloads (kernel
B7). A round's fault handling gates on device tensors, never on a host
read.

Redundancy-aware ingest (``FedConfig.ingest``) gathers the datasets through
a redundancy scenario's slot map once per run and streams every round's
sampled slots into per-node count-min and HyperLogLog sketches carried in
``FedState.istate`` (:mod:`repro_torch.ingest`). In the reference's order,
a round reads the entry sketch's multiplicities, draws duplicate-corrected
indices from its uniforms (``correct_sampling``), measures the drift
novelty, folds the indices into the sketches and rescales eta's columns by
the distinct-count estimates and the drift discount, before the exchange.

``Trainer.run_rounds_batch`` runs V whole runs at once (the batched fleet
sweeps): a ``(V,)``-stacked state (:func:`stack_states`), the datasets
shared, per-variant batch indices, mixing stacks, step sizes and learning
rates. The V variants' ``(K, P)`` buffers and Adam moments form one ``(V·K,
P)`` buffer, so the forward, the backward and Adam run over V·K node rows in
the launches of one run, and each exchange is one launch for all V: B1 or
B2 with a variant axis (dense), B6 on the ``(V·K, P)`` rows (sparse). B7,
which has no variant axis, runs once a variant. Gossip snapshots and
sketches gain the variant axis too.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import faults as faults_lib
from repro_torch import mobility as mobility_lib
from repro_torch import registry
from repro_torch.configs.base import FedConfig, HierarchyConfig, TrainConfig
from repro_torch.core import flatten, sketch, topology
from repro_torch.core import transport as transport_lib
from repro_torch.device import resolve_device
from repro_torch.faults import robust as robust_lib
from repro_torch.hierarchy import mixing as hier_lib
from repro_torch.ingest import scenarios as ingest_scenarios
from repro_torch.ingest import sketches as ingest_sketches
from repro_torch.ingest import weighting as ingest_weighting
from repro_torch.kernels import ops
from repro_torch.optim.adam import FlatAdamState, flat_adam


class FedState(NamedTuple):
    buf: torch.Tensor             # (K, P) f32 flat params
    layout: flatten.FlatLayout
    opt: FlatAdamState            # (K, P) moments, (K,) step counters
    ratios: torch.Tensor          # (K,) CND distinct ratios Ë_k
    sizes: torch.Tensor           # (K,) raw dataset sizes E_k
    round: int
    # transport state: the (s, K, P) encoded snapshots of stale gossip,
    # else ()
    tstate: Any = ()
    # (K, P) straggle replay buffer (what each node broadcast the round
    # before) when the fault config can straggle, else ()
    fstate: Any = ()
    # the per-node streaming sketches (ingest.sketches.SketchState) when a
    # redundancy scenario is active, else ()
    istate: Any = ()

    @property
    def params(self) -> dict:
        """Node-stacked parameter views of the buffer."""
        return flatten.unflatten(self.buf, self.layout)


class Trainer(NamedTuple):
    init: Callable                # (params, node_items) -> FedState
    round: Callable               # (state, batches) -> (state, metrics)
    eta_fn: Callable              # state -> static eta, the config's format
    mixing: Callable              # state -> static (eta, gamma)
    run_rounds: Callable          # (state, data, R[, idx]) -> (state, metrics)
    device: torch.device
    # (state, R, start) -> per-round (etas, (R,) gammas): dense (R, K, K),
    # SparseEta (R, K, D) or HierEta stacks
    mixing_stack: Callable
    # (states, data, R) -> (states, metrics): V whole runs of a (V,)-stacked
    # state, every metric with a leading (V,) axis
    run_rounds_batch: Callable


def _stack(values):
    """One tensor of stacked tensors, a NamedTuple of them stacked field by
    field, or () for empty states."""
    first = values[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(values)
    if not len(first):
        return ()
    return type(first)(*(_stack(list(f)) for f in zip(*values)))


def _select(tree, i: int):
    """Entry ``i`` of the leading axis of a tensor or of every tensor of a
    NamedTuple; () stays ()."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return type(tree)(*(_select(f, i) for f in tree)) if len(tree) else ()


def stack_states(states) -> FedState:
    """V single-run states of one trainer -> the ``(V,)``-stacked state
    :func:`Trainer.run_rounds_batch` takes: every tensor gains a leading
    variant axis (copied), the round counter becomes a ``(V,)`` int64 CPU
    tensor."""
    states = list(states)
    return FedState(
        _stack([s.buf for s in states]), states[0].layout,
        _stack([s.opt for s in states]), _stack([s.ratios for s in states]),
        _stack([s.sizes for s in states]),
        torch.tensor([int(s.round) for s in states], dtype=torch.int64),
        _stack([s.tstate for s in states]),
        _stack([s.fstate for s in states]),
        _stack([s.istate for s in states]))


def select_state(states: FedState, i: int) -> FedState:
    """Variant ``i`` of a ``(V,)``-stacked state, as a single-run state
    (views of the stacked tensors)."""
    return FedState(states.buf[i], states.layout, _select(states.opt, i),
                    states.ratios[i], states.sizes[i],
                    int(torch.as_tensor(states.round)[i]),
                    _select(states.tstate, i), _select(states.fstate, i),
                    _select(states.istate, i))


def round_slice(stack, r):
    """Round ``r`` (an int or a slice of rounds) of a per-round stack: a
    tensor, or a NamedTuple of them (SparseEta, HierEta, ClusterPlan)
    sliced field by field; None (a HierEta without a plan) stays None."""
    if stack is None:
        return None
    if isinstance(stack, torch.Tensor):
        return stack[r]
    return type(stack)(*(round_slice(f, r) for f in stack))


def _check_indices(idx: torch.Tensor, k: int, what: str) -> None:
    """Neighbor indices must name a node: the kernels gather without a
    range check. Checked once per stack, never per launch."""
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= k):
        raise ValueError(f"{what} indices must lie in [0, {k})")


def _node_sketches(node_items: torch.Tensor, fed: FedConfig):
    """CND ratios of every node: node_items (K, n, f) int32 tokens, all K
    nodes sketched in one kernel launch."""
    k, n = node_items.shape[:2]
    bitmaps = ops.cnd_bitmaps(node_items, fed.cnd_hashes, fed.cnd_bits)
    ests = sketch.cardinality(bitmaps, fed.cnd_estimator)
    totals = torch.full((k,), float(n), dtype=torch.float32,
                        device=node_items.device)
    ratios = torch.clamp(ests / torch.clamp_min(totals, 1.0), 1e-6, 1.0)
    return ratios, totals


def _freeze_rows(new, old, keep: torch.Tensor):
    """Per-node ``where`` over a tuple of tensors whose leading axes are
    those of ``keep`` (the node, or variant and node): rows with ``keep``
    False take their round-entry values."""
    return type(new)(*(
        torch.where(keep.reshape(keep.shape + (1,) * (n.dim() - keep.dim())),
                    n, o) for n, o in zip(new, old)))


def build_trainer(loss_fn: Callable, fed: FedConfig, train: TrainConfig,
                  eval_fn: Optional[Callable] = None, *,
                  device=None) -> Trainer:
    """``loss_fn(params, batch) -> (K,)`` per-node losses, for node-stacked
    parameter views and a batch whose leaves are ``(K, B, ...)``.
    ``eval_fn(params) -> (K,)``, for node-stacked parameter views, adds a
    per-round ``eval`` metric.

    ``device=None`` runs on the card; pass ``device="cpu"`` for the plain
    PyTorch path."""
    dev = resolve_device(device)
    registry.ensure_plugins()
    spec = registry.algorithms.get(fed.algorithm)
    if not spec.uses_transport and (fed.transport, fed.wire_dtype,
                                    fed.staleness) != ("dense", "f32", 0):
        # fedavg averages at a server and dpsgd gossips the f32 buffer
        # every step: reject transport settings rather than silently
        # running something else than what was asked for
        raise ValueError(
            f"{fed.algorithm} does not use the consensus transport "
            f"(fedavg: server average; dpsgd: per-step f32 gossip) "
            f"— got transport={fed.transport}/{fed.wire_dtype}/"
            f"staleness={fed.staleness}")
    k = fed.num_nodes
    fedavg = fed.algorithm == "fedavg"
    dpsgd = fed.algorithm == "dpsgd"
    cdfa_m = fed.algorithm == "cdfa_m"
    topo = "full" if fedavg else fed.topology
    adj_np = topology.adjacency(topo, k)
    adj = torch.as_tensor(adj_np, device=dev)
    mob = fed.mobility
    if mob is not None and mob.kind == "static":
        mob = None
    if mob is not None and fedavg:
        # a server average has no inter-vehicle links to churn
        raise ValueError("fedavg (centralized server average) does not "
                         "model a vehicular topology; mobility requires "
                         "a decentralized algorithm")
    sparse_fmt = fed.mixing_format == "sparse"
    # hierarchy knobs default when the format is selected bare; the intra
    # tier inherits the algorithm's mixing rule unless pinned
    hier_cfg = ((fed.hierarchy or HierarchyConfig())
                if fed.mixing_format == "hierarchical" else None)
    hier_rule = (hier_cfg.intra_rule or spec.mixing) if hier_cfg else None
    transport = (transport_lib.make_transport(fed) if spec.uses_transport
                 else None)
    # Fault injection and robust mixing act on the once-per-round
    # full-buffer wire exchange, which fedavg (server average), dpsgd
    # (per-step gossip) and cdfa_m (prefix-only wire) lack.
    fault_capable = spec.uses_transport and not cdfa_m
    if fed.faults is not None and fed.faults.active and not fault_capable:
        raise ValueError(
            f"{fed.algorithm} has no full-buffer wire exchange to "
            f"inject faults into (fault injection supports the "
            f"transport-routed algorithms: cdfl, cfa, metropolis, ...)")
    # a FaultConfig whose every selected kind has zero rate builds the
    # exact fault-free trainer (bit-identical runs)
    faulty = fed.faults is not None and faults_lib.config_active(fed.faults)
    has_byz, has_corrupt, has_straggle = (
        faults_lib.wire_kinds(fed.faults) if faulty else (False,) * 3)
    robust_fn = robust_lib.make_robust(fed)
    if robust_fn is not None:
        if not fault_capable:
            raise ValueError(
                f"{fed.algorithm} has no full-buffer wire exchange for "
                f"robust aggregation to replace")
        if not isinstance(transport, transport_lib.DenseTransport):
            raise ValueError(
                "robust aggregation needs every neighbor row "
                "materialized: use the dense transport "
                f"(got {type(transport).__name__})")
    # redundancy-aware ingest: scenario="none" (or ingest=None) builds the
    # exact ingest-free trainer (bit-identical runs)
    ingest_cfg = fed.ingest
    ingest_on = ingest_cfg is not None and ingest_cfg.active
    sampling_u = ingest_on and ingest_cfg.correct_sampling
    if ingest_on and (ingest_cfg.reweight_mixing or ingest_cfg.drift_on):
        # the redundancy reweight and the drift discount both rescale eta
        if fedavg:
            raise ValueError(
                "fedavg (centralized server average) has no eta rows "
                "for the redundancy reweight / drift discount to scale; "
                "use IngestConfig(weighting='sampling', "
                "drift_threshold=0) or a decentralized algorithm")
        if robust_fn is not None:
            raise ValueError(
                "robust aggregation ranks neighbor rows by order "
                "statistics — the redundancy eta reweight / drift "
                "discount does not compose with it (use IngestConfig("
                "weighting='sampling'|'none', drift_threshold=0))")
    ingest_plans: dict = {}     # N -> (IngestPlan on the device, hashes)
    fopt = flat_adam(train.learning_rate, train.beta1, train.beta2,
                     train.eps, train.weight_decay, train.grad_clip)

    def init(params, node_items, same_init: bool = True) -> FedState:
        """``params``: one node's parameter tree (dicts and lists of
        tensors), broadcast to all K nodes (``same_init``), or node-stacked
        ``(K, ...)`` leaves.
        ``node_items``: (K, n, f) int32 CND feature tokens."""
        leaves = flatten.tree_map(lambda v: torch.as_tensor(v, device=dev),
                                  params)
        if same_init:
            leaves = flatten.tree_map(
                lambda v: v.expand((k,) + tuple(v.shape)), leaves)
        buf, layout = flatten.flatten(leaves)
        if layout.num_nodes != k:
            raise ValueError(f"params hold {layout.num_nodes} nodes, the "
                             f"config {k}")
        items = torch.as_tensor(node_items, device=dev).to(
            torch.int32).contiguous()
        if items.dim() != 3 or items.shape[0] != k:
            raise ValueError(f"node_items must be (K={k}, n, f), got "
                             f"{tuple(items.shape)}")
        ratios, sizes = _node_sketches(items, fed)
        tstate = ()
        if transport is not None:
            # cdfa_m's wire carries only the leaf prefix
            tstate = transport.init_state(
                buf[:, :flatten.prefix_length(layout, fed.cdfa_fraction)]
                if cdfa_m else buf)
        # a round-0 straggler replays the init broadcast
        fstate = buf if has_straggle else ()
        istate = (ingest_sketches.init_state(k, ingest_cfg, dev)
                  if ingest_on else ())
        return FedState(buf, layout, fopt.init(buf), ratios, sizes, 0, tstate,
                        fstate, istate)

    def eta_fn(state: FedState):
        """The static graph's weights in the config's format: dense
        ``(K, K)`` eta (the reference's ``eta_fn``), its top-D
        ``SparseEta``, or a ``HierEta``."""
        return mixing(state)[0]

    def mixing(state: FedState, cap: Optional[float] = None):
        """The static graph's weights in the config's format, and gamma
        under the step-size cap ``cap`` (default the config's)."""
        cap = fed.gamma if cap is None else cap
        if hier_cfg is not None:
            return hier_lib.hier_static_stacks(
                adj_np, rule=hier_rule, ratios=state.ratios,
                sizes=state.sizes, gamma_cap=cap,
                max_cluster_size=hier_cfg.max_cluster_size,
                leader_policy=hier_cfg.leader_policy,
                inter_degree=hier_cfg.inter_degree,
                hysteresis=hier_cfg.hysteresis)
        eta = topology.mixing_weights(adj, spec.mixing, ratios=state.ratios,
                                      sizes=state.sizes)
        gamma = topology.stable_gamma(eta, cap)
        if sparse_fmt:
            # sparsify AFTER the stability bound: the top-D renorm keeps
            # the row sums, so the dense bound is the sparse one's
            return topology.sparsify_eta(eta, fed.degree), gamma
        return eta, gamma

    def mixing_stack(state: FedState, num_rounds: int, start: int = 0, *,
                     mobility="config", gamma_cap: Optional[float] = None):
        """Per-round weights for rounds ``[start, start + num_rounds)``:
        dense ``(R, K, K)`` eta, a ``SparseEta`` with ``(R, K, D)`` stacks
        or a ``HierEta``, and ``(R,)`` gamma. The static graph is
        broadcast; a mobility scenario re-derives the radio-range graph
        every round from the trace generated from round 0. Host work
        (traces, links, clusters) happens here, once per call.

        ``mobility`` / ``gamma_cap`` override the config's scenario and
        step-size cap for THIS stack only, as batched sweeps build
        per-variant stacks against one shared trainer (the sentinel
        ``"config"`` keeps ``fed.mobility``; ``None`` forces the static
        graph)."""
        m = mob if mobility == "config" else mobility
        if m is not None and m.kind == "static":
            m = None
        cap = fed.gamma if gamma_cap is None else float(gamma_cap)
        if m is None:
            eta, gamma = mixing(state, cap)
            if hier_cfg is not None:
                return hier_lib.constant_hier_stacks(eta, gamma, num_rounds)
            if sparse_fmt:
                return mobility_lib.constant_sparse_stacks(eta, gamma,
                                                           num_rounds)
            return mobility_lib.constant_stacks(eta, gamma, num_rounds)
        side = dict(ratios=state.ratios, sizes=state.sizes, start=start)
        if hier_cfg is not None:
            return hier_lib.hier_scenario_stacks(
                m, num_rounds, k, rule=hier_rule, gamma_cap=cap,
                max_cluster_size=hier_cfg.max_cluster_size,
                leader_policy=hier_cfg.leader_policy,
                inter_degree=hier_cfg.inter_degree,
                hysteresis=hier_cfg.hysteresis, **side)
        if sparse_fmt:
            # ring+sparse is refused at config validation, so no mask
            return mobility_lib.sparse_scenario_stacks(
                m, num_rounds, k, rule=spec.mixing, gamma_cap=cap,
                degree=fed.degree, **side)
        # the ring transport carries only ring links
        mask = (topology.adjacency("ring", k) if isinstance(
            transport, transport_lib.RingShardTransport) else None)
        return mobility_lib.scenario_stacks(
            m, num_rounds, k, rule=spec.mixing, gamma_cap=cap, mask=mask,
            **side)

    def explicit_stacks(eta_stack, gamma_stack):
        """A caller's per-round stacks on the device, with gammas derived
        from the stability bound when omitted. Indices are checked here,
        once per stack."""
        f32 = dict(dtype=torch.float32, device=dev)

        def sparse(sp):
            idx = torch.as_tensor(sp.idx, device=dev).to(torch.int32)
            _check_indices(idx, k, "sparse eta")
            return topology.SparseEta(idx.contiguous(),
                                      torch.as_tensor(sp.val, **f32))

        if isinstance(eta_stack, hier_lib.HierEta):
            cluster = torch.as_tensor(eta_stack.cluster, device=dev).long()
            _check_indices(cluster, k, "cluster")
            intra_plan = getattr(eta_stack, "plan", None)
            if intra_plan is not None:
                intra_plan = type(intra_plan)(*(
                    torch.as_tensor(t, device=dev).to(torch.int32)
                    .contiguous() for t in intra_plan))
            etas = hier_lib.HierEta(
                cluster, sparse(eta_stack.intra),
                torch.as_tensor(eta_stack.gamma_node, **f32),
                sparse(eta_stack.inter),
                torch.as_tensor(eta_stack.burst, dtype=torch.float32,
                                device="cpu"), intra_plan)
            derive = hier_lib.hier_gamma_stack
        elif isinstance(eta_stack, topology.SparseEta):
            etas = sparse(eta_stack)
            derive = mobility_lib.sparse_gamma_stack
        else:
            etas = torch.as_tensor(eta_stack, **f32)
            derive = mobility_lib.gamma_stack
        if gamma_stack is None:
            return etas, derive(etas, fed.gamma)
        return etas, torch.as_tensor(gamma_stack, **f32)

    def check_stacks(etas, gammas, num_rounds: int) -> None:
        """The reference's shape checks on per-round stacks."""
        if isinstance(etas, hier_lib.HierEta):
            if hier_cfg is None:
                raise ValueError(
                    "a hierarchical eta stack needs "
                    "mixing_format='hierarchical'")
            if (tuple(etas.cluster.shape) != (num_rounds, k)
                    or tuple(etas.gamma_node.shape) != (num_rounds, k)
                    or tuple(etas.burst.shape) != (num_rounds,)):
                raise ValueError(
                    f"hierarchical stack shapes cluster="
                    f"{tuple(etas.cluster.shape)} gamma_node="
                    f"{tuple(etas.gamma_node.shape)} burst="
                    f"{tuple(etas.burst.shape)} != {(num_rounds, k)} / "
                    f"{(num_rounds,)}")
            if (etas.plan is not None and tuple(etas.plan.pos.shape)
                    != tuple(etas.intra.idx.shape)):
                raise ValueError(
                    f"hierarchical stack plan pos "
                    f"{tuple(etas.plan.pos.shape)} != intra idx "
                    f"{tuple(etas.intra.idx.shape)}")
        elif hier_cfg is not None:
            raise ValueError(
                "mixing_format='hierarchical' needs a HierEta stack "
                f"(got {type(etas).__name__}); build one with "
                "repro_torch.hierarchy.mixing or omit eta_stack")
        elif isinstance(etas, topology.SparseEta):
            want = (num_rounds, k, etas.degree)
            if (tuple(etas.idx.shape) != want
                    or tuple(etas.val.shape) != want):
                raise ValueError(
                    f"sparse eta stack shapes idx={tuple(etas.idx.shape)} "
                    f"val={tuple(etas.val.shape)} != {want}")
        elif tuple(etas.shape) != (num_rounds, k, k):
            raise ValueError(f"eta stack shape {tuple(etas.shape)} != "
                             f"{(num_rounds, k, k)}")
        if tuple(gammas.shape) != (num_rounds,):
            raise ValueError(f"gamma stack shape {tuple(gammas.shape)} != "
                             f"{(num_rounds,)}")

    def mix_buf(buf, sizes, eta, gamma, layout, tstate, rnd, sent=None):
        """The round's exchange. ``sent`` (fault injection) overrides the
        per-node wire payloads; ``None`` means every node broadcasts its
        clean buffer. A ``(V, K, P)`` buffer (``sizes`` (V, K), ``gamma``
        (V,)) exchanges V variants at once."""
        if fedavg:
            # server average with weights E_i / sum E
            w = sizes / sizes.sum(dim=-1, keepdim=True)
            a = w[..., None, :].expand(w.shape[:-1] + (k, k)).contiguous()
            return flatten.apply_matrix_flat(buf, a), tstate
        if cdfa_m:
            # C-DFA(M): only the leaf-prefix columns travel the wire (with
            # the codec); the strided prefix is copied once for the kernel
            prefix = flatten.prefix_length(layout, fed.cdfa_fraction)
            head, tstate = transport.exchange(
                buf[..., :prefix].contiguous(), eta, gamma, tstate, rnd)
            return torch.cat([head, buf[..., prefix:]], dim=-1), tstate
        if hier_cfg is not None:
            # two-tier cluster consensus: the intra tier's neighbor terms
            # read the (possibly fault-overridden) wire payloads, its self
            # term the node's own clean payload; the leader tier and the
            # bursts read the f32 buffer
            if sent is None:
                wire = wself = transport.wire(buf)
            else:
                wire = transport.codec.encode(sent)
                wself = transport.codec.encode(buf)
            return hier_lib.hier_mix_flat(
                buf, eta, gamma, wire=wire, wire_self=wself,
                burst_passes=hier_cfg.remerge_burst), tstate
        if robust_fn is not None:
            # order-statistic consensus over the neighborhood payloads
            # (codec'd like any wire traffic) instead of eq. 5
            payload = transport.codec.roundtrip(buf if sent is None
                                                else sent)
            if buf.dim() == 3:
                # B7 has no variant axis: one launch a variant, on its rows
                return torch.stack([
                    robust_fn(buf[i], payload[i],
                              eta if eta.dim() == 2 else eta[i], gamma[i])
                    for i in range(buf.shape[0])]), tstate
            return robust_fn(buf, payload, eta, gamma), tstate
        return transport.exchange(buf, eta, gamma, tstate, rnd, sent=sent)

    def gossip(buf, eta, gamma):
        """dpsgd's per-step mix of the f32 buffer in the config's format.
        No re-merge burst per step: dpsgd already mixes ``local_steps``
        times a round, which is the catch-up."""
        if hier_cfg is not None:
            return hier_lib.hier_mix_flat(buf, eta, gamma, burst_passes=0)
        if sparse_fmt and buf.dim() == 3:
            return flatten.sparse_mix_variants(buf, eta.idx, eta.val, gamma)
        if sparse_fmt:
            return flatten.sparse_mix_flat(buf, eta.idx, eta.val, gamma)
        return flatten.mix_flat(buf, eta, gamma)

    def local_steps(carry, layout, batch_at, n_steps, mix=None, adam=fopt):
        """``n_steps`` Adam steps of every node on the batches
        ``batch_at(s)`` (leaves (K, B, ...)), from ``carry = [buf, opt]``,
        which is emptied: the caller keeps no reference, so each step's
        new buffers replace the last ones in memory. For dpsgd (``mix``
        given) each step first gossips the buffer through ``mix``, and the
        loss is the mean over nodes and steps, broadcast to every node.

        A ``(V, K, P)`` buffer of V variants runs as ``(V·K, P)`` node
        rows through the forward and backward (batch leaves ``(V·K, B,
        ...)``); ``adam`` may carry per-variant learning rates."""
        buf, opt = carry
        carry.clear()
        loss_sum = torch.zeros(buf.shape[:-1], dtype=torch.float32,
                               device=dev)
        for s in range(n_steps):
            if mix is not None:
                buf = mix(buf)
            batch = batch_at(s)
            p = buf.reshape(-1, buf.shape[-1]).detach().requires_grad_(True)
            with torch.enable_grad():
                losses = loss_fn(flatten.unflatten(p, layout), batch)
                (grad,) = torch.autograd.grad(losses.sum(), p)
            with torch.no_grad():
                buf, opt = adam.update(grad.view(buf.shape), opt, buf)
            loss_sum += losses.detach().view(loss_sum.shape)
        loss = loss_sum / n_steps
        if mix is not None:
            loss = loss.mean(dim=-1, keepdim=True).expand(loss.shape)
        return buf, opt, loss

    def gathered(data, idx_r):
        """``batch_at`` of one round's (K, S, B) indices into the resident
        datasets, or of V variants' (V, K, S, B): leaves (K, B, ...) or
        (V·K, B, ...), row ``v·K + k`` node k's items at variant v's
        indices."""
        rows = torch.arange(k, device=dev)[:, None]
        lead = idx_r.dim() - 3
        return lambda s: {name: arr[rows, idx_r[..., s, :]].flatten(0, lead)
                          for name, arr in data.items()}

    def round_fn(state: FedState, batches: dict):
        """One round on the static graph from host-fed ``batches`` (leaves
        ``(K, S, B, ...)``: node, local step, batch, with S and B the
        config's): ``run_rounds`` over one round whose indices walk the
        batches in order. Returns the state and that round's metrics
        (``loss`` (K,), ``disagreement``, ``gamma``, ...)."""
        if mob is not None:
            raise ValueError(
                "FedConfig.mobility is set but Trainer.round trains on "
                "the frozen static graph — time-varying topologies ride "
                "the run_rounds scan")
        if faulty:
            raise ValueError(
                "FedConfig.faults is set but Trainer.round drives one "
                "round at a time — fault schedules (and the in-scan "
                "self-healing guard) ride the run_rounds scan")
        if ingest_on:
            raise ValueError(
                "FedConfig.ingest is set but Trainer.round drives one "
                "round at a time — the streaming-redundancy sketches "
                "ride the run_rounds scan")
        batches = {name: torch.as_tensor(v) for name, v in batches.items()}
        steps, size = fed.local_steps, train.batch_size
        for name, v in batches.items():
            if tuple(v.shape[:3]) != (k, steps, size):
                raise ValueError(
                    f"batches[{name!r}] leads with {tuple(v.shape[:3])}, "
                    f"not (K, local_steps, batch_size) = {(k, steps, size)}")
        data = {name: v.reshape((k, steps * size) + tuple(v.shape[3:]))
                for name, v in batches.items()}
        idx = torch.arange(steps * size).view(1, 1, steps, size).expand(
            1, k, steps, size)
        state, metrics = run_rounds(state, data, 1, idx=idx)
        return state, {name: v[0] for name, v in metrics.items()}

    def item_counts(n_items, max_items: int):
        """``n_items`` as a checked (K,) int64 CPU tensor, or None."""
        if n_items is None:
            return None
        n_items = torch.as_tensor(n_items).to(torch.int64).cpu()
        if (tuple(n_items.shape) != (k,) or int(n_items.min()) < 1
                or int(n_items.max()) > max_items):
            raise ValueError(
                f"n_items must be (K={k},) counts in [1, {max_items}], "
                f"got {n_items.tolist()}")
        return n_items

    def draw_indices(shape, generator, n_items, max_items: int):
        """(R, K, S, B) batch indices from ``generator`` (default: a CPU
        generator seeded with ``train.seed + 1``): uniform over the
        resident items, or over each node's ``n_items`` as the JAX package
        draws them (a uniform ``u`` maps to ``min(floor(u * n_k), n_k -
        1)``). Under duplicate-corrected ingest sampling, the f32 uniforms
        themselves: each round maps them through its sketch's weights."""
        if generator is None:
            generator = torch.Generator().manual_seed(train.seed + 1)
        if sampling_u:
            return torch.rand(shape, generator=generator,
                              device=generator.device)
        if n_items is None:
            return torch.randint(0, max_items, shape, generator=generator,
                                 device=generator.device)
        u = torch.rand(shape, generator=generator, device=generator.device)
        n = n_items.to(u.device)[:, None, None]
        return torch.minimum((u * n).to(torch.int64), n - 1)

    def checked_indices(idx, shape, max_items: int, n_items):
        """A caller's (..., K, S, B) batch indices, checked against
        ``shape``, the resident items and ``n_items``, on the device; under
        duplicate-corrected ingest sampling, uniforms in [0, 1), as f32."""
        idx = torch.as_tensor(idx)
        if tuple(idx.shape) != shape:
            raise ValueError(f"batch index stack {tuple(idx.shape)} != "
                             f"{shape}")
        if sampling_u:
            if (not idx.is_floating_point() or float(idx.min()) < 0.0
                    or float(idx.max()) >= 1.0):
                raise ValueError(
                    "duplicate-corrected ingest sampling takes uniforms "
                    "in [0, 1) in place of batch indices")
            return idx.to(device=dev, dtype=torch.float32)
        if int(idx.min()) < 0 or int(idx.max()) >= max_items:
            raise ValueError(f"batch indices must lie in [0, {max_items})")
        if n_items is not None:
            over = idx.cpu() >= n_items[:, None, None]
            if bool(over.any()):
                node = int(over.nonzero()[0, -3])
                raise ValueError(
                    f"batch indices of node {node} must lie in "
                    f"[0, {int(n_items[node])}), its item count")
        return idx.to(device=dev, dtype=torch.int64)

    def ingest_inputs(data: dict, max_items: int):
        """The datasets gathered through the redundancy scenario's slot
        map, and the slots' sketch coordinates. Both are deterministic in
        (config, K, N), so resumed segments rebuild the same streams; the
        plan and the hashes are cached per N, a segment pays the gather."""
        if max_items not in ingest_plans:
            plan = ingest_scenarios.compile_plan(ingest_cfg, k, max_items)
            plan = ingest_scenarios.IngestPlan(*(
                torch.as_tensor(a, device=dev).long() for a in plan))
            ingest_plans[max_items] = (plan, ingest_sketches.slot_hashes(
                plan.item_ids, ingest_cfg))
        plan, hashes = ingest_plans[max_items]
        return ingest_scenarios.apply_plan(data, plan), hashes

    def ingest_round(ist, hashes, idx_r, eta_r, n_items, max_items: int):
        """One round of the streaming sketches, in the reference's order:
        the ENTRY sketch's multiplicities give the duplicate-corrected
        indices of this round's uniforms and the drift novelty (gated on
        the sketch having streamed anything, so the empty round-0
        counters read as no drift), the final indices fold into the
        sketches, and the new distinct estimates reweight eta's columns,
        then the drift discount scales them. Returns (indices, eta,
        sketches, estimates, novelty or None)."""
        mult = novelty = None
        if ingest_cfg.correct_sampling:
            mult = ingest_sketches.multiplicity(ist.cm, hashes.buckets)
            w = ingest_weighting.sampling_weights(mult, n_items, max_items)
            idx_r = ingest_weighting.weighted_indices(idx_r, w)
        if ingest_cfg.drift_on:
            if mult is None:
                mult = ingest_sketches.multiplicity(ist.cm, hashes.buckets)
            novelty = torch.where(
                ist.seen > 0, ingest_weighting.drift_novelty(mult, idx_r),
                0.0)
        ist = ingest_sketches.update(ist, hashes, idx_r,
                                     decay=ingest_cfg.decay)
        est = ingest_sketches.hll_cardinality(ist.hll)
        if ingest_cfg.reweight_mixing:
            eta_r = ingest_weighting.reweight_eta(eta_r, est,
                                                  ingest_cfg.spread_gate)
        if ingest_cfg.drift_on:
            disc = (0.0 if ingest_cfg.drift_mode == "reset"
                    else ingest_cfg.drift_discount)
            scale = torch.where(novelty > ingest_cfg.drift_threshold, disc,
                                1.0)
            eta_r = ingest_weighting.scale_eta_columns(eta_r, scale)
        return idx_r, eta_r, ist, est, novelty

    def run_rounds(state: FedState, data: dict, num_rounds: int,
                   idx=None, generator: Optional[torch.Generator] = None,
                   eta_stack=None, gamma_stack=None, n_items=None):
        """Run ``num_rounds`` rounds from ``state`` (which is left as it
        was). ``data``: node-stacked datasets, leaves (K, N, ...), moved
        to and kept on the device. ``idx``: (R, K, S, B) per-round batch
        indices; when omitted they are drawn from ``generator`` (default:
        a CPU generator seeded with ``train.seed + 1``).

        ``n_items``: optional (K,) per-node valid item counts when the
        datasets are padded to a common N (ragged nodes, e.g. after
        :func:`repro_torch.data.redundancy.cnd_dedup`). Drawn indices are
        then uniform over each node's own count, as the JAX package draws
        them (a uniform ``u`` maps to ``min(floor(u * n_k), n_k - 1)``),
        and explicit indices must lie below it.

        ``eta_stack``: explicit per-round weights overriding
        :func:`mixing_stack` (round r uses slice r): a dense (R, K, K)
        array, a ``SparseEta`` with (R, K, D) stacks, or a ``HierEta``
        under ``mixing_format='hierarchical'``. ``gamma_stack``: (R,) step
        sizes; derived from the stacks' stability bound when omitted.

        Returns (state, metrics): ``loss`` (R, K), ``disagreement`` (R,)
        and ``gamma`` (R,); under the hierarchical format also
        ``gamma_intra`` (R,) and ``clusters`` (R,); with ``eval_fn``,
        ``eval`` (R, K); under faults, ``health``, ``quarantined`` and
        ``frozen`` (R, K); under ingest, ``est_distinct`` (R, K) and with
        drift detection ``drift`` (R, K).

        Under duplicate-corrected ingest sampling (``IngestConfig.
        weighting`` "sampling" or "both") ``idx`` holds (R, K, S, B) f32
        uniforms in [0, 1) in place of indices (drawn from ``generator``
        when omitted): round r maps them through its sketch's weights, as
        the JAX package maps the uniforms it draws."""
        data = {name: torch.as_tensor(v, device=dev)
                for name, v in data.items()}
        max_items = next(iter(data.values())).shape[1]
        shape = (num_rounds, k, fed.local_steps, train.batch_size)
        n_items = item_counts(n_items, max_items)
        if idx is None:
            idx = draw_indices(shape, generator, n_items, max_items)
        idx = checked_indices(idx, shape, max_items, n_items)
        if ingest_on:
            data, hashes = ingest_inputs(data, max_items)
            n_dev = None if n_items is None else n_items.to(dev)
        if eta_stack is None:
            etas, gammas = mixing_stack(state, num_rounds, start=state.round)
            if gamma_stack is not None:
                gammas = torch.as_tensor(gamma_stack, dtype=torch.float32,
                                         device=dev)
        else:
            etas, gammas = explicit_stacks(eta_stack, gamma_stack)
        check_stacks(etas, gammas, num_rounds)
        plan = None
        if faulty:
            # this segment's absolute rounds (generated from round 0 and
            # sliced); the surviving-link mask edits the stacks once. Rows
            # only lose mass, so the gammas of the unmasked stacks stay
            # within the stability bound.
            plan = faults_lib.compile_plan(fed.faults, num_rounds, k,
                                           start=state.round)
            mask = torch.as_tensor(plan.link_mask, device=dev)
            if isinstance(etas, hier_lib.HierEta):
                etas = hier_lib.masked_hier_stack(etas, mask)
            elif isinstance(etas, topology.SparseEta):
                etas = mobility_lib.masked_sparse_stack(etas, mask)
            else:
                etas = mobility_lib.masked_eta_stack(etas, mask)
            del mask
            health, byz, corrupt, straggle = (
                torch.as_tensor(a, device=dev) for a in
                (plan.health, plan.byz, plan.corrupt, plan.straggle))
        # every update below is out of place, so ``state`` stays as it was
        buf, opt, tstate = state.buf, state.opt, state.tstate
        prev, ist = state.fstate, state.istate
        if faulty and has_straggle and not isinstance(prev, torch.Tensor):
            prev = buf
        series = {name: [] for name in (
            "loss", "disagreement", "gamma_intra", "clusters", "eval",
            "est_distinct", "drift", "health", "quarantined", "frozen")}
        for r in range(num_rounds):
            eta_r = round_slice(etas, r)
            idx_r = idx[r]
            if ingest_on:
                idx_r, eta_r, ist, est, novelty = ingest_round(
                    ist, hashes, idx_r, eta_r, n_dev, max_items)
                series["est_distinct"].append(est)
                if novelty is not None:
                    series["drift"].append(novelty)
            sent = None
            if faulty:
                # what each node puts on the wire this round: its fresh
                # buffer, a straggler's stale replay, an attacker's
                # flipped/scaled version, a corrupted frame, in that order
                sent = buf
                if has_straggle:
                    sent = torch.where(straggle[r][:, None] > 0, prev, sent)
                if has_byz:
                    sent = sent * byz[r][:, None]
                if has_corrupt:
                    sent = faults_lib.corrupt_rows(
                        sent, corrupt[r], fed.faults.corrupt_mode)
                # receive-side self-healing before anything mixes
                sent, eta_r, quarantined = faults_lib.wire_guard(
                    sent, buf, eta_r, fed.faults.guard_threshold)
            # the round-entry params and Adam state that a faulted round
            # rolls back to; a fault-free round keeps no reference, so the
            # previous round's buffers are freed as this one replaces them
            # (three (K, P) buffers: 17 GB at qwen3-1.7b's width on K=2)
            entry_buf, entry_opt = (buf, opt) if faulty else (None, None)
            if dpsgd:
                # no once-per-round exchange: the gossip runs inside the
                # step loop (dpsgd takes no faults, so sent is None)
                carry = [buf, opt]
                del buf, opt
                buf, opt, loss = local_steps(
                    carry, state.layout, gathered(data, idx_r),
                    fed.local_steps,
                    mix=lambda b: gossip(b, eta_r, gammas[r]))
            else:
                buf, tstate = mix_buf(buf, state.sizes, eta_r, gammas[r],
                                      state.layout, tstate, state.round + r,
                                      sent=sent)
                carry = [buf, opt]
                del buf, opt
                buf, opt, loss = local_steps(
                    carry, state.layout, gathered(data, idx_r),
                    fed.local_steps)
            series["loss"].append(loss)
            series["disagreement"].append(
                flatten.disagreement_flat(buf, state.layout.total))
            if hier_cfg is not None:
                # what the clusters ran at, and how many there were
                series["gamma_intra"].append(eta_r.gamma_node.mean())
                series["clusters"].append(torch.zeros(
                    k, device=dev).index_fill_(0, eta_r.cluster, 1.0).sum())
            if eval_fn is not None:
                with torch.no_grad():
                    series["eval"].append(
                        eval_fn(flatten.unflatten(buf, state.layout)))
            if faulty:
                # crashed nodes freeze for the outage (their eta row and
                # column were zeroed, so the mix was a pure self-update);
                # nodes whose buffer went non-finite roll back to their
                # round-entry params and Adam state, step counters too
                finite = torch.isfinite(buf).all(dim=1)
                keep = (health[r] > 0) & finite
                buf = torch.where(keep[:, None], buf, entry_buf)
                opt = _freeze_rows(opt, entry_opt, keep)
                series["health"].append(health[r])
                series["quarantined"].append(quarantined)
                series["frozen"].append(
                    ((health[r] > 0) & ~finite).to(torch.float32))
                if has_straggle:
                    # next round's stale replay is what was broadcast now
                    prev = entry_buf
        metrics = {name: torch.stack(v) for name, v in series.items() if v}
        metrics["gamma"] = gammas.clone()
        final = FedState(buf, state.layout, opt, state.ratios, state.sizes,
                         state.round + num_rounds, tstate, prev, ist)
        return final, metrics

    def variant_indices(rngs, v: int, shape, n_items, max_items: int):
        """(V, R, K, S, B) batch indices: variant v's drawn as
        :func:`run_rounds` draws them from ``rngs[v]`` (a generator or a
        seed); one generator or seed, or None (seed ``train.seed + 1``),
        draws once for every variant."""
        def gen(r):
            if r is None or isinstance(r, torch.Generator):
                return r
            return torch.Generator().manual_seed(int(r))

        if rngs is None or isinstance(rngs, (int, torch.Generator)):
            one = draw_indices(shape, gen(rngs), n_items, max_items)
            return one.expand((v,) + shape)
        rngs = list(rngs)
        if len(rngs) != v:
            raise ValueError(f"rngs leading dim {len(rngs)} != V={v} "
                             f"variants")
        return torch.stack([draw_indices(shape, gen(r), n_items, max_items)
                            for r in rngs])

    def variant_stacks(states, num_rounds, start, v, eta_stacks,
                       gamma_stacks):
        """(etas, (V, R) gammas, shared): the config's own stacks, shared by
        every variant, or a caller's, shared ``(R, ...)`` or one a variant
        ``(V, R, ...)``, with the reference's checks."""
        f32 = dict(dtype=torch.float32, device=dev)
        if eta_stacks is None:
            etas, gammas = mixing_stack(select_state(states, 0), num_rounds,
                                        start=start)
            shared = True
        elif isinstance(eta_stacks, topology.SparseEta):
            if not sparse_fmt:
                raise ValueError(
                    "a SparseEta stack needs mixing_format='sparse'")
            idx = torch.as_tensor(eta_stacks.idx, device=dev).to(torch.int32)
            _check_indices(idx, k, "sparse eta")
            etas = topology.SparseEta(idx.contiguous(),
                                      torch.as_tensor(eta_stacks.val, **f32))
            shared = etas.idx.dim() == 3
            d = etas.idx.shape[-1]
            expect = ((num_rounds, k, d) if shared
                      else (v, num_rounds, k, d))
            if (tuple(etas.idx.shape) != expect
                    or tuple(etas.val.shape) != expect):
                raise ValueError(
                    f"sparse eta stacks idx={tuple(etas.idx.shape)} "
                    f"val={tuple(etas.val.shape)} != {expect}")
            gammas = gamma_stacks
            if gammas is None:
                gammas = (mobility_lib.sparse_gamma_stack(etas, fed.gamma)
                          if shared else torch.stack([
                              mobility_lib.sparse_gamma_stack(
                                  topology.SparseEta(i, x), fed.gamma)
                              for i, x in zip(etas.idx, etas.val)]))
        else:
            etas = torch.as_tensor(eta_stacks, **f32)
            if sparse_fmt:
                raise ValueError(
                    "mixing_format='sparse' needs SparseEta stacks "
                    f"(got dense array {tuple(etas.shape)})")
            shared = etas.dim() == 3
            expect = ((num_rounds, k, k) if shared
                      else (v, num_rounds, k, k))
            if tuple(etas.shape) != expect:
                raise ValueError(f"eta stacks shape {tuple(etas.shape)} != "
                                 f"{expect}")
            gammas = gamma_stacks
            if gammas is None:
                gammas = (mobility_lib.gamma_stack(etas, fed.gamma) if shared
                          else torch.stack([mobility_lib.gamma_stack(
                              e, fed.gamma) for e in etas]))
        # gammas are small: always a (V, R) stack
        gammas = torch.as_tensor(gammas, **f32)
        if gammas.dim() == 1:
            gammas = gammas[None].expand(v, num_rounds)
        if tuple(gammas.shape) != (v, num_rounds):
            raise ValueError(f"gamma stacks shape {tuple(gammas.shape)} != "
                             f"{(v, num_rounds)}")
        return etas, gammas, shared

    def run_rounds_batch(states: FedState, data: dict, num_rounds: int, *,
                         rngs=None, n_items=None, eta_stacks=None,
                         gamma_stacks=None, lrs=None, idx=None):
        """Batched multi-round driver: V whole runs at once, the
        fleet-sweep twin of :func:`run_rounds`. Every round runs the
        launches of one round of one run, over V·K node rows.

        states: a (V,)-stacked FedState (:func:`stack_states`), left as it
               was. All variants must sit at the same round.
        data:  ONE node-stacked dataset dict, SHARED by every variant.
        rngs:  per-variant batch-sampling generators or seeds (a sequence
               of V), or one, broadcast (default: seed ``train.seed +
               1``): variant v draws the indices a single run with
               ``generator=rngs[v]`` draws, so a batched run reproduces V
               single runs.
        idx:   explicit (V, R, K, S, B) batch indices in place of the drawn
               ones (port-only, as :func:`run_rounds` takes (R, K, S, B)).
        eta_stacks: per-variant mixing stacks — dense ``(V, R, K, K)`` or
               ``SparseEta`` with ``(V, R, K, D)`` stacks — or ONE shared
               ``(R, K, K)`` / ``(R, K, D)`` stack; ``None`` derives the
               config's own shared stacks via :func:`mixing_stack`.
        gamma_stacks: ``(V, R)`` / ``(R,)`` per-round step sizes; derived
               from ``eta_stacks`` via the stability bound when omitted.
        lrs:   optional (V,) per-variant learning rates; ``None`` keeps the
               TrainConfig rate.

        One fault plan (the config's) is shared by every variant: its link
        mask folds into each variant's stacks, and the wire guard, the
        freeze and the straggle replay act per variant.

        ``loss_fn`` sees the V·K node rows at once (params and batch leaves
        ``(V·K, ...)``); ``eval_fn`` is called once a variant, on that
        variant's ``(K, ...)`` views. Each variant streams its own ingest
        sketches (``idx`` then holds (V, R, K, S, B) uniforms under
        duplicate-corrected sampling, as in :func:`run_rounds`).

        Returns ``(final_states, metrics)``, every metric with a leading
        (V,) axis: ``loss`` (V, R, K), ``disagreement`` and ``gamma`` (V,
        R); with ``eval_fn`` ``eval`` (V, R, K); under faults ``health``,
        ``quarantined`` and ``frozen`` (V, R, K); under ingest
        ``est_distinct`` and with drift detection ``drift`` (V, R, K)."""
        if hier_cfg is not None:
            raise ValueError(
                "batched execution does not support mixing_format="
                "'hierarchical' yet — the two-tier HierEta stacks carry "
                "per-round cluster geometry that differs per variant "
                "(recorded ROADMAP follow-on); run hierarchical sweeps "
                "one variant at a time")
        rounds = torch.as_tensor(states.round).cpu()
        if rounds.dim() != 1:
            raise ValueError(
                "run_rounds_batch needs a (V,)-stacked FedState — stack "
                f"init results along a leading variant axis (round "
                f"counter has shape {tuple(rounds.shape)})")
        v = rounds.shape[0]
        if not bool((rounds == rounds[0]).all()):
            raise ValueError(
                f"all variants must sit at the same round to share one "
                f"scan (got rounds {rounds.tolist()})")
        start = int(rounds[0])
        if tuple(states.buf.shape[:2]) != (v, k):
            raise ValueError(f"stacked params {tuple(states.buf.shape)} do "
                             f"not lead with (V={v}, K={k})")
        data = {name: torch.as_tensor(x, device=dev)
                for name, x in data.items()}
        max_items = next(iter(data.values())).shape[1]
        shape = (num_rounds, k, fed.local_steps, train.batch_size)
        n_items = item_counts(n_items, max_items)
        if idx is None:
            idx = variant_indices(rngs, v, shape, n_items, max_items)
        idx = checked_indices(idx, (v,) + shape, max_items, n_items)
        if ingest_on:
            data, hashes = ingest_inputs(data, max_items)
            n_dev = None if n_items is None else n_items.to(dev)
        etas, gammas, shared = variant_stacks(states, num_rounds, start, v,
                                              eta_stacks, gamma_stacks)
        adam = fopt
        if lrs is not None:
            lrs = torch.as_tensor(lrs, dtype=torch.float32, device=dev)
            if tuple(lrs.shape) != (v,):
                raise ValueError(f"lrs shape {tuple(lrs.shape)} != ({v},)")
            adam = flat_adam(lrs[:, None], train.beta1, train.beta2,
                             train.eps, train.weight_decay, train.grad_clip)
        if faulty:
            # ONE fault plan shared by every variant; the surviving-link
            # mask folds into each variant's stacks, as run_rounds does
            plan = faults_lib.compile_plan(fed.faults, num_rounds, k,
                                           start=start)
            mask = torch.as_tensor(plan.link_mask, device=dev)
            if isinstance(etas, topology.SparseEta):
                etas = mobility_lib.masked_sparse_stack(etas, mask)
            else:
                etas = mobility_lib.masked_eta_stack(etas, mask)
            del mask
            health, byz, corrupt, straggle = (
                torch.as_tensor(a, device=dev) for a in
                (plan.health, plan.byz, plan.corrupt, plan.straggle))
        layout = states.layout
        buf, opt, tstate = states.buf, states.opt, states.tstate
        prev, ist = states.fstate, states.istate
        if faulty and has_straggle and not isinstance(prev, torch.Tensor):
            prev = buf
        series = {name: [] for name in (
            "loss", "disagreement", "eval", "est_distinct", "drift",
            "health", "quarantined", "frozen")}
        for r in range(num_rounds):
            eta_r = round_slice(etas, r if shared else (slice(None), r))
            gamma_r = gammas[:, r]
            idx_r = idx[:, r]
            if ingest_on:
                idx_r, eta_r, ist, est, novelty = ingest_round(
                    ist, hashes, idx_r, eta_r, n_dev, max_items)
                series["est_distinct"].append(est)
                if novelty is not None:
                    series["drift"].append(novelty)
            sent = None
            if faulty:
                # each variant's wire, built and guarded as run_rounds
                # builds one run's, over (V, K, P)
                sent = buf
                if has_straggle:
                    sent = torch.where(straggle[r][:, None] > 0, prev, sent)
                if has_byz:
                    sent = sent * byz[r][:, None]
                if has_corrupt:
                    sent = faults_lib.corrupt_rows(
                        sent, corrupt[r], fed.faults.corrupt_mode)
                sent, eta_r, quarantined = faults_lib.wire_guard(
                    sent, buf, eta_r, fed.faults.guard_threshold)
            entry_buf, entry_opt = (buf, opt) if faulty else (None, None)
            if dpsgd:
                carry = [buf, opt]
                del buf, opt
                buf, opt, loss = local_steps(
                    carry, layout, gathered(data, idx_r),
                    fed.local_steps,
                    mix=lambda b: gossip(b, eta_r, gamma_r), adam=adam)
            else:
                buf, tstate = mix_buf(buf, states.sizes, eta_r, gamma_r,
                                      layout, tstate, start + r, sent=sent)
                carry = [buf, opt]
                del buf, opt
                buf, opt, loss = local_steps(
                    carry, layout, gathered(data, idx_r),
                    fed.local_steps, adam=adam)
            series["loss"].append(loss)
            series["disagreement"].append(
                flatten.disagreement_flat(buf, layout.total))
            if eval_fn is not None:
                # one call a variant: eval_fn takes one run's (K, ...) views
                with torch.no_grad():
                    series["eval"].append(torch.stack([
                        eval_fn(flatten.unflatten(b, layout)) for b in buf]))
            if faulty:
                finite = torch.isfinite(buf).all(dim=-1)
                keep = (health[r] > 0) & finite
                buf = torch.where(keep[..., None], buf, entry_buf)
                opt = _freeze_rows(opt, entry_opt, keep)
                series["health"].append(health[r].expand(v, k))
                series["quarantined"].append(quarantined)
                series["frozen"].append(
                    ((health[r] > 0) & ~finite).to(torch.float32))
                if has_straggle:
                    prev = entry_buf
        metrics = {name: torch.stack(x, dim=1)
                   for name, x in series.items() if x}
        metrics["gamma"] = gammas.clone()
        final = FedState(buf, layout, opt, states.ratios, states.sizes,
                         rounds + num_rounds, tstate, prev, ist)
        return final, metrics

    return Trainer(init=init, round=round_fn, eta_fn=eta_fn, mixing=mixing,
                   run_rounds=run_rounds, device=dev,
                   mixing_stack=mixing_stack,
                   run_rounds_batch=run_rounds_batch)
