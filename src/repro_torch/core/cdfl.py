"""C-DFL trainer (paper Algorithm 2), model-agnostic.

One federated round =
  1. the eq. 5 consensus exchange with CND-derived weights (eqs. 5-7) on
     the flat ``(K, P)`` buffer: kernel B1 through the transport (cdfl,
     cfa, metropolis), or the fedavg server average through kernel B2;
  2. ``local_steps`` flat-Adam updates (eq. 8) on minibatches gathered on
     the device from the resident datasets.

Params live in the flat buffer for the whole run: the forward and
backward read views of it, all K nodes at once, and the gradient of the
summed per-node losses IS the ``(K, P)`` flat gradient (node parameters
are disjoint). ``init`` sketches every node's data in one launch of
kernel B3 and reads the bit counts through kernel B4.

``run_rounds`` is a Python loop over rounds. It takes an explicit
``(R, K, S, B)`` batch-index stack, so a run can replay the JAX
package's batches exactly, or samples one from a ``torch.Generator``.

This slice ports the static dense pipeline for cdfl, cfa, metropolis and
fedavg; ``build_trainer`` refuses what it does not run yet (see
:data:`repro_torch.registry.NOT_PORTED`).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import registry
from repro_torch.configs.base import FedConfig, TrainConfig
from repro_torch.core import flatten, sketch, topology
from repro_torch.core import transport as transport_lib
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.optim.adam import FlatAdamState, flat_adam


class FedState(NamedTuple):
    buf: torch.Tensor             # (K, P) f32 flat params
    layout: flatten.FlatLayout
    opt: FlatAdamState            # (K, P) moments, (K,) step counters
    ratios: torch.Tensor          # (K,) CND distinct ratios Ë_k
    sizes: torch.Tensor           # (K,) raw dataset sizes E_k
    round: int
    tstate: Any = ()              # transport state

    @property
    def params(self) -> dict:
        """Node-stacked parameter views of the buffer."""
        return flatten.unflatten(self.buf, self.layout)


class Trainer(NamedTuple):
    init: Callable                # (params, node_items) -> FedState
    mixing: Callable              # state -> ((K, K) eta, gamma)
    run_rounds: Callable          # (state, data, R[, idx]) -> (state, metrics)
    device: torch.device


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


def _refuse_unported(fed: FedConfig) -> None:
    for name in ("mobility", "faults", "robust", "ingest"):
        if getattr(fed, name) is not None:
            raise NotImplementedError(
                f"FedConfig.{name} is not ported to repro_torch yet: "
                f"{registry.NOT_PORTED[(name, None)]}")
    for name in ("algorithm", "transport", "mixing_format"):
        value = getattr(fed, name)
        item = registry.NOT_PORTED.get((name, value))
        if item is not None:
            raise NotImplementedError(
                f"FedConfig.{name}={value!r} is not ported to repro_torch "
                f"yet: {item}")


def build_trainer(loss_fn: Callable, fed: FedConfig, train: TrainConfig,
                  device=None) -> Trainer:
    """``loss_fn(params, batch) -> (K,)`` per-node losses, for node-stacked
    parameter views and a batch whose leaves are ``(K, B, ...)``.

    ``device=None`` runs on the card; pass ``device="cpu"`` for the plain
    PyTorch path."""
    dev = resolve_device(device)
    _refuse_unported(fed)
    registry.ensure_plugins()
    spec = registry.algorithms.get(fed.algorithm)
    k = fed.num_nodes
    topo = "full" if fed.algorithm == "fedavg" else fed.topology
    adj = torch.as_tensor(topology.adjacency(topo, k), device=dev)
    if spec.uses_transport:
        transport = transport_lib.make_transport(fed)
    else:
        # fedavg averages at a server: reject transport settings rather
        # than silently running something else than what was asked for
        if (fed.transport, fed.wire_dtype, fed.staleness) != ("dense",
                                                               "f32", 0):
            raise ValueError(
                f"{fed.algorithm} does not use the consensus transport "
                f"(server average) — got transport={fed.transport}/"
                f"{fed.wire_dtype}/staleness={fed.staleness}")
        transport = None
    fopt = flat_adam(train.learning_rate, train.beta1, train.beta2,
                     train.eps, train.weight_decay, train.grad_clip)

    def init(params: dict, node_items, same_init: bool = True) -> FedState:
        """``params``: one node's parameters, broadcast to all K nodes
        (``same_init``), or node-stacked ``(K, ...)`` leaves.
        ``node_items``: (K, n, f) int32 CND feature tokens."""
        leaves = {name: torch.as_tensor(v, device=dev)
                  for name, v in params.items()}
        if same_init:
            leaves = {name: v.expand((k,) + tuple(v.shape))
                      for name, v in leaves.items()}
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
        tstate = transport.init_state(buf) if transport else ()
        return FedState(buf, layout, fopt.init(buf), ratios, sizes, 0, tstate)

    def mixing(state: FedState):
        eta = topology.mixing_weights(adj, spec.mixing, ratios=state.ratios,
                                      sizes=state.sizes)
        return eta, topology.stable_gamma(eta, fed.gamma)

    def mix_buf(buf, sizes, eta, gamma, tstate, rnd):
        if transport is None:
            # fedavg: server average with weights E_i / sum E
            w = sizes / sizes.sum()
            a = w[None, :].expand(k, k).contiguous()
            return flatten.apply_matrix_flat(buf, a), tstate
        return transport.exchange(buf, eta, gamma, tstate, rnd)

    def local_steps(buf, opt, layout, data, idx_r):
        """``local_steps`` Adam steps of every node; idx_r (K, S, B)."""
        rows = torch.arange(k, device=dev)[:, None]
        loss_sum = torch.zeros(k, dtype=torch.float32, device=dev)
        for s in range(idx_r.shape[1]):
            sel = idx_r[:, s]
            batch = {name: arr[rows, sel] for name, arr in data.items()}
            p = buf.detach().requires_grad_(True)
            with torch.enable_grad():
                losses = loss_fn(flatten.unflatten(p, layout), batch)
                (grad,) = torch.autograd.grad(losses.sum(), p)
            with torch.no_grad():
                buf, opt = fopt.update(grad, opt, buf)
            loss_sum += losses.detach()
        return buf, opt, loss_sum / idx_r.shape[1]

    def run_rounds(state: FedState, data: dict, num_rounds: int,
                   idx=None, generator: Optional[torch.Generator] = None):
        """Run ``num_rounds`` rounds from ``state`` (which is left as it
        was). ``data``: node-stacked datasets, leaves (K, N, ...), moved
        to and kept on the device. ``idx``: (R, K, S, B) per-round batch
        indices; when omitted they are drawn from ``generator`` (default:
        a CPU generator seeded with ``train.seed + 1``).

        Returns (state, metrics): ``loss`` (R, K), ``disagreement`` (R,)
        and ``gamma`` (R,)."""
        data = {name: torch.as_tensor(v, device=dev)
                for name, v in data.items()}
        max_items = next(iter(data.values())).shape[1]
        shape = (num_rounds, k, fed.local_steps, train.batch_size)
        if idx is None:
            if generator is None:
                generator = torch.Generator().manual_seed(train.seed + 1)
            idx = torch.randint(0, max_items, shape, generator=generator,
                                device=generator.device)
        idx = torch.as_tensor(idx)
        if tuple(idx.shape) != shape:
            raise ValueError(f"batch index stack {tuple(idx.shape)} != "
                             f"{shape}")
        if int(idx.min()) < 0 or int(idx.max()) >= max_items:
            raise ValueError(f"batch indices must lie in [0, {max_items})")
        idx = idx.to(device=dev, dtype=torch.int64)
        eta, gamma = mixing(state)
        # every update below is out of place, so ``state`` stays as it was
        buf, opt, tstate = state.buf, state.opt, state.tstate
        losses, dis = [], []
        for r in range(num_rounds):
            buf, tstate = mix_buf(buf, state.sizes, eta, gamma, tstate,
                                  state.round + r)
            buf, opt, loss = local_steps(buf, opt, state.layout, data,
                                         idx[r])
            losses.append(loss)
            dis.append(flatten.disagreement_flat(buf, state.layout.total))
        metrics = {"loss": torch.stack(losses),
                   "disagreement": torch.stack(dis),
                   "gamma": gamma.expand(num_rounds).clone()}
        final = FedState(buf, state.layout, opt, state.ratios, state.sizes,
                         state.round + num_rounds, tstate)
        return final, metrics

    return Trainer(init=init, mixing=mixing, run_rounds=run_rounds,
                   device=dev)
