"""The paper's MLP (Sec. 5.4.1: one hidden layer of 30 units) batched over
nodes: every parameter is node-stacked ``(K, ...)`` and the forward runs
all K nodes at once with ``torch.bmm``. Losses come back per node, so the
sum of the K losses differentiates into every node's own gradient."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_models import MLPConfig
from repro_torch.device import resolve_device


def mlp_init(generator: torch.Generator, cfg: MLPConfig,
             device=None) -> dict:
    """One node's MLP parameters (the JAX package's init recipe: normal
    weights scaled by fan-in ** -0.5, zero biases), drawn from
    ``generator`` on its own device and moved to ``device``."""
    dev = resolve_device(device)
    gdev = generator.device
    w1 = torch.randn((cfg.input_dim, cfg.hidden), generator=generator,
                     device=gdev) * cfg.input_dim ** -0.5
    w2 = torch.randn((cfg.hidden, cfg.num_classes), generator=generator,
                     device=gdev) * cfg.hidden ** -0.5
    return {"w1": w1.to(dev), "b1": torch.zeros(cfg.hidden, device=dev),
            "w2": w2.to(dev), "b2": torch.zeros(cfg.num_classes, device=dev)}


def mlp_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """params leaves (K, ...); x (K, B, input_dim) -> logits (K, B, C)."""
    h = torch.relu(torch.bmm(x, params["w1"]) + params["b1"][:, None, :])
    return torch.bmm(h, params["w2"]) + params["b2"][:, None, :]


def xent_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean one-hot cross entropy over the batch axis: (..., B, C) logits,
    (..., B) labels -> (...) losses."""
    logp = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(logp.dtype)
    return -(logp * onehot).sum(dim=-1).mean(dim=-1)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).to(torch.float32).mean(dim=-1)


def make_mlp_loss(cfg: MLPConfig):
    """``loss(params, batch) -> (K,)`` per-node losses for node-stacked
    params and a batch ``{"x": (K, B, D), "y": (K, B)}``."""
    def loss(params, batch):
        return xent_loss(mlp_forward(params, batch["x"]), batch["y"])
    return loss
