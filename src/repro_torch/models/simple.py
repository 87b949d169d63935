"""The paper's own evaluation models batched over nodes: the MLP (Sec.
5.4.1: one hidden layer of 30 units) and the VGG-style CNN (Sec. 5.4.2).
Every parameter is node-stacked ``(K, ...)`` and the forward runs all K
nodes at once: the MLP with ``torch.bmm``, the VGG with one grouped
convolution a layer (``groups=K``). Losses come back per node, so the sum
of the K losses differentiates into every node's own gradient.

The VGG's data is NHWC and its kernels HWIO, as in the JAX package; its
convolutions run on channels-last (NHWC) tensors, so the data needs no
transpose. They run in f32 and reproducibly wherever they are called
from: for the forward and the backward of each, cuDNN's TF32 (allowed by
default) is off, its deterministic algorithms are on and its benchmark
search is off, so one run on a card repeats bit for bit."""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_models import MLPConfig, VGGConfig
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


def vgg_init(generator: torch.Generator, cfg: VGGConfig,
             device=None) -> dict:
    """One node's VGG parameters ``{"stages": [{"conv1", "conv2"}, ...],
    "fc_w", "fc_b"}`` (the JAX package's recipe: normal HWIO kernels
    scaled by fan-in ** -0.5, a normal fc matrix scaled likewise, zero
    fc bias), drawn from ``generator`` on its own device and moved to
    ``device``."""
    dev = resolve_device(device)
    gdev = generator.device

    def normal(shape, fan):
        return (torch.randn(shape, generator=generator, device=gdev)
                * fan ** -0.5).to(dev)

    stages = []
    c_in = cfg.channels
    for c_out in cfg.stages:
        stages.append({"conv1": normal((3, 3, c_in, c_out), 9 * c_in),
                       "conv2": normal((3, 3, c_out, c_out), 9 * c_out)})
        c_in = c_out
    feat = cfg.image_size // (2 ** len(cfg.stages))
    flat = feat * feat * cfg.stages[-1]
    return {"stages": stages, "fc_w": normal((flat, cfg.num_classes), flat),
            "fc_b": torch.zeros(cfg.num_classes, device=dev)}


@contextlib.contextmanager
def _exact_conv():
    """cuDNN convolutions in f32 (TF32 off) by deterministic algorithms
    (no benchmark search) inside, the caller's settings restored after."""
    cudnn = torch.backends.cudnn
    prev = (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark)
    cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = False, True, False
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = prev


class _GroupedConv(torch.autograd.Function):
    """A 3x3 stride-1 "SAME" grouped convolution on channels-last tensors
    whose forward and backward both run inside :func:`_exact_conv`:
    autograd runs the backward after the forward's context has closed, so
    it enters the context itself."""

    @staticmethod
    def forward(ctx, x, w, groups):
        ctx.save_for_backward(x, w)
        ctx.groups = groups
        with _exact_conv():
            return F.conv2d(x, w, padding=1, groups=groups)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        grad = grad.contiguous(memory_format=torch.channels_last)
        gx = gw = None
        with _exact_conv():
            if ctx.needs_input_grad[0]:
                gx = torch.nn.grad.conv2d_input(x.shape, w, grad, padding=1,
                                                groups=ctx.groups)
            if ctx.needs_input_grad[1]:
                gw = torch.nn.grad.conv2d_weight(x, w.shape, grad, padding=1,
                                                 groups=ctx.groups)
        return gx, gw, None


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, K*Cin, H, W) channels-last, node-stacked HWIO kernels w
    (K, 3, 3, Cin, Cout) -> (B, K*Cout, H, W) channels-last: every node's
    convolution in one grouped call."""
    k, kh, kw, c_in, c_out = w.shape
    w = w.permute(0, 4, 1, 2, 3).reshape(k * c_out, kh, kw, c_in)
    return _GroupedConv.apply(x, w.permute(0, 3, 1, 2), k)


def vgg_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """params leaves (K, ...); x (K, B, H, W, C) -> logits (K, B, classes).
    VGG pattern: [conv-conv-maxpool] stages, then the fc layer on the
    features flattened in (H, W, C) order."""
    k, b, h, w, c = x.shape
    x = x.permute(1, 2, 3, 0, 4).reshape(b, h, w, k * c).permute(0, 3, 1, 2)
    for stage in params["stages"]:
        x = torch.relu(_conv(x, stage["conv1"]))
        x = torch.relu(_conv(x, stage["conv2"]))
        x = F.max_pool2d(x, 2, 2)
    _, kc, h, w = x.shape
    feats = x.permute(0, 2, 3, 1).reshape(b, h, w, k, kc // k)
    feats = feats.permute(3, 0, 1, 2, 4).reshape(k, b, -1)
    return torch.bmm(feats, params["fc_w"]) + params["fc_b"][:, None, :]


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


def make_vgg_loss(cfg: VGGConfig):
    """``loss(params, batch) -> (K,)`` per-node losses for node-stacked
    params and a batch ``{"x": (K, B, H, W, C), "y": (K, B)}``."""
    def loss(params, batch):
        return xent_loss(vgg_forward(params, batch["x"]), batch["y"])
    return loss
