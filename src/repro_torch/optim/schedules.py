"""Learning-rate schedules: plain callables of the int32 step tensor, each
returning an f32 tensor on the step's device (``constant``: 0-d, as in
the JAX package; the others: the step's shape)."""
from __future__ import annotations

import math

import torch


def constant(value: float):
    return lambda step: torch.tensor(value, dtype=torch.float32,
                                     device=step.device)


def _progress(s: torch.Tensor, warmup: int, total: int) -> torch.Tensor:
    return torch.clamp((s - warmup) / max(total - warmup, 1), 0, 1)


def cosine(peak: float, warmup: int, total: int, floor: float = 0.0):
    def fn(step):
        s = step.to(torch.float32)
        warm = peak * s / max(warmup, 1)
        prog = _progress(s, warmup, total)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return fn


def linear_decay(peak: float, warmup: int, total: int):
    def fn(step):
        s = step.to(torch.float32)
        warm = peak * s / max(warmup, 1)
        prog = _progress(s, warmup, total)
        return torch.where(s < warmup, warm, peak * (1 - prog))
    return fn
