"""Shared NN layers: norms, rotary embeddings, gated MLPs, embeddings.

Params are plain nested dicts of tensors; init functions take a
``torch.Generator`` and return the dict. The arithmetic follows the JAX
package's ``repro.models.layers``: norms and RoPE in f32 and back to x's
dtype, logits in f32. Draws are made on the generator's device and then
moved, so one CPU generator gives the same params on any device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import pspec


def _dense_init(generator: torch.Generator, shape, scale=None,
                dtype=torch.float32, device=None) -> torch.Tensor:
    fan_in = shape[0]
    scale = scale if scale is not None else fan_in ** -0.5
    x = torch.randn(shape, generator=generator, device=generator.device)
    return (x * scale).to(device=device or generator.device, dtype=dtype)


# --- norms ----------------------------------------------------------------

def rmsnorm_init(d, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps=1e-6):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * params["scale"].float()).to(x.dtype)


def layernorm_init(d, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params, x, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    out = out * params["scale"].float() + params["bias"].float()
    return out.to(x.dtype)


def make_norm(kind: str):
    if kind == "rmsnorm":
        return rmsnorm_init, rmsnorm
    if kind == "layernorm":
        return layernorm_init, layernorm
    raise ValueError(kind)


# --- rotary ----------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)             # (D/2,)
    angles = positions[..., None].float() * freqs            # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --- MLPs -------------------------------------------------------------------

def swiglu_init(generator, d_model, d_ff, dtype=torch.float32, device=None):
    return {
        "w_gate": _dense_init(generator, (d_model, d_ff), dtype=dtype,
                              device=device),
        "w_up": _dense_init(generator, (d_model, d_ff), dtype=dtype,
                            device=device),
        "w_down": _dense_init(generator, (d_ff, d_model), dtype=dtype,
                              device=device),
    }


def swiglu(params, x):
    gate = F.silu(x @ params["w_gate"])
    gate = pspec.constrain(gate, *((None,) * (gate.ndim - 1)), "ffn")
    return (gate * (x @ params["w_up"])) @ params["w_down"]


def gelu_mlp_init(generator, d_model, d_ff, dtype=torch.float32,
                  device=None):
    return {
        "w_up": _dense_init(generator, (d_model, d_ff), dtype=dtype,
                            device=device),
        "w_down": _dense_init(generator, (d_ff, d_model), dtype=dtype,
                              device=device),
    }


def gelu_mlp(params, x):
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(x @ params["w_up"], approximate="tanh")
    h = pspec.constrain(h, *((None,) * (h.ndim - 1)), "ffn")
    return h @ params["w_down"]


def make_mlp(kind: str):
    if kind == "swiglu":
        return swiglu_init, swiglu
    if kind == "gelu":
        return gelu_mlp_init, gelu_mlp
    raise ValueError(kind)


# --- embeddings --------------------------------------------------------------

def embedding_init(generator, vocab, d_model, dtype=torch.float32,
                   device=None):
    return {"table": _dense_init(generator, (vocab, d_model), scale=0.02,
                                 dtype=dtype, device=device)}


def embed(params, tokens):
    # the embedding op rather than ``table[tokens]``: on a DTensor table (a
    # mesh) DTensor places its backward, and may not place an index's
    # backward (an index_put). On a mesh the token ids are replicated
    # first: a vocab-sharded lookup of batch-sharded ids keeps the ids'
    # local mask but gathers the ids, and its reduction fails (torch 2.13)
    tokens = pspec.constrain(tokens, *((None,) * tokens.ndim))
    return F.embedding(tokens.long(), params["table"])


def unembed(params, x):
    """Logits in f32 (loss stability)."""
    return x.float() @ params["table"].float().T
