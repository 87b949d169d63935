"""Serving step functions: prefill a batch of prompts, and decode one
token against the per-layer states (KV caches, rwkv or mamba states) —
the serving half of the JAX package's ``repro.launch.steps``, for every
model family (dense, MoE, ssm, hybrid, vision, audio). Both return the
greedy (argmax) next tokens as int32. The federated mesh step and the
dry-run structs are not ported yet (ROADMAP queue A items 23e and 24).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def make_prefill_step(cfg: ModelConfig, window_override=None):
    """``prefill_step(params, batch) -> (B,) int32``: the whole prompt in
    one forward (on the card, every attention layer — dense, MoE, the
    hybrid's shared blocks, vision, audio — through kernel B9; the rwkv
    wkv scan through kernel B10 when the prompt is a multiple of 16
    tokens), logits of the last position only. ``batch`` is passed whole:
    a vision model's ``"embeds"`` prefix goes in with the tokens."""

    def prefill_step(params, batch):
        with torch.no_grad():
            logits, _ = transformer.forward(
                params, cfg, batch, window_override=window_override,
                last_only=True)
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
    return prefill_step


def make_serve_step(cfg: ModelConfig, window_override=None):
    """Single-token decode against a KV cache of seq_len tokens, or an
    rwkv or mamba state (the per-token recurrence, no kernel); MoE layers
    run every expert on the decode tokens:
    ``serve_step(params, decode_state, tokens) -> ((B,) int32,
    new_state)``."""

    def serve_step(params, decode_state, tokens):
        with torch.no_grad():
            logits, new_state = transformer.decode_step(
                params, cfg, decode_state, tokens,
                window_override=window_override)
        return torch.argmax(logits, dim=-1).to(torch.int32), new_state
    return serve_step
