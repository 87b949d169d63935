"""Modality frontends — stubs, as in the JAX package's
``repro.models.stubs``.

The [vlm] and [audio] architectures specify the transformer backbone
only; the ViT/SigLIP vision encoder and the EnCodec conv codec are not
implemented. These helpers draw concrete embeddings and tokens of the
right shape for smoke runs and the serving path, from an explicit
``torch.Generator`` on its own device.

musicgen note: real MusicGen decodes 4 interleaved EnCodec codebooks with
a delay pattern; per the assignment ("decoder-only over EnCodec tokens",
vocab 2048) the single-stream decoder is modelled and codebook
interleaving is part of the stubbed frontend.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def vision_patch_embeddings(generator: torch.Generator, cfg: ModelConfig,
                            batch: int, num_patches: int | None = None,
                            dtype=None) -> torch.Tensor:
    """Stand-in for InternViT + projector output: (B, P, d_model)."""
    p = num_patches or cfg.num_patches
    dtype = dtype or getattr(torch, cfg.dtype)
    x = torch.randn((batch, p, cfg.d_model), generator=generator,
                    device=generator.device)
    return (x * 0.02).to(dtype)


def audio_codec_tokens(generator: torch.Generator, cfg: ModelConfig,
                       batch: int, seq_len: int) -> torch.Tensor:
    """Stand-in for the EnCodec tokenizer output: (B, S) int32 codes."""
    return torch.randint(0, cfg.vocab_size, (batch, seq_len),
                         generator=generator, device=generator.device,
                         dtype=torch.int32)
