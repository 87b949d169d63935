"""Batched serving driver: prefill a batch of prompts, then decode tokens
autoregressively with the KV caches, rwkv or mamba states — the runnable
counterpart of the decode dry-run shapes, at reduced size. Params and
prompts are drawn from a CPU ``torch.Generator`` seeded with 0, then
moved to the device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --batch 4 --prompt-len 32 --gen 16 [--device cpu]

``--arch rwkv6-7b`` serves the ssm family; ``mixtral-8x7b`` and
``dbrx-132b`` the MoE family, ``zamba2-1.2b`` the hybrid (mamba blocks
and shared attention), ``internvl2-26b`` the vision backbone (text
prompts: decode takes tokens) and ``musicgen-medium`` the audio decoder.
As in the JAX package, the prompt is teacher-forced through the decode
step, so this driver runs no kernel: the prefill step
(``steps.make_prefill_step``) is where B9 and B10 run.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCHS, get_smoke_arch
from repro_torch.device import resolve_device
from repro_torch.launch import steps
from repro_torch.models import transformer


def init_inputs(cfg: ModelConfig, batch: int, prompt_len: int, device=None):
    """(params, prompts (B, prompt_len) int32) from one CPU generator
    seeded with 0, on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    params = transformer.init_params(cfg, gen, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen, dtype=torch.int32).to(dev)
    return params, prompts


def generate(params, cfg: ModelConfig, prompts: torch.Tensor, gen: int,
             window=None):
    """Teacher-force ``prompts`` through the serve step, then decode
    ``gen`` tokens greedily. Returns (tokens (B, gen) int32, prefill
    seconds, decode seconds)."""
    batch, prompt_len = prompts.shape
    state = transformer.init_decode(cfg, batch, prompt_len + gen,
                                    window_override=window,
                                    device=prompts.device)
    step = steps.make_serve_step(cfg, window_override=window)
    sync = (torch.cuda.synchronize if prompts.device.type == "cuda"
            else lambda: None)
    t0 = time.time()
    for t in range(prompt_len):
        tok, state = step(params, state, prompts[:, t])
    sync()
    prefill_s = time.time() - t0
    generated = []
    t0 = time.time()
    for _ in range(gen):
        generated.append(tok)
        tok, state = step(params, state, tok)
    sync()
    gen_s = time.time() - t0
    return torch.stack(generated, dim=1), prefill_s, gen_s


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--window", type=int, default=None,
                    help="sliding-window override (long-context mode)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_arch(args.arch)
    params, prompts = init_inputs(cfg, args.batch, args.prompt_len,
                                  args.device)
    tokens, prefill_s, gen_s = generate(params, cfg, prompts, args.gen,
                                        window=args.window)

    out = tokens.cpu().numpy()
    print(f"arch={cfg.name} batch={args.batch} device={prompts.device} "
          f"prefill({args.prompt_len} tok): {prefill_s:.2f}s  "
          f"decode({args.gen} tok): {gen_s:.2f}s "
          f"({args.gen * args.batch / max(gen_s, 1e-9):.1f} tok/s)")
    print("sample generations (token ids):")
    for b in range(min(args.batch, 2)):
        print(f"  seq{b}: {out[b].tolist()}")
    return out


if __name__ == "__main__":
    main()
