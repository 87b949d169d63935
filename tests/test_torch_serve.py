"""The port's serving steps and ``serve.main`` against the JAX package's,
on the CPU in f32, for the smoke qwen3-1.7b, its GQA variant and the
smoke rwkv6-7b (whose 16-token prompt, a multiple of the chunk, runs the
chunked wkv form in the prefill step).

Same params (``repro.models.transformer.init_params`` through
``repro_torch.convert``) and the same prompt tokens on both sides:
``make_prefill_step`` gives the reference's tokens, ``make_serve_step``
teacher-forced over the prompt gives the reference's token after every
position and, after the last, the prefill token; ``serve.main`` (the
port's, with its draws replaced by the reference's ``PRNGKey(0)`` params
and prompts) prints the generations the reference's ``main`` prints, with
and without a sliding window, and for the smoke mixtral-8x7b, dbrx-132b,
zamba2-1.2b, internvl2-26b and musicgen-medium; the GQA variant runs the
same loop.
"""
import dataclasses
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_arch as jget_smoke_arch
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import transformer as jtransformer
from repro_torch import convert
from repro_torch.configs.registry import get_smoke_arch
from repro_torch.launch import serve, steps
from repro_torch.models import transformer

B, PROMPT, GEN = 2, 12, 6
RWKV_PROMPT = 16     # a multiple of rwkv.CHUNK: the prefill runs chunked


def _cfgs(name):
    if name == "rwkv6-7b":
        return jget_smoke_arch(name), get_smoke_arch(name)
    base = (jget_smoke_arch("qwen3-1.7b"), get_smoke_arch("qwen3-1.7b"))
    if name == "qwen3-1.7b":
        return base
    return tuple(dataclasses.replace(c, num_heads=4, num_kv_heads=2,
                                     head_dim=128) for c in base)


@pytest.fixture(scope="module", params=["qwen3-1.7b", "qwen3-gqa",
                                        "rwkv6-7b"])
def case(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    prompt = RWKV_PROMPT if request.param == "rwkv6-7b" else PROMPT
    prompts = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (B, prompt)).astype(np.int32)
    jprefill = jax.jit(jsteps.make_prefill_step(jcfg))
    jserve_step = jax.jit(jsteps.make_serve_step(jcfg))
    # the reference's serving steps run under its serving mesh's axis
    # names; one device, so every sharding constraint drops out
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    with mesh:
        prefill = np.asarray(jprefill(jparams,
                                      {"tokens": jnp.asarray(prompts)}))
        state = jtransformer.init_decode(jcfg, B, prompt + GEN)
        forced = []
        for t in range(prompt):
            tok, state = jserve_step(jparams, state,
                                     jnp.asarray(prompts[:, t]))
            forced.append(np.asarray(tok))
        generated = []
        for _ in range(GEN):
            generated.append(np.asarray(tok))
            tok, state = jserve_step(jparams, state, tok)
    return dict(tcfg=tcfg, prompts=prompts, prompt=prompt,
                params=convert.transformer_params_from_numpy(jparams, "cpu"),
                prefill=prefill, forced=np.stack(forced, axis=1),
                generated=np.stack(generated, axis=1))


def test_prefill_step_matches_reference(case):
    step = steps.make_prefill_step(case["tcfg"])
    got = step(case["params"], {"tokens": torch.tensor(case["prompts"])})
    assert got.dtype == torch.int32 and tuple(got.shape) == (B,)
    np.testing.assert_array_equal(got.numpy(), case["prefill"])


def test_serve_step_teacher_forced_matches_reference(case):
    step = steps.make_serve_step(case["tcfg"])
    state = transformer.init_decode(case["tcfg"], B, case["prompt"],
                                    device="cpu")
    forced = []
    for t in range(case["prompt"]):
        tok, state = step(case["params"], state,
                          torch.tensor(case["prompts"][:, t]))
        assert tok.dtype == torch.int32
        forced.append(tok)
    forced = torch.stack(forced, dim=1).numpy()
    np.testing.assert_array_equal(forced, case["forced"])
    # the token after the prompt is the prefill token
    np.testing.assert_array_equal(forced[:, -1], case["prefill"])


def test_generate_loop_matches_reference(case):
    tokens, _, _ = serve.generate(case["params"], case["tcfg"],
                                  torch.tensor(case["prompts"]), GEN)
    assert tokens.dtype == torch.int32
    np.testing.assert_array_equal(tokens.numpy(), case["generated"])
    np.testing.assert_array_equal(tokens[:, 0].numpy(), case["prefill"])


def _printed(capsys) -> np.ndarray:
    text = capsys.readouterr().out
    rows = re.findall(r"seq\d+: \[([^\]]*)\]", text)
    return np.array([[int(t) for t in r.split(",")] for r in rows])


# the MoE, hybrid, vision and audio families (ROADMAP item 23c) after the
# dense and ssm ones
FAMILIES = ["mixtral-8x7b", "dbrx-132b", "zamba2-1.2b", "internvl2-26b",
            "musicgen-medium"]


@pytest.mark.parametrize("arch,prompt,window", [
    ("qwen3-1.7b", PROMPT, None), ("qwen3-1.7b", PROMPT, 5),
    ("rwkv6-7b", RWKV_PROMPT, None)] + [(a, PROMPT, None) for a in FAMILIES],
    ids=["None", "5", "rwkv6-7b"] + FAMILIES)
def test_serve_main_prints_the_reference_generations(arch, prompt, window,
                                                     capsys, monkeypatch):
    argv = ["--arch", arch, "--batch", str(B), "--prompt-len",
            str(prompt), "--gen", str(GEN)]
    if window is not None:
        argv += ["--window", str(window)]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    want = _printed(capsys)
    # the reference's own draws: PRNGKey(0) for params and prompts
    jcfg = jget_smoke_arch(arch)
    rng = jax.random.PRNGKey(0)
    jparams = jtransformer.init_params(rng, jcfg)
    prompts = jax.random.randint(rng, (B, prompt), 0, jcfg.vocab_size)
    monkeypatch.setattr(serve, "init_inputs", lambda cfg, b, p, dev: (
        convert.transformer_params_from_numpy(jparams, dev),
        torch.tensor(np.asarray(prompts), dtype=torch.int32)))
    out = serve.main(argv + ["--device", "cpu"])
    assert want.shape == (B, GEN)
    np.testing.assert_array_equal(_printed(capsys), want)
    np.testing.assert_array_equal(out, want)
