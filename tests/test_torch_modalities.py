"""The port's vision and audio backbones against the JAX package's, on the
CPU: ``reduced(internvl2-26b)`` (a prefix of 16 patch embeddings before
the text; GQA, swiglu) and ``reduced(musicgen-medium)`` (the single-stream
decoder over codec tokens: layernorm with a bias, GELU MLP).

Params come from ``repro.models.transformer.init_params`` and cross
through ``repro_torch.convert``; tokens and patch embeddings are made with
numpy. The vision forward with and without ``embeds`` (the logits cover
the text positions only; the embeddings change them), ``loss_fn`` with
the prefix; for both, the forward, ``loss_fn`` and 16 teacher-forced
decode steps (decode takes tokens only, as in the reference: it matches
the text-only forward); the stubs' shapes and dtypes; a bf16 forward of
each. f32 at tests/test_models.py's 2e-4 / 2e-3, bf16 at 2e-2.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_arch as jget_smoke_arch
from repro.models import stubs as jstubs
from repro.models import transformer as jtransformer
from repro_torch import convert
from repro_torch.configs.registry import get_smoke_arch
from repro_torch.models import stubs, transformer

ARCHS = ["internvl2-26b", "musicgen-medium"]
B, S = 2, 16
ATOL, RTOL = 2e-4, 2e-3


def _t(x):
    return convert.tensor_from_numpy(x, "cpu")


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


@functools.cache
def _case(arch):
    jcfg, tcfg = jget_smoke_arch(arch), get_smoke_arch(arch)
    jparams = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    embeds = (rng.normal(size=(B, jcfg.num_patches, jcfg.d_model))
              * 0.02).astype(np.float32)
    jt = jnp.asarray(tokens)
    fwd = jax.jit(lambda p, b: jtransformer.forward(p, jcfg, b)[0])
    loss = jax.jit(lambda p, b: jtransformer.loss_fn(p, jcfg, b))
    step = jax.jit(lambda p, s, t: jtransformer.decode_step(p, jcfg, s, t))
    state = jtransformer.init_decode(jcfg, B, S)
    outs = []
    for t in range(S):
        lg, state = step(jparams, state, jt[:, t])
        outs.append(np.asarray(lg))
    labels = jnp.roll(jt, -1, axis=1)
    out = dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tokens=tokens,
               embeds=embeds,
               params=convert.transformer_params_from_numpy(jparams, "cpu"),
               logits=np.asarray(fwd(jparams, {"tokens": jt})),
               loss=float(loss(jparams, {"tokens": jt, "labels": labels})),
               decode=np.stack(outs, axis=1))
    if jcfg.modality == "vision":
        vb = {"tokens": jt, "embeds": jnp.asarray(embeds)}
        out.update(vis_logits=np.asarray(fwd(jparams, vb)),
                   vis_loss=float(loss(jparams, dict(vb, labels=labels))))
    return out


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return _case(request.param)


def test_forward_loss_and_decode_match_reference(case):
    tok = _t(case["tokens"])
    logits, aux = transformer.forward(case["params"], case["tcfg"],
                                      {"tokens": tok})
    assert tuple(logits.shape) == (B, S, case["tcfg"].vocab_size)
    _close(logits, case["logits"])
    assert float(aux) == 0.0
    loss = transformer.loss_fn(case["params"], case["tcfg"],
                               {"tokens": tok,
                                "labels": torch.roll(tok, -1, dims=1)})
    assert abs(float(loss) - case["loss"]) <= ATOL + RTOL * case["loss"]
    state = transformer.init_decode(case["tcfg"], B, S, device="cpu")
    outs = []
    for t in range(S):
        lg, state = transformer.decode_step(case["params"], case["tcfg"],
                                            state, tok[:, t])
        outs.append(lg)
    dec = torch.stack(outs, dim=1)
    _close(dec, case["decode"])
    _close(dec, case["logits"])


def test_vision_prefix_covers_text_positions_only():
    case = _case("internvl2-26b")
    tok, emb = _t(case["tokens"]), _t(case["embeds"])
    logits, _ = transformer.forward(case["params"], case["tcfg"],
                                    {"tokens": tok, "embeds": emb})
    assert tuple(logits.shape) == (B, S, case["tcfg"].vocab_size)
    _close(logits, case["vis_logits"])
    assert not np.allclose(case["vis_logits"], case["logits"], atol=1e-3)
    moved, _ = transformer.forward(case["params"], case["tcfg"],
                                   {"tokens": tok, "embeds": emb + 1.0})
    assert not torch.allclose(moved, logits, atol=1e-3)
    last, _ = transformer.forward(case["params"], case["tcfg"],
                                  {"tokens": tok, "embeds": emb},
                                  last_only=True)
    _close(last[:, 0], case["vis_logits"][:, -1])
    loss = transformer.loss_fn(case["params"], case["tcfg"],
                               {"tokens": tok, "embeds": emb,
                                "labels": torch.roll(tok, -1, dims=1)})
    assert abs(float(loss) - case["vis_loss"]) <= \
        ATOL + RTOL * case["vis_loss"]


def test_audio_backbone_is_layernorm_and_gelu():
    case = _case("musicgen-medium")
    layer = case["params"]["layers"]
    assert set(layer["norm1"]) == {"scale", "bias"}
    assert set(layer["ffn"]) == {"w_up", "w_down"}
    mine = transformer.init_params(case["tcfg"], device="cpu")
    assert set(mine["layers"]["ffn"]) == {"w_up", "w_down"}
    assert set(mine["final_norm"]) == {"scale", "bias"}


def test_stubs_match_the_reference_shapes_and_dtypes():
    gen = torch.Generator().manual_seed(0)
    for arch in ARCHS:
        tcfg, jcfg = get_smoke_arch(arch), jget_smoke_arch(arch)
        mine = stubs.vision_patch_embeddings(gen, tcfg, 3)
        want = jstubs.vision_patch_embeddings(jax.random.PRNGKey(0), jcfg, 3)
        assert tuple(mine.shape) == want.shape == (3, 16, tcfg.d_model)
        assert mine.dtype == torch.float32
        assert 0.01 < float(mine.std()) < 0.03
        assert stubs.vision_patch_embeddings(
            gen, tcfg, 1, num_patches=5,
            dtype=torch.bfloat16).shape == (1, 5, tcfg.d_model)
        codes = stubs.audio_codec_tokens(gen, tcfg, 2, 7)
        jcodes = jstubs.audio_codec_tokens(jax.random.PRNGKey(0), jcfg, 2, 7)
        assert tuple(codes.shape) == jcodes.shape == (2, 7)
        assert codes.dtype == torch.int32 and jcodes.dtype == jnp.int32
        assert 0 <= int(codes.min()) and int(codes.max()) < tcfg.vocab_size


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_matches_reference(arch):
    jcfg = dataclasses.replace(jget_smoke_arch(arch), dtype="bfloat16")
    tcfg = dataclasses.replace(get_smoke_arch(arch), dtype="bfloat16")
    jparams = jtransformer.init_params(jax.random.PRNGKey(2), jcfg)
    params = convert.transformer_params_from_numpy(jparams, "cpu")
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(tokens)}, {"tokens": _t(tokens)}
    if jcfg.modality == "vision":
        emb = jnp.asarray(rng.normal(size=(B, jcfg.num_patches,
                                           jcfg.d_model)) * 0.02,
                          jnp.bfloat16)
        jb["embeds"], tb["embeds"] = emb, _t(emb)
    want, _ = jax.jit(lambda p, b: jtransformer.forward(p, jcfg, b))(
        jparams, jb)
    got, _ = transformer.forward(params, tcfg, tb)
    _close(got, want, 2e-2, 2e-2)
