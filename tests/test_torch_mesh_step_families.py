"""The port's federated mesh train step against the JAX package's for the
model families beside qwen3 (see ``test_torch_mesh_step.py``, whose
helpers this file uses): the smoke mixtral-8x7b (MoE, the router's aux
loss in the loss), zamba2-1.2b with the pattern mamba/shared_attn (the
reduced config's two mamba blocks hold no shared set), internvl2-26b with
16 patch embeddings before the text, musicgen-medium (layernorm, GELU)
and rwkv6-7b (16-token sequences, so the chunked wkv form runs), each in
f32 on F=2 or F=3 nodes for 2 steps, half of them with ``remat="full"``.
Tolerances as there: losses 1e-5 relative, params, m and v within 1e-5
of the max |value| of their tree, the step counters equal.
"""
import numpy as np
import pytest

from test_torch_mesh_step import (LR, assert_state_matches, batches,
                                  node_params, run_port, run_reference,
                                  smoke_cfgs)

# arch: (F, remat, block pattern or None)
FAMILIES = {"mixtral-8x7b": (2, "full", None),
            "zamba2-1.2b": (3, "none", ("mamba", "shared_attn")),
            "internvl2-26b": (3, "full", None),
            "musicgen-medium": (2, "none", None),
            "rwkv6-7b": (2, "full", None)}


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_fed_train_step_matches_reference(arch):
    f, remat, pattern = FAMILIES[arch]
    jcfg, tcfg = smoke_cfgs(arch, pattern)
    params = node_params(tcfg, f)
    ratios = np.linspace(0.3, 0.9, f).tolist()
    data = batches(jcfg, f, seed=f)
    train = dict(learning_rate=LR, remat=remat)
    start, want, want_losses = run_reference(jcfg, params, ratios, [0] * f,
                                             data, train)
    got, losses = run_port(tcfg, start, data, train)
    assert_state_matches(got, want, losses, want_losses)
    if tcfg.num_experts:
        # the router moved: its gradient (the aux term's too) reached it
        router = got.params["layers"]["ffn"]["router"].numpy()
        assert np.abs(router - np.asarray(
            start.params["layers"]["ffn"]["router"])).max() > 0
