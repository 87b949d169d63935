"""The federated token-LM training path of the port against the JAX
package, on the CPU: the ``token_lm``/``lm_batches`` copies, the
transformer's loss and every gradient leaf against ``jax.value_and_grad``
(qwen3 and rwkv6 smoke arches), the autograd Functions of B9 and B10
against autograd of their plain versions, three cdfl ``Trainer.round``s on
K=4 against the reference's, and a model-derived ``Experiment`` whose
run(1) + save + resume + run(1) equals run(2) bit for bit.

Tolerances: the loss within 1e-5 relative; each gradient leaf within 1e-4
(qwen3) or 2e-4 (rwkv6, whose port computes the pairwise wkv where the
reference factorises it) of that leaf's max |value|; the three rounds'
losses within 1e-5 relative and the params within 1e-5 of max |param|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs.registry import get_smoke_arch as jsmoke
from repro.core import baselines as jbaselines
from repro.data import pipeline as jpipeline
from repro.data import redundancy as jredundancy
from repro.data import synthetic as jsynthetic
from repro.models import transformer as jtransformer
from repro_torch import convert
from repro_torch import experiment as texp
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import get_smoke_arch as tsmoke
from repro_torch.core import baselines as tbaselines
from repro_torch.core import flatten
from repro_torch.data import pipeline as tpipeline
from repro_torch.data import redundancy as tredundancy
from repro_torch.data import synthetic as tsynthetic
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rwkv6_scan as rw_kernel
from repro_torch.models import transformer as ttransformer

GRAD_TOL = {"qwen3-1.7b": 1e-4, "rwkv6-7b": 2e-4}
K, STEPS, B, T = 4, 2, 4, 32


def _tree_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def test_token_lm_and_lm_batches_copies_give_identical_arrays():
    for kw in (dict(seed=3, n_seqs=40, seq_len=32, vocab=512),
               dict(seed=0, n_seqs=7, seq_len=20, vocab=151_936)):
        a, b = jsynthetic.token_lm(**kw), tsynthetic.token_lm(**kw)
        for name in ("x", "y", "features"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
            assert getattr(a, name).dtype == getattr(b, name).dtype
    nodes_j = [jredundancy.inject_duplicates(jsynthetic.token_lm(
        seed=i, n_seqs=30, seq_len=16), 0.5, seed=i) for i in range(3)]
    nodes_t = [tredundancy.inject_duplicates(tsynthetic.token_lm(
        seed=i, n_seqs=30, seq_len=16), 0.5, seed=i) for i in range(3)]
    for seed in (0, 1000):
        bj = jpipeline.lm_batches(nodes_j, 5, 3, seed=seed)
        bt = tpipeline.lm_batches(nodes_t, 5, 3, seed=seed)
        assert set(bj) == set(bt) == {"tokens", "labels"}
        for name in bj:
            assert bt[name].shape == (3, 3, 5, 16)
            np.testing.assert_array_equal(bj[name], bt[name])


# --- loss and gradients against jax.value_and_grad --------------------------

@pytest.fixture(scope="module", params=["qwen3-1.7b", "rwkv6-7b"])
def jax_grads(request):
    """The reference's loss and gradient of one batch of 2 x 32 tokens
    (a multiple of 16: rwkv6 takes the chunked wkv)."""
    arch = request.param
    cfg = jsmoke(arch)
    params = jtransformer.init_params(jax.random.PRNGKey(0), cfg)
    d = jsynthetic.token_lm(seed=0, n_seqs=8, seq_len=T,
                            vocab=cfg.vocab_size)
    batch = {"tokens": d.x[:2, :-1], "labels": d.x[:2, 1:]}
    loss, grads = jax.value_and_grad(lambda p: jtransformer.loss_fn(
        p, cfg, jax.tree.map(jnp.asarray, batch)))(params)
    return arch, _tree_numpy(params), batch, float(loss), _tree_numpy(grads)


def test_loss_and_every_gradient_leaf_match_jax(jax_grads):
    arch, params, batch, loss_j, grads_j = jax_grads
    cfg = tsmoke(arch)
    tp = convert.transformer_params_from_numpy(params, "cpu")
    leaves = flatten.leaves_with_paths(tp)
    for _, leaf in leaves:
        leaf.requires_grad_(True)
    loss = ttransformer.loss_fn(
        tp, cfg, {name: torch.as_tensor(v) for name, v in batch.items()})
    loss.backward()
    assert abs(loss.item() - loss_j) <= 1e-5 * abs(loss_j)
    want = dict(flatten.leaves_with_paths(grads_j))
    assert set(want) == {path for path, _ in leaves}
    for path, leaf in leaves:
        g = want[path]
        err = np.abs(leaf.grad.numpy() - g).max()
        assert err <= GRAD_TOL[arch] * np.abs(g).max(), (path, err)


# --- the autograd Functions of B9 and B10 -----------------------------------

def _leaves(*arrays):
    return [torch.tensor(a, requires_grad=True) for a in arrays]


@pytest.mark.parametrize("causal,window,kv", [(True, None, 2), (True, 5, 4),
                                              (False, None, 1)])
def test_flash_attention_function_grads_equal_plain_autograd(causal, window,
                                                             kv):
    rng = np.random.default_rng(0)
    shapes = [(2, 12, 4, 32), (2, 12, kv, 32), (2, 12, kv, 32)]
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    up = torch.tensor(rng.standard_normal(shapes[0]).astype(np.float32))
    mine, plain = _leaves(*arrays), _leaves(*arrays)
    out = ops.flash_attention(*mine, causal=causal, window=window)
    want = ref.flash_attention(*plain, causal=causal, window=window)
    assert out.grad_fn is not None and "FlashAttention" in \
        type(out.grad_fn).__name__
    assert torch.equal(out, want)
    (out * up).sum().backward()
    (want * up).sum().backward()
    for a, b in zip(mine, plain):
        assert torch.equal(a.grad, b.grad)


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_scan_function_grads_equal_plain_autograd(with_state):
    rng = np.random.default_rng(1)
    b, s, h, d = 2, 32, 2, 16
    r, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.5, 0.99, (b, s, h, d)).astype(np.float32)
    u = rng.standard_normal((h, d)).astype(np.float32)
    arrays = [r, k, v, w, u]
    if with_state:
        arrays.append(rng.standard_normal((b, h, d, d)).astype(np.float32))
    up_y = torch.tensor(rng.standard_normal((b, s, h, d)).astype(np.float32))
    up_s = torch.tensor(rng.standard_normal((b, h, d, d)).astype(np.float32))
    mine, plain = _leaves(*arrays), _leaves(*arrays)
    s0m = mine[5] if with_state else None
    s0p = plain[5] if with_state else None
    y, st = ops.rwkv6_scan(*mine[:5], chunk=16, s0=s0m)
    y_p, st_p = ref.rwkv6_scan(*plain[:5], s0=s0p, chunk=16)
    assert torch.equal(y, y_p) and torch.equal(st, st_p)
    ((y * up_y).sum() + (st * up_s).sum()).backward()
    ((y_p * up_y).sum() + (st_p * up_s).sum()).backward()
    for a, c in zip(mine, plain):
        assert torch.equal(a.grad, c.grad)
    # the final state alone (y's gradient materialised as zeros)
    mine = _leaves(*arrays)
    _, st = ops.rwkv6_scan(*mine[:5], chunk=16,
                           s0=mine[5] if with_state else None)
    st.sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in mine)


def test_training_forward_goes_through_the_kernel_wrappers(monkeypatch):
    """With every tensor taken for a card tensor, a differentiable forward
    calls the B9 and B10 wrappers once a layer, on inputs that do not
    require grad (the wrappers refuse those), and the backward reaches
    every parameter through the plain versions."""
    calls = {"flash_attention": 0, "rwkv6_scan": 0}

    def fake_fa(q, k, v, *, causal, window):
        assert not (q.requires_grad or k.requires_grad or v.requires_grad)
        calls["flash_attention"] += 1
        return ref.flash_attention(q, k, v, causal=causal, window=window)

    def fake_rw(r, k, v, w, u, s0=None, chunk=16):
        assert not any(t is not None and t.requires_grad
                       for t in (r, k, v, w, u, s0))
        calls["rwkv6_scan"] += 1
        return ref.rwkv6_scan(r, k, v, w, u, s0=s0, chunk=chunk)

    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(fa_kernel, "flash_attention", fake_fa)
    monkeypatch.setattr(rw_kernel, "rwkv6_scan", fake_rw)
    tokens = torch.randint(0, 512, (2, 16), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tokens, "labels": tokens}
    for arch, kernel in (("qwen3-1.7b", "flash_attention"),
                         ("rwkv6-7b", "rwkv6_scan")):
        cfg = tsmoke(arch)
        params = ttransformer.init_params(cfg, device="cpu")
        leaves = [leaf.requires_grad_(True)
                  for _, leaf in flatten.leaves_with_paths(params)]
        ttransformer.loss_fn(params, cfg, batch).backward()
        assert calls[kernel] == cfg.num_layers
        assert all(leaf.grad is not None for leaf in leaves)
        with torch.no_grad():
            ttransformer.forward(params, cfg, batch)
        assert calls[kernel] == 2 * cfg.num_layers


# --- three cdfl rounds against the reference's Trainer.round ---------------

def _lm_nodes(mod_synth, mod_red, vocab):
    return [mod_red.inject_duplicates(mod_synth.token_lm(
        seed=i, n_seqs=64, seq_len=T, vocab=vocab), 0.5, seed=i)
        for i in range(K)]


@pytest.fixture(scope="module")
def jax_rounds():
    """tests/test_system.py's federated-LLM rounds, 3 of them: the shared
    init, every round's losses and the final params."""
    cfg = jsmoke("qwen3-1.7b")
    nodes = _lm_nodes(jsynthetic, jredundancy, cfg.vocab_size)
    fed = jbase.FedConfig(num_nodes=K, local_steps=STEPS)
    train = jbase.TrainConfig(learning_rate=3e-4, batch_size=B)

    def loss_fn(params, batch):
        return jtransformer.loss_fn(params, cfg, batch, group_size=B * T)

    tr = jbaselines.cdfl(loss_fn, fed, train)
    init = jtransformer.init_params(jax.random.PRNGKey(0), cfg)
    batcher = jpipeline.FederatedBatcher(nodes, B, STEPS)
    state = tr.init(jax.random.PRNGKey(0), lambda r: init,
                    jnp.asarray(batcher.node_items()))
    ratios = np.asarray(state.ratios)
    losses, dis = [], []
    for r in range(3):
        batch = jpipeline.lm_batches(nodes, B, STEPS, seed=r)
        state, m = tr.round(state, jax.tree.map(jnp.asarray, batch))
        losses.append(np.asarray(m["loss"]))
        dis.append(float(m["disagreement"]))
    return (_tree_numpy(init), ratios, np.stack(losses), dis,
            _tree_numpy(state.params))


def test_three_trainer_rounds_match_the_reference(jax_rounds):
    init, ratios, losses_j, dis_j, params_j = jax_rounds
    cfg = tsmoke("qwen3-1.7b")
    nodes = _lm_nodes(tsynthetic, tredundancy, cfg.vocab_size)
    fed = tbase.FedConfig(num_nodes=K, local_steps=STEPS)
    train = tbase.TrainConfig(learning_rate=3e-4, batch_size=B)
    tr = tbaselines.cdfl(
        lambda p, b: ttransformer.node_losses(p, cfg, b), fed, train,
        device="cpu")
    items = tpipeline.FederatedBatcher(nodes, B, STEPS).node_items()
    state = tr.init(convert.transformer_params_from_numpy(init, "cpu"),
                    items)
    np.testing.assert_allclose(state.ratios.numpy(), ratios, rtol=1e-6)
    losses, dis = [], []
    for r in range(3):
        state, m = tr.round(state, tpipeline.lm_batches(nodes, B, STEPS,
                                                        seed=r))
        losses.append(m["loss"].numpy())
        dis.append(float(m["disagreement"]))
    np.testing.assert_allclose(np.stack(losses), losses_j, rtol=1e-5)
    np.testing.assert_allclose(dis, dis_j, rtol=1e-3, atol=1e-9)
    buf_j, layout_j = convert.params_from_numpy(params_j, "cpu")
    assert layout_j.names == state.layout.names
    err = (state.buf - buf_j).abs().max().item()
    assert err <= 1e-5 * buf_j.abs().max().item(), err
    assert losses[-1].mean() < losses[0].mean()


# --- the model-derived Experiment -------------------------------------------

def _lm_experiment(arch="qwen3-1.7b"):
    cfg = tbase.RunConfig(model=tsmoke(arch),
                          fed=tbase.FedConfig(num_nodes=K, local_steps=1),
                          train=tbase.TrainConfig(learning_rate=3e-4,
                                                  batch_size=B))
    nodes = [tsynthetic.token_lm(seed=i, n_seqs=16, seq_len=16,
                                 vocab=cfg.model.vocab_size)
             for i in range(K)]
    seqs = np.stack([d.x for d in nodes])
    data = {"tokens": seqs[..., :-1], "labels": seqs[..., 1:]}
    items = tpipeline.FederatedBatcher(nodes, B, 1).node_items()
    return texp.Experiment(cfg, device="cpu"), data, items


def test_model_derived_experiment_runs_and_resumes_bit_for_bit(tmp_path):
    exp, data, items = _lm_experiment()
    straight = exp.compile(data, items).run(2)
    loss = straight.metrics["loss"]
    assert tuple(loss.shape) == (2, K) and torch.isfinite(loss).all()
    assert set(straight.final_params) == {"embed", "final_norm", "layers",
                                          "lm_head"}
    first = exp.compile(data, items)
    part1 = first.run(1)
    first.save(str(tmp_path / "ckpt"))
    resumed = exp.compile(data, items).resume(str(tmp_path / "ckpt"))
    part2 = resumed.run(1)
    assert torch.equal(straight.state.buf, part2.state.buf)
    assert torch.equal(straight.state.opt.m, part2.state.opt.m)
    assert torch.equal(straight.state.opt.v, part2.state.opt.v)
    assert torch.equal(straight.state.opt.step, part2.state.opt.step)
    for name, v in straight.metrics.items():
        assert torch.equal(v, torch.cat([part1.metrics[name],
                                         part2.metrics[name]])), name
    # one trainer, keyed on (eval_fn, sequence length) as the reference's
    assert list(exp._trainers) == [(None, 16)]


def test_model_derived_experiment_trains_rwkv6_and_refuses_moe():
    """rwkv6 trains; so does mixtral (ROADMAP item 23c, refused until it
    was ported): one round with a finite loss, and its MoE load-balance
    loss is nonzero and reaches the router's gradient."""
    exp, data, items = _lm_experiment("rwkv6-7b")
    result = exp.compile(data, items).run(1)
    assert torch.isfinite(result.metrics["loss"]).all()
    exp, data, items = _lm_experiment("mixtral-8x7b")
    session = exp.compile(data, items)
    before = session.state.buf.clone()
    result = session.run(1)
    assert torch.isfinite(result.metrics["loss"]).all()
    assert not torch.equal(result.state.buf, before)
    cfg = exp.config.model
    params = flatten.tree_map(lambda t: t.detach().clone(),
                              ttransformer._layer(result.final_params, 0))
    router = params["layers"]["ffn"]["router"].requires_grad_(True)
    batch = {"tokens": torch.as_tensor(data["tokens"][0, :B]),
             "labels": torch.as_tensor(data["labels"][0, :B])}
    _, aux = ttransformer.forward(params, cfg, batch)
    assert aux.item() > 0.0
    (grad_aux,) = torch.autograd.grad(aux, router)
    assert float(grad_aux.abs().max()) > 0.0
    loss = ttransformer.loss_fn(params, cfg, batch)
    plain = ttransformer.loss_fn(
        params, dataclasses.replace(cfg, router_aux_coef=0.0), batch)
    assert abs((loss - plain).item() - cfg.router_aux_coef * aux.item()) \
        <= 1e-6 * loss.item()