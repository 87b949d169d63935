"""The paper's VGG in the port against the JAX package: ``vgg_forward``, the
loss and its gradient at reduced widths (the JAX side vmapped over the K
nodes, the port K-batched through grouped convolutions), the nested flat
layout's offsets against ``repro.core.flatten.make_layout`` (at
``VGG_CONFIG`` too: P = 76,981, padded to 77,056), a 3-round VGG Session
from the same init and batch indices, the convolutions' TF32 switch, and
the copied data helpers (``synthetic_bird``, ``cross_node_overlap``,
``data/partition.py``) giving identical arrays. Both packages on the
CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import experiment as jexp
from repro.configs.base import FedConfig, TrainConfig
from repro.configs.paper_models import VGG_CONFIG, VGGConfig
from repro.core import flatten as jflat
from repro.data import partition as jpartition
from repro.data import pipeline, redundancy, synthetic
from repro.models import simple
from repro_torch import convert
from repro_torch import experiment as texp
from repro_torch.configs import base as tbase
from repro_torch.configs import paper_models as tmodels
from repro_torch.core import flatten as tflat
from repro_torch.data import partition as tpartition
from repro_torch.data import redundancy as tredundancy
from repro_torch.data import synthetic as tsynthetic
from repro_torch.models import simple as tsimple

TOL = 1e-5
# reduced widths: (image size, conv stages)
REDUCED = {"image8-stages4x8": (8, (4, 8)),
           "image16-stages4x8x8": (16, (4, 8, 8))}


def _configs(image, stages):
    return (VGGConfig(image_size=image, stages=stages),
            tmodels.VGGConfig(image_size=image, stages=stages))


def _jax_params(cfg, k, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), k)
    return jax.vmap(lambda r: simple.vgg_init(r, cfg))(keys)


@pytest.mark.parametrize("name", list(REDUCED))
def test_forward_loss_and_grad_match_reference(name):
    jcfg, tcfg = _configs(*REDUCED[name])
    k, b = 3, 5
    p = _jax_params(jcfg, k)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(k, b, jcfg.image_size, jcfg.image_size,
                         3)).astype(np.float32)
    y = rng.integers(0, jcfg.num_classes, size=(k, b)).astype(np.int32)
    batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}

    jloss = simple.make_vgg_loss(jcfg)
    logits = jax.vmap(simple.vgg_forward)(p, batch["x"])
    losses, grads = jax.vmap(jax.value_and_grad(jloss))(p, batch)
    gbuf, glayout = jflat.flatten(grads)

    buf, layout = convert.params_from_numpy(jax.tree.map(np.asarray, p),
                                            "cpu")
    assert layout.offsets == glayout.offsets and layout.padded == \
        glayout.padded
    pbuf = buf.clone().requires_grad_(True)
    params = tflat.unflatten(pbuf, layout)
    tb = {"x": torch.tensor(x), "y": torch.tensor(y)}
    np.testing.assert_allclose(
        tsimple.vgg_forward(params, tb["x"]).detach().numpy(),
        np.asarray(logits), atol=TOL, rtol=0)
    tlosses = tsimple.make_vgg_loss(tcfg)(params, tb)
    np.testing.assert_allclose(tlosses.detach().numpy(), np.asarray(losses),
                               atol=TOL, rtol=0)
    (g,) = torch.autograd.grad(tlosses.sum(), pbuf)
    np.testing.assert_allclose(g.numpy(), np.asarray(gbuf), atol=TOL,
                               rtol=0)
    assert not g[:, layout.total:].any()


@pytest.mark.parametrize("cfg_name", ["reduced", "VGG_CONFIG"])
def test_nested_layout_has_the_reference_offsets(cfg_name):
    jcfg, tcfg = ((VGG_CONFIG, tmodels.VGG_CONFIG) if cfg_name ==
                  "VGG_CONFIG" else _configs(8, (4, 8)))
    p = _jax_params(jcfg, 2, seed=5)
    jl = jflat.make_layout(p)
    tparams = tsimple.vgg_init(torch.Generator().manual_seed(0), tcfg,
                               device="cpu")
    stacked = tflat.tree_map(lambda v: v.expand((2,) + v.shape), tparams)
    tl = tflat.make_layout(stacked)
    assert tl.offsets == jl.offsets and tl.sizes == jl.sizes
    assert tl.shapes == jl.shapes
    assert (tl.total, tl.padded) == (jl.total, jl.padded)
    assert tl.names[:3] == ("fc_b", "fc_w", "stages/0/conv1")
    assert tl.paths[2] == ("stages", 0, "conv1")
    if cfg_name == "VGG_CONFIG":
        assert (tl.total, tl.padded) == (76_981, 77_056)
    # the JAX package's buffer and the port's agree column for column, and
    # unflatten rebuilds the same tree of views
    buf, layout = convert.params_from_numpy(jax.tree.map(np.asarray, p),
                                            "cpu")
    np.testing.assert_array_equal(buf.numpy(),
                                  np.asarray(jflat.flatten(p)[0]))
    back = tflat.unflatten(buf, layout)
    assert isinstance(back["stages"], list) and len(back["stages"]) == \
        len(jcfg.stages)
    for (path, got), want in zip(tflat.leaves_with_paths(back),
                                 jax.tree.leaves(p)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=str(path))
        assert got.untyped_storage().data_ptr() == \
            buf.untyped_storage().data_ptr()


def test_vgg_session_matches_reference():
    """Three rounds of a K=4 cdfl Session on the reduced VGG: same init
    (broadcast), same batch indices, within 1e-5."""
    jcfg, tcfg = _configs(8, (4, 8))
    k, s, b, n, rounds = 4, 2, 4, 24, 3
    nodes = [redundancy.inject_duplicates(synthetic.synthetic_bird(
        seed=i, n=n, num_classes=jcfg.num_classes, image_size=8, noise=1.5),
        0.5, seed=i) for i in range(k)]
    data = {"x": np.stack([d.x for d in nodes]),
            "y": np.stack([d.y for d in nodes])}
    items = pipeline.FederatedBatcher(nodes, b, s).node_items()
    fed_kw = dict(num_nodes=k, topology="ring", gamma=0.5, local_steps=s)
    train_kw = dict(learning_rate=jcfg.learning_rate, batch_size=b,
                    beta1=jcfg.beta1, beta2=jcfg.beta2, eps=jcfg.eps)
    jloss = simple.make_vgg_loss(jcfg)
    sample = jax.random.PRNGKey(7)
    session = jexp.Experiment.from_parts(
        lambda p, bt: jloss(p, bt), lambda r: simple.vgg_init(r, jcfg),
        fed=FedConfig(**fed_kw), train=TrainConfig(**train_kw)).compile(
            {name: jnp.asarray(v) for name, v in data.items()},
            jnp.asarray(items), rng=jax.random.PRNGKey(0), sample_rng=sample)
    init = jax.tree.map(lambda v: np.array(v[0]), session.state.params)
    keys = jax.vmap(lambda r: jax.random.fold_in(sample, r))(
        jnp.arange(rounds))
    idx = np.array(jax.vmap(lambda key: jax.random.randint(
        key, (k, s, b), 0, n))(keys))
    result = session.run(rounds)

    texp_ = texp.Experiment.from_parts(
        tsimple.make_vgg_loss(tcfg),
        lambda g: tflat.tree_map(torch.tensor, init),
        fed=tbase.FedConfig(**fed_kw), train=tbase.TrainConfig(**train_kw),
        device="cpu")
    tresult = texp_.compile(data, items).run(rounds, idx=idx)
    ref = convert.state_from_numpy(result.state, "cpu")
    assert ref.layout == tresult.state.layout
    for got, want in ((tresult.state.buf, ref.buf),
                      (tresult.state.opt.m, ref.opt.m),
                      (tresult.state.opt.v, ref.opt.v)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL,
                                   rtol=0)
    for name in ("loss", "disagreement", "gamma"):
        np.testing.assert_allclose(tresult.metrics[name].numpy(),
                                   np.asarray(result.metrics[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert isinstance(tresult.final_params["stages"], list)


def test_convolutions_run_with_tf32_off_forward_and_backward(monkeypatch):
    """cuDNN allows TF32 by default; every VGG convolution, forward and
    backward, sees it off, with deterministic algorithms on and the
    benchmark search off, on channels-last tensors, and the caller's
    settings come back after."""
    cudnn = torch.backends.cudnn
    seen = []

    def spy(fn):
        def wrapped(*args, **kw):
            x = args[0] if fn.__name__ != "conv2d_input" else args[2]
            seen.append((fn.__name__, (cudnn.allow_tf32, cudnn.deterministic,
                                       cudnn.benchmark),
                         x.is_contiguous(memory_format=torch.channels_last)))
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(tsimple.F, "conv2d", spy(tsimple.F.conv2d))
    monkeypatch.setattr(torch.nn.grad, "conv2d_input",
                        spy(torch.nn.grad.conv2d_input))
    monkeypatch.setattr(torch.nn.grad, "conv2d_weight",
                        spy(torch.nn.grad.conv2d_weight))
    monkeypatch.setattr(cudnn, "benchmark", True)
    _, tcfg = _configs(8, (4, 8))
    params = tsimple.vgg_init(torch.Generator().manual_seed(0), tcfg,
                              device="cpu")
    stacked = tflat.tree_map(
        lambda v: v.expand((2,) + v.shape).clone().requires_grad_(True),
        params)
    x = torch.randn(2, 3, 8, 8, 3)
    callers = (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark)
    assert callers == (True, False, True)
    loss = tsimple.make_vgg_loss(tcfg)(stacked, {
        "x": x, "y": torch.zeros(2, 3, dtype=torch.int64)})
    assert (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark) == callers
    loss.sum().backward()
    assert (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark) == callers
    names = [name for name, _, _ in seen]
    assert names.count("conv2d") == 4
    assert names.count("conv2d_weight") == 4
    assert names.count("conv2d_input") == 3     # no gradient for the data
    assert all(flags == (False, True, False) for _, flags, _ in seen)
    assert all(channels_last for _, _, channels_last in seen)


def test_data_helpers_give_identical_arrays():
    j = [synthetic.synthetic_bird(seed=i, n=12, image_size=8, noise=1.5,
                                  classes=[0, 2] if i else None)
         for i in range(3)]
    t = [tsynthetic.synthetic_bird(seed=i, n=12, image_size=8, noise=1.5,
                                   classes=[0, 2] if i else None)
         for i in range(3)]

    def same(a, b):
        assert len(a) == len(b)
        for da, db in zip(a, b):
            for field in ("x", "y", "features"):
                np.testing.assert_array_equal(getattr(da, field),
                                              getattr(db, field))

    same(j, t)
    for overlap in (0.0, 0.25, 0.5):
        same(redundancy.cross_node_overlap(j, overlap, seed=3),
             tredundancy.cross_node_overlap(t, overlap, seed=3))
    big_j = synthetic.synthetic_mnist(seed=4, n=60)
    big_t = tsynthetic.synthetic_mnist(seed=4, n=60)
    same(jpartition.iid_partition(big_j, 4, seed=1),
         tpartition.iid_partition(big_t, 4, seed=1))
    for alpha in (0.1, 0.5, 5.0):
        same(jpartition.dirichlet_partition(big_j, 7, alpha=alpha, seed=2),
             tpartition.dirichlet_partition(big_t, 7, alpha=alpha, seed=2))
