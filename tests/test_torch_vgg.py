"""VGG-16 in the port against ``repro.models.vgg``, on the CPU.

The full VGG-16 schema (no allocation) and a reduced ``VGGConfig`` (four
3x3 convolutions with three 2x2 pools, on 32 x 32 images, then two dense
layers) on bridged weights: forward, loss and every gradient against
the reference's, in fp32 at 1e-5 (relative, plus 1e-5 of each leaf's
largest gradient, as ``tests/test_torch_transformer_train.py``); the
flatten before ``fc6`` in NHWC order, which an NCHW flatten would break;
the init's shapes and std rules.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.checkpoint import ckpt as ref_ckpt
from repro.configs import vgg16 as ref_vgg16
from repro.models import vgg as ref_vgg
from repro_torch.checkpoint import ckpt
from repro_torch.configs import vgg16
from repro_torch.models import vgg
from repro_torch.models.layers import tree_leaves

TOL = 1e-5


def _layers(mod):
    C, D = mod.ConvSpec, mod.DenseSpec
    return (C("conv1", 3, 8, 32, pool_after=True), C("conv2", 8, 16, 16),
            C("conv3", 16, 16, 16, pool_after=True), C("conv4", 16, 12, 8, pool_after=True),
            D("fc6", 4 * 4 * 12, 32), D("fc7", 32, 10))


SMALL = vgg16.VGGConfig(name="vgg-small", layers=_layers(vgg16), num_classes=10,
                        image_size=32, global_batch=4)
REF_SMALL = ref_vgg16.VGGConfig(name="vgg-small", layers=_layers(ref_vgg16), num_classes=10,
                                image_size=32, global_batch=4)


def _bridged(seed=0):
    """(reference params, port params): the reference's init with the
    zero biases replaced by seeded noise, carried over leaf for leaf."""
    jparams = ref_vgg.init(jax.random.PRNGKey(seed), REF_SMALL)
    flat = {k: np.asarray(v) for k, v in ref_ckpt._flatten(jparams).items()}
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if not v.any():
            flat[k] = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
    jparams = {}
    for k, v in flat.items():  # VGG's tree is {layer: {"w", "b"}}
        layer, leaf = k.split("/")
        jparams.setdefault(layer, {})[leaf] = jnp.asarray(v)
    return jparams, ckpt.params_from_numpy({k: v.copy() for k, v in flat.items()}, device="cpu")


def _batch(B=4, seed=1):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (B,)).astype(np.int32)
    return ({"images": jnp.asarray(images), "labels": jnp.asarray(labels)},
            {"images": torch.from_numpy(images), "labels": torch.from_numpy(labels).long()})


def test_full_vgg16_schema_matches_reference():
    want = ref_ckpt._flatten(ref_vgg.vgg_schema(ref_vgg16.CONFIG))
    got = ckpt.flatten(vgg.vgg_schema(vgg16.CONFIG))
    assert sorted(got) == sorted(want) and len(got) == 32
    for k, w in want.items():
        assert (got[k].shape, got[k].axes, got[k].init) == (w.shape, w.axes, w.init), k
    assert got["conv1_1/w"].shape == (3, 3, 3, 64)  # HWIO
    assert got["fc6/w"].shape == (512 * 7 * 7, 4096)
    assert sum(int(np.prod(s.shape)) for s in got.values()) == 138_357_544


def test_forward_matches_reference():
    jp, tp = _bridged()
    jb, tb = _batch()
    want = ref_vgg.forward(jp, jb["images"], REF_SMALL)
    got = vgg.forward(tp, tb["images"], SMALL)
    assert tuple(got.shape) == want.shape == (4, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_loss_and_grads_match_reference():
    jp, tp = _bridged(2)
    jb, tb = _batch(seed=3)
    (jl, _), jg = jax.value_and_grad(ref_vgg.loss_fn, has_aux=True)(jp, jb, REF_SMALL)
    leaves = [p.requires_grad_(True) for p in tree_leaves(tp)]
    tl, metrics = vgg.loss_fn(tp, tb, SMALL)
    grads = dict(zip(ckpt.flatten(tp), torch.autograd.grad(tl, leaves)))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=TOL)
    assert sorted(metrics) == ["loss"]
    want = {k: np.asarray(v) for k, v in ref_ckpt._flatten(jg).items()}
    assert sorted(grads) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=TOL, atol=TOL * np.abs(w).max(),
                                   err_msg=k)


def _nchw_flatten_forward(params, images, vcfg):
    """``vgg.forward`` with the NCHW flatten (C, H, W) before the first
    dense layer: the order a PyTorch habit would give."""
    h = torch.as_tensor(images).permute(0, 3, 1, 2)
    for spec in vcfg.layers:
        p = params[spec.name]
        if isinstance(spec, vgg16.ConvSpec):
            h = F.relu(F.conv2d(h, p["w"].permute(3, 2, 0, 1), p["b"], padding=1))
            if spec.pool_after:
                h = F.max_pool2d(h, 2, 2)
        else:
            if h.dim() == 4:
                h = h.reshape(h.shape[0], -1)
            h = h @ p["w"] + p["b"]
            if spec.name != vcfg.layers[-1].name:
                h = F.relu(h)
    return h


def test_nchw_flatten_would_fail():
    """fc6's rows are in (H, W, C) order: the port matches the reference,
    and the same network flattened in (C, H, W) order does not."""
    jp, tp = _bridged(4)
    jb, tb = _batch(seed=5)
    want = np.asarray(ref_vgg.forward(jp, jb["images"], REF_SMALL))
    np.testing.assert_allclose(vgg.forward(tp, tb["images"], SMALL).numpy(), want,
                               rtol=TOL, atol=TOL)
    wrong = _nchw_flatten_forward(tp, tb["images"], SMALL).numpy()
    assert np.abs(wrong - want).max() > 100 * TOL * np.abs(want).max()
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(wrong, want, rtol=TOL, atol=TOL)


def test_init_shapes_and_std():
    """``init`` draws every leaf of the schema on the given device: zero
    biases, weights of std 1/sqrt(fan_in) (fan_in = k*k*in for a conv)."""
    params = vgg.init(torch.Generator().manual_seed(0), dataclasses.replace(
        SMALL, layers=SMALL.layers[:2] + (vgg16.DenseSpec("fc", 16 * 16 * 16, 10),)), "cpu")
    assert params["conv2"]["w"].shape == (3, 3, 8, 16)
    assert not params["conv1"]["b"].any()
    std = float(params["conv2"]["w"].std())
    assert abs(std - 1 / np.sqrt(3 * 3 * 8)) < 0.1 / np.sqrt(3 * 3 * 8)
    assert all(p.device.type == "cpu" and p.dtype == torch.float32
               for p in tree_leaves(params))


def test_init_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vgg.init(torch.Generator(), SMALL)
