"""Weight bridge: reference checkpoints and parameter trees load into the
PyTorch port leaf for leaf.

Also home of the helpers the other ``test_torch_*`` files share: reference
parameters made from a seed (with nonzero norms and biases, so those paths
are exercised) and carried into the port through the bridge.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.models import get_model as ref_get_model
from repro_torch.checkpoint.ckpt import (
    flatten,
    load_reference_checkpoint,
    params_from_numpy,
)
from repro_torch.configs.base import ModelConfig as TorchModelConfig


def port_config(ref_cfg):
    """The port's ModelConfig with the reference config's fields."""
    return TorchModelConfig(**dataclasses.asdict(ref_cfg))


def small_config(name, **overrides):
    """Reduced reference config (2 layers, d_head 32), fp32 unless given."""
    cfg = ref_get_config(name).reduced()
    return dataclasses.replace(cfg, **{"dtype": "float32", **overrides})


def reference_params(cfg, seed=0):
    """(jax params, flat numpy dict): the reference's init, with every
    zero-initialised leaf (norm scales, qkv biases) replaced by seeded
    noise so the bridge and the port's use of those leaves are tested."""
    params = ref_get_model(cfg).init(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in ref_ckpt._flatten(params).items()}
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if not v.any():
            flat[k] = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
    _, treedef = jax.tree_util.tree_flatten(params)
    jparams = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(flat[k]) for k in flat])
    return jparams, flat


def bridged(cfg, seed=0):
    """(reference jax params, port torch params on the CPU), equal weights
    in separate memory: on the CPU both ``jnp.asarray`` and
    ``torch.from_numpy`` may share the numpy buffer, and the port's
    optimizer updates parameters in place while a reference step
    dispatched just before may still be reading them."""
    jparams, flat = reference_params(cfg, seed)
    return jparams, params_from_numpy({k: v.copy() for k, v in flat.items()}, device="cpu")


@pytest.mark.parametrize("name", ["llama3-8b", "qwen2-1.5b"])
def test_reference_checkpoint_loads_leaf_by_leaf(tmp_path, name):
    cfg = small_config(name)
    jparams, flat = reference_params(cfg)
    ref_ckpt.save(str(tmp_path), jparams, step=3, async_=False,
                  extra_meta={"arch": cfg.name})
    tree, meta = load_reference_checkpoint(str(tmp_path), device="cpu")
    assert meta["step"] == 3 and meta["arch"] == cfg.name
    got = flatten(tree)
    assert sorted(got) == sorted(flat)
    for k, want in flat.items():
        t = got[k]
        assert t.device.type == "cpu" and tuple(t.shape) == want.shape, k
        assert str(t.dtype).removeprefix("torch.") == want.dtype.name, k
        np.testing.assert_array_equal(t.numpy(), want, err_msg=k)


def test_load_picks_requested_step(tmp_path):
    cfg = small_config("llama3-8b")
    j0, f0 = reference_params(cfg, seed=0)
    j1, f1 = reference_params(cfg, seed=1)
    ref_ckpt.save(str(tmp_path), j0, step=1, async_=False)
    ref_ckpt.save(str(tmp_path), j1, step=2, async_=False)
    latest, meta = load_reference_checkpoint(str(tmp_path), device="cpu")
    first, _ = load_reference_checkpoint(str(tmp_path), step=1, device="cpu")
    assert meta["step"] == 2
    key = "layers/attn/wq"
    np.testing.assert_array_equal(flatten(latest)[key].numpy(), f1[key])
    np.testing.assert_array_equal(flatten(first)[key].numpy(), f0[key])
    with pytest.raises(FileNotFoundError):
        load_reference_checkpoint(str(tmp_path / "missing"), device="cpu")


def test_params_from_numpy_matches_port_schema():
    """Bridged trees have the port schema's paths and shapes."""
    from repro_torch.models.api import get_model
    from repro_torch.models.layers import is_spec

    cfg = small_config("qwen2-1.5b")
    _, params = bridged(cfg)
    schema = flatten(get_model(port_config(cfg)).schema)
    got = flatten(params)
    assert sorted(got) == sorted(schema)
    for k, spec in schema.items():
        assert is_spec(spec) and tuple(got[k].shape) == spec.shape, k
    assert isinstance(got["embed"], torch.Tensor)
