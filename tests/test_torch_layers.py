"""The port's layers against ``repro.models.layers`` on the same inputs
(fp32, atol = rtol = 1e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_layers
from repro_torch.models import layers as port_layers
from test_torch_bridge import bridged, port_config, small_config

TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def qwen():
    cfg = small_config("qwen2-1.5b")  # qkv bias
    jparams, tparams = bridged(cfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    jl = jax.tree.map(lambda a: a[0], jparams["layers"])  # layer 0
    tl = port_layers.tree_map(lambda a: a[0], tparams["layers"])
    return cfg, jl, tl, x


def test_rms_norm(qwen):
    cfg, jp, tp, x = qwen
    want = ref_layers.rms_norm(jnp.asarray(x), jp["ln1"], cfg.norm_eps)
    _close(port_layers.rms_norm(torch.from_numpy(x), tp["ln1"], cfg.norm_eps), want)


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_apply_rope(theta):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 3, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32) + 100, (2, 9))
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = port_layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), theta)
    _close(got, want)


def test_qkv_project_with_bias(qwen):
    cfg, jp, tp, x = qwen
    assert cfg.qkv_bias
    want = ref_layers.qkv_project(jp["attn"], jnp.asarray(x), cfg)
    got = port_layers.qkv_project(tp["attn"], torch.from_numpy(x), port_config(cfg))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


def test_out_project(qwen):
    cfg, jp, tp, _ = qwen
    a = np.random.default_rng(5).standard_normal(
        (2, 7, cfg.num_heads, cfg.d_head)).astype(np.float32)
    want = ref_layers.out_project(jp["attn"], jnp.asarray(a))
    _close(port_layers.out_project(tp["attn"], torch.from_numpy(a)), want)


def test_mlp_apply(qwen):
    cfg, jp, tp, x = qwen
    want = ref_layers.mlp_apply(jp["mlp"], jnp.asarray(x))
    _close(port_layers.mlp_apply(tp["mlp"], torch.from_numpy(x)), want)


def test_init_params_std_rules():
    """The reference's init rules: zeros for norms, 0.02 for embeddings,
    1/sqrt(fan_in) for weights."""
    from repro_torch.models.api import get_model

    cfg = port_config(small_config("llama3-8b"))
    api = get_model(cfg)
    p = api.init(torch.Generator().manual_seed(0), device="cpu")
    assert torch.count_nonzero(p["final_norm"]) == 0
    assert abs(float(p["embed"].std()) - 0.02) < 2e-3
    wq = p["layers"]["attn"]["wq"]  # (L, D, H, hd): fan_in = L*D*H
    assert abs(float(wq.std()) * np.sqrt(np.prod(wq.shape[:-1])) - 1.0) < 0.05
    assert port_layers.param_count(api.schema) == sum(
        t.numel() for t in port_layers.tree_leaves(p))
