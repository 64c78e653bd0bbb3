"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's.

``moe_apply``'s output and load-balancing loss against
``repro.models.moe.moe_apply`` on the same numpy inputs in fp32, at 1e-5
absolute and relative: reduced qwen3-moe-30b-a3b (4 experts, top 2), a
grok-1-like top 2 of 8, and a capacity factor of 0.5, where tokens are
dropped; gradients of every parameter group and of the input against
``jax.grad``, at 1e-5 of each leaf's largest magnitude.  Then the
reference's own properties (``tests/test_moe_dispatch.py``): generous
capacity equals the dense gate-weighted mixture, drops shrink the output,
the capacity formula, a gradient reaches every parameter group.  And the
weights: a reduced MoE tree crosses the reference's ``.npz`` format, and
the dtype-direct init gives every leaf its serving dtype and
``init_leaf``'s std.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.models import moe as ref_moe
from repro_torch.checkpoint.ckpt import flatten, load_reference_checkpoint
from repro_torch.models import get_model
from repro_torch.models import moe
from repro_torch.models.layers import init_leaf, init_params, keeps_fp32, tree_leaves
from test_torch_bridge import port_config, reference_params, small_config

TOL = 1e-5
GRAD_TOL = 1e-5

CASES = {
    # (arch, overrides): reduced qwen3-moe (4 experts, top 2), grok-1's top 2
    # of 8, and qwen3-moe at capacity factor 0.5 (tokens dropped)
    "qwen3-moe": ("qwen3-moe-30b-a3b", {}),
    "grok-1-top2of8": ("grok-1-314b", {"num_experts": 8}),
    "drops": ("qwen3-moe-30b-a3b", {"capacity_factor": 0.5}),
}


def _inputs(cfg, B=2, S=24, seed=0):
    """MoE parameters and an input, numpy fp32 from a seed (router scaled up
    so that routing is far from uniform)."""
    rng = np.random.default_rng(seed)
    D, E, F = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {"router": 0.3 * rng.standard_normal((D, E)),
         "wg": 0.05 * rng.standard_normal((E, D, F)),
         "wu": 0.05 * rng.standard_normal((E, D, F)),
         "wd": 0.05 * rng.standard_normal((E, F, D))}
    x = rng.standard_normal((B, S, D))
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return {k: f32(v) for k, v in p.items()}, f32(x)


def _cfg(name):
    arch, kw = CASES[name]
    return small_config(arch, **kw)


def _both(p, x):
    return ({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
            {k: torch.from_numpy(v.copy()) for k, v in p.items()}, torch.from_numpy(x.copy()))


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_apply_matches_reference(name):
    cfg = _cfg(name)
    jp, jx, tp, tx = _both(*_inputs(cfg))
    want, want_aux = jax.jit(lambda p, x: ref_moe.moe_apply(p, x, cfg))(jp, jx)
    got, aux = moe.moe_apply(tp, tx, port_config(cfg))
    assert got.shape == tx.shape and aux.dtype == torch.float32 and aux.dim() == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=TOL, rtol=TOL)


def test_drops_happen_at_capacity_factor_half():
    """The ``drops`` case really drops: at capacity factor 0.5 some (token, k)
    pairs find their expert full, and the output differs from the
    generous-capacity one."""
    cfg = _cfg("drops")
    p, x = _inputs(cfg)
    _, _, tp, tx = _both(p, x)
    tight = moe.moe_apply(tp, tx, port_config(cfg))[0]
    loose = moe.moe_apply(tp, tx, port_config(dataclasses.replace(cfg, capacity_factor=100.0)))[0]
    T, K, E = x.shape[0] * x.shape[1], cfg.experts_per_tok, cfg.num_experts
    assert moe._capacity(T, cfg) * E < T * K
    assert not torch.allclose(tight, loose)


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_gradients_match_jax_grad(name):
    """d/d(params, x) of <out, proj> + aux against ``jax.grad``."""
    cfg = _cfg(name)
    p, x = _inputs(cfg, seed=1)
    proj = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    jp, jx, tp, tx = _both(p, x)

    def jloss(params, xx):
        out, aux = ref_moe.moe_apply(params, xx, cfg)
        return jnp.sum(out * proj) + aux

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jx)
    leaves = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx.requires_grad_(True)
    out, aux = moe.moe_apply(leaves, tx, port_config(cfg))
    grads = torch.autograd.grad((out * torch.from_numpy(proj)).sum() + aux,
                                [*leaves.values(), tx])
    want = [*(np.asarray(jg[k]) for k in leaves), np.asarray(jgx)]
    for k, g, w in zip([*leaves, "x"], grads, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(w).max(), err_msg=k)


# ---------------------------------------------------------------------------
# the reference's properties (tests/test_moe_dispatch.py)
# ---------------------------------------------------------------------------


def _setup(E=4, K=2, D=16, F=8, T=32, cf=8.0):
    cfg = dataclasses.replace(
        port_config(small_config("qwen3-moe-30b-a3b")),
        num_experts=E, experts_per_tok=K, moe_d_ff=F, d_model=D, capacity_factor=cf)
    g = torch.Generator().manual_seed(0)
    params = init_params(moe.moe_schema(cfg), g, "cpu")
    x = torch.randn((2, T // 2, D), generator=g)
    return cfg, params, x


def test_generous_capacity_equals_dense_mixture():
    cfg, params, x = _setup(cf=100.0)
    out, aux = moe.moe_apply(params, x, cfg)
    assert float(aux) > 0.0
    xt = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(xt @ params["router"], dim=-1)
    vals, idx = torch.topk(probs, cfg.experts_per_tok)
    vals = vals / vals.sum(-1, keepdim=True)
    experts = torch.stack([
        (torch.nn.functional.silu(xt @ params["wg"][e]) * (xt @ params["wu"][e]))
        @ params["wd"][e] for e in range(cfg.num_experts)])  # (E, T, D)
    want = sum(vals[:, k, None] * experts[idx[:, k], torch.arange(xt.shape[0])]
               for k in range(cfg.experts_per_tok))
    torch.testing.assert_close(out.reshape(-1, x.shape[-1]), want, atol=1e-4, rtol=1e-4)


def test_capacity_drops_tokens():
    cfg, params, x = _setup(cf=100.0)
    full, _ = moe.moe_apply(params, x, cfg)
    tight, _ = moe.moe_apply(params, x, dataclasses.replace(cfg, capacity_factor=0.01))
    assert bool(torch.isfinite(tight).all())
    assert float(tight.abs().mean()) < float(full.abs().mean())


def test_capacity_formula():
    cfg, _, _ = _setup(E=8, K=2, cf=1.0)
    assert moe._capacity(64, cfg) == 64 * 2 // 8
    assert moe._capacity(4, cfg) == cfg.experts_per_tok  # the floor
    for T in (1, 7, 100, 4096):
        rc = dataclasses.replace(small_config("qwen3-moe-30b-a3b"), num_experts=8,
                                 experts_per_tok=2, capacity_factor=1.0)
        assert moe._capacity(T, cfg) == ref_moe._capacity(T, rc)


def test_grad_flows_to_all_param_groups():
    cfg, params, x = _setup(cf=100.0)
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    out, aux = moe.moe_apply(leaves, x, cfg)
    grads = torch.autograd.grad((out ** 2).sum() + aux, list(leaves.values()))
    for name, g in zip(leaves, grads):
        assert float(g.abs().sum()) > 0.0, name


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]])
    vals, idx = moe._top_k(probs, 2)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(jidx).tolist() == [[0, 1], [1, 2]]


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "grok-1-314b"])
def test_reference_moe_checkpoint_loads_leaf_by_leaf(tmp_path, arch):
    """``params_from_numpy`` carries the MoE leaves (router, wg, wu, wd)
    from the reference's ``.npz`` into the port's schema."""
    cfg = small_config(arch)
    jparams, flat = reference_params(cfg)
    ref_ckpt.save(str(tmp_path), jparams, step=1, async_=False)
    tree, _ = load_reference_checkpoint(str(tmp_path), device="cpu")
    got = flatten(tree)
    schema = flatten(get_model(port_config(cfg)).schema)
    assert sorted(got) == sorted(flat) == sorted(schema)
    assert {"layers/moe/router", "layers/moe/wg", "layers/moe/wu", "layers/moe/wd"} <= set(got)
    for k, want in flat.items():
        assert tuple(got[k].shape) == want.shape == schema[k].shape, k
        np.testing.assert_array_equal(got[k].numpy(), want, err_msg=k)


# leaves the reference reads in fp32 however the model computes (its
# ``.astype(jnp.float32)`` reads and ``rms_norm``'s scale): a serving copy
# keeps them fp32
READ_IN_FP32 = {
    "qwen3-moe-30b-a3b": ["layers/moe/router", "layers/ln1", "final_norm"],
    "grok-1-314b": ["layers/moe/router", "layers/ln2"],
    "llama3-8b": ["layers/ln1", "final_norm"],
    "rwkv6-1.6b": ["layers/mix/u_bonus", "layers/mix/w0", "layers/mix/w_lora_a",
                   "layers/mix/w_lora_b", "layers/mix/ln_x"],
    "zamba2-2.7b": ["layers/mamba/dt_bias", "layers/mamba/A_log", "layers/mamba/gate_norm"],
}


@pytest.mark.parametrize("arch", sorted(READ_IN_FP32))
def test_dtype_direct_init(arch, monkeypatch):
    """``init(..., dtype)`` gives each leaf its serving dtype (fp32 for the
    leaves the reference reads in fp32, among them the norm scales, the
    router and the recurrent families' decay parameters) and
    ``init_leaf``'s std, drawn in chunks (made small here so that a leaf
    spans several); ``serving_params`` then returns those leaves as they
    are."""
    from repro_torch.models import layers
    from repro_torch.serve.engine import serving_params

    monkeypatch.setattr(layers, "_INIT_CHUNK", 4096)
    cfg = port_config(small_config(arch, dtype="bfloat16", d_model=256))
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), "cpu", dtype=cfg.dtype)
    specs = flatten(api.schema)
    for k, t in flatten(params).items():
        spec = specs[k]
        want_dt = torch.float32 if keeps_fp32(spec) else torch.bfloat16
        assert t.dtype == want_dt and tuple(t.shape) == spec.shape, k
        if spec.init in ("zeros", "ones"):
            assert torch.equal(t.float(), init_leaf(spec, None, "cpu")), k
            continue
        ref = init_leaf(spec, torch.Generator().manual_seed(1), "cpu")
        std, want_std = float(t.float().std()), float(ref.std())
        assert abs(std - want_std) < 0.05 * want_std, (k, std, want_std)
        assert abs(float(t.float().mean())) < 0.05 * want_std, k
    got = flatten(params)
    for k in READ_IN_FP32[arch]:
        assert got[k].dtype == torch.float32, k
    assert all(a is b for a, b in zip(tree_leaves(serving_params(api, params, torch.device("cpu"))),
                                      tree_leaves(params)))
