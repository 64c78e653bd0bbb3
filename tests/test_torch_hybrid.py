"""The port's zamba2 hybrid (``models/mamba2.py``, ``models/hybrid.py``)
against ``repro.models.mamba2``/``hybrid`` on bridged weights (reduced
zamba2-2.7b: 2 layers, d_model 128, 8 SSD heads of 32 with state 16, the
shared block every 2 layers with 4 heads of 32, vocab 512).

The Mamba-2 block, forward logits and the loss in fp32 (1e-4, absolute and
relative) and bf16 (4e-2 of the reference output's largest magnitude: the
frameworks round bf16 elementwise ops at different points, and a hybrid
layer chains more of them than an RWKV one (conv, SSD readout, gated norm,
then the shared block's 2 d_model concat): single logits differ by up to
4 bf16 ulps after two layers); every
parameter gradient against ``jax.value_and_grad(api.loss)`` in fp32
(1e-3); token-by-token decoding against the port's own forward and the
reference's ``decode_step``, caches included (1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get_model as ref_get_model
from repro.models import mamba2 as ref_mamba2
from repro_torch.models import get_model as port_get_model
from repro_torch.models import hybrid, mamba2
from repro_torch.models.layers import tree_leaves, zeros
from repro_torch.models.transformer import layer_params
from test_torch_bridge import bridged, port_config, small_config

TOL = {"float32": 1e-4, "bfloat16": 4e-2}
GRAD_TOL = 1e-3


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    cfg = small_config("zamba2-2.7b", dtype=request.param)
    jparams, tparams = bridged(cfg)
    return cfg, ref_get_model(cfg), port_get_model(port_config(cfg)), jparams, tparams


def _close(got, want, tol, dtype="float32"):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "bfloat16":
        atol, rtol = tol * float(np.abs(want).max()), 0.0
    else:
        atol = rtol = tol
    np.testing.assert_allclose(got.detach().float().numpy(), want, atol=atol, rtol=rtol)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S), dtype=np.int32)


def _x(cfg, B, S, seed):
    """(jax, torch) activations of the compute dtype, equal values."""
    x = (0.5 * np.random.default_rng(seed).standard_normal((B, S, cfg.d_model))).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(cfg.dtype))
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, cfg.dtype))


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_apply(model, with_state):
    cfg, _, _, jp, tp = model
    jx, tx = _x(cfg, 2, 64, 0)
    state = None
    if with_state:
        shape = (2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
        state = (0.3 * np.random.default_rng(1).standard_normal(shape)).astype(np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["layers"])["mamba"]
    want, want_state = ref_mamba2.mamba2_apply(
        jl, jx, cfg, state=None if state is None else jnp.asarray(state))
    got, got_state = mamba2.mamba2_apply(
        layer_params(tp, 0)["mamba"], tx, port_config(cfg),
        state=None if state is None else torch.from_numpy(state))
    _close(got, want, TOL[cfg.dtype], cfg.dtype)
    _close(got_state, want_state, TOL[cfg.dtype], cfg.dtype)


def test_forward_logits(model):
    cfg, ref, port, jp, tp = model
    toks = _tokens(cfg, 2, 32, 2)
    _close(port.forward(tp, torch.from_numpy(toks)), ref.forward(jp, jnp.asarray(toks)),
           TOL[cfg.dtype], cfg.dtype)


def test_loss(model):
    cfg, ref, port, jp, tp = model
    toks = _tokens(cfg, 2, 33, 3)
    labels = np.roll(toks, -1, axis=1)
    labels[0, :5] = -1  # masked positions
    want, _ = ref.loss(jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    got, metrics = port.loss(tp, {"tokens": torch.from_numpy(toks),
                                  "labels": torch.from_numpy(labels)})
    assert got.dtype == torch.float32 and set(metrics) == {"loss", "xent"}
    _close(got, want, TOL[cfg.dtype], cfg.dtype)


@pytest.mark.parametrize("remat", ["full", "none"])
def test_parameter_gradients(remat):
    """Three layers, so the shared block runs twice (layers 0 and 2) and its
    gradient sums both invocations."""
    cfg = small_config("zamba2-2.7b", remat_policy=remat, num_layers=3)
    jp, tp = bridged(cfg, seed=1)
    toks = _tokens(cfg, 2, 64, 4)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    (want_loss, _), want = jax.value_and_grad(ref_get_model(cfg).loss, has_aux=True)(
        jp, jax.tree.map(jnp.asarray, batch))
    leaves = [p.requires_grad_() for p in tree_leaves(tp)]
    loss, _ = port_get_model(port_config(cfg)).loss(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    _close(loss, want_loss, TOL["float32"])
    want_leaves = jax.tree_util.tree_leaves(want)  # sorted dict keys, as tree_leaves
    assert len(grads) == len(want_leaves)
    for g, jg in zip(grads, want_leaves):
        assert g.shape == jg.shape
        _close(g, jg, GRAD_TOL)


def test_decode_matches_forward_and_reference():
    """Token-by-token decode over 3 layers (two shared invocations) equals
    the reference's decode step by step, caches included, and the port's
    own forward at the last position."""
    from repro.models.layers import init_params as ref_init

    cfg = small_config("zamba2-2.7b", num_layers=3)
    jp, tp = bridged(cfg, seed=2)
    ref, port = ref_get_model(cfg), port_get_model(port_config(cfg))
    toks = _tokens(cfg, 2, 12, 5)
    full = port.forward(tp, torch.from_numpy(toks))
    tcache = zeros(port.cache_schema(2, 16), torch.device("cpu"))
    jcache = ref_init(jax.random.PRNGKey(0), ref.cache_schema(2, 16))
    for t in range(toks.shape[1]):
        tok = toks[:, t:t + 1]
        got, tcache = port.decode_step(tp, torch.from_numpy(tok), tcache, t)
        want, jcache = ref.decode_step(jp, jnp.asarray(tok), jcache, jnp.int32(t))
        _close(got, want, TOL["float32"])
        _close(got, full[:, t].detach().numpy(), TOL["float32"])
    for key in ("ssm", "conv", "k", "v"):
        _close(tcache[key], jcache[key], TOL["float32"])


def test_schema_matches_reference():
    """The full zamba2-2.7b schema (no allocation): the reference's paths,
    shapes and parameter count."""
    from repro.configs import get_config
    from repro.models.layers import is_spec as ref_is_spec
    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.models.layers import param_count

    cfg = get_config("zamba2-2.7b")
    want = jax.tree_util.tree_flatten_with_path(ref_get_model(cfg).schema, is_leaf=ref_is_spec)[0]
    want = {"/".join(k.key for k in kp): s.shape for kp, s in want}
    pcfg = port_config(cfg)
    schema = port_get_model(pcfg).schema
    got = {k: s.shape for k, s in flatten(schema).items()}
    assert got == want
    assert param_count(schema) == 2_360_379_040
    assert hybrid.n_shared_invocations(pcfg) == 9
