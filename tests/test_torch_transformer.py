"""The port's dense transformer against ``repro.models.transformer`` on
bridged weights: forward logits, prefill logits and cache, then three
decode steps with a scalar and with a per-row ``cache_len``.

Tolerances: fp32 (``dtype="float32"``) at 1e-4; one bf16 case, where the
two frameworks round activations to bf16 at different points, at 5e-2
absolute on logits of unit scale.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get_model as ref_get_model
from repro_torch.models import get_model as port_get_model
from test_torch_bridge import bridged, port_config, small_config

F32_TOL = 1e-4
BF16_TOL = 5e-2

CONFIGS = ["llama3-8b", "qwen2-1.5b"]  # qwen2: qkv bias + tied embeddings


@pytest.fixture(scope="module", params=CONFIGS)
def model(request):
    cfg = small_config(request.param)
    jparams, tparams = bridged(cfg)
    return cfg, ref_get_model(cfg), port_get_model(port_config(cfg)), jparams, tparams


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S), dtype=np.int32)


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_forward_logits(model):
    cfg, ref, port, jp, tp = model
    toks = _tokens(cfg, 2, 9, 0)
    _close(port.forward(tp, torch.from_numpy(toks)), ref.forward(jp, jnp.asarray(toks)))


def test_prefill_logits_and_cache(model):
    cfg, ref, port, jp, tp = model
    toks = _tokens(cfg, 2, 11, 1)
    want_logits, want_cache = ref.prefill(jp, jnp.asarray(toks), 16)
    logits, cache = port.prefill(tp, torch.from_numpy(toks), 16)
    _close(logits, want_logits)
    for key in ("k", "v"):
        assert tuple(cache[key].shape) == want_cache[key].shape
        _close(cache[key], want_cache[key])


@pytest.mark.parametrize("per_row", [False, True])
def test_three_decode_steps(model, per_row):
    cfg, ref, port, jp, tp = model
    toks = _tokens(cfg, 2, 11, 2)
    _, jcache = ref.prefill(jp, jnp.asarray(toks), 16)
    _, tcache = port.prefill(tp, torch.from_numpy(toks), 16)
    lens = np.array([11, 6], np.int32) if per_row else np.int32(11)
    feed = _tokens(cfg, 2, 3, 3)
    for i in range(3):
        tok = feed[:, i:i + 1]
        want, jcache = ref.decode_step(jp, jnp.asarray(tok), jcache, jnp.asarray(lens + i))
        got, tcache = port.decode_step(tp, torch.from_numpy(tok), tcache,
                                       torch.as_tensor(lens + i))
        _close(got, want)
        for key in ("k", "v"):
            _close(tcache[key], jcache[key])


def test_bf16_forward_and_prefill():
    cfg = small_config("llama3-8b", dtype="bfloat16")
    jp, tp = bridged(cfg)
    ref, port = ref_get_model(cfg), port_get_model(port_config(cfg))
    toks = _tokens(cfg, 2, 12, 4)
    _close(port.forward(tp, torch.from_numpy(toks)), ref.forward(jp, jnp.asarray(toks)),
           BF16_TOL)
    want, _ = ref.prefill(jp, jnp.asarray(toks), 16)
    got, cache = port.prefill(tp, torch.from_numpy(toks), 16)
    assert cache["k"].dtype == torch.bfloat16
    _close(got, want, BF16_TOL)


@pytest.mark.parametrize("name,match", [
    ("qwen3-moe-30b-a3b", "MoE"), ("pixtral-12b", "vision"), ("rwkv6-1.6b", "not ported")])
def test_unported_families_raise(name, match):
    cfg = port_config(small_config(name))
    with pytest.raises(NotImplementedError, match=match):
        port_get_model(cfg)


def test_config_cut_keeps_reference_shapes():
    """The full llama3-8b schema (no allocation) has the reference's shapes."""
    from repro.configs import get_config
    from repro.models.layers import param_count as ref_count
    from repro_torch.models.layers import param_count

    cfg = get_config("llama3-8b")
    assert param_count(port_get_model(port_config(cfg)).schema) == ref_count(
        ref_get_model(cfg).schema)
    assert dataclasses.asdict(port_config(cfg))["num_layers"] == 32
