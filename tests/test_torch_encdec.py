"""The encoder-decoder family (seamless-m4t-large-v2) in the port against
``repro.models.encdec``, on the CPU, and the port's ``layer_norm``.

Reduced seamless (2 encoder and 2 decoder layers, d_model 128, 4 heads of
32) on bridged weights, the reference called outside any
``fsdp.context``: the schema, ``encode``, ``forward``, the loss and every
gradient against ``jax.value_and_grad(api.loss)``, ``decode_step`` over
several steps against a zero encoder memory and against one filled from
``_enc_kv``, ``ServingEngine.generate``, the continuous engine's outcome,
the host batches bit for bit, both length rules of the batch builders,
three AdamW steps, and the train and serve CLIs.

Tolerances: fp32 at 1e-4 on activations and logits (``F32_TOL``, as
``tests/test_torch_transformer.py``), losses at 1e-5 relative and
gradients at 1e-5 relative plus 1e-5 of each leaf's largest magnitude (as
``tests/test_torch_transformer_train.py``).  In bf16 the two frameworks
round activations at different points: logits and encoder outputs of unit
scale at 5e-2 absolute (``BF16_TOL``), the loss at 1e-2 relative, each
gradient at 5e-2 of its leaf's largest magnitude (``BF16_GRAD_TOL``, the
bound ``chip_smoke.py`` holds kernel against plain to).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.data.pipeline import SyntheticLMData as RefData
from repro.models import encdec as ref_encdec
from repro.models import get_model as ref_get_model
from repro.models.api import make_batch as ref_make_batch
from repro.models.api import train_input_specs as ref_specs
from repro.models.layers import layer_norm as ref_layer_norm
from repro.serve.engine import ContinuousBatchingEngine as RefContinuous
from repro.serve.engine import ServingEngine as RefServing
from repro_torch.checkpoint import ckpt
from repro_torch.configs import TRAIN_4K, get_config
from repro_torch.data.pipeline import SyntheticLMData, make_host_batch
from repro_torch.models import encdec, get_model
from repro_torch.models.api import make_batch, train_input_specs
from repro_torch.models.layers import layer_norm, tree_leaves, tree_map
from repro_torch.serve.engine import ContinuousBatchingEngine, ServingEngine
from repro_torch.serve.scheduler import Request
from test_torch_bridge import bridged, port_config, small_config
from test_torch_train import _batch, _step_and_trajectory
from test_torch_transformer_train import _assert_grads, _loss_and_grads

ARCH = "seamless-m4t-large-v2"
F32_TOL = 1e-4
BF16_TOL = 5e-2
LOSS_TOL = 1e-5
BF16_LOSS_TOL = 1e-2
BF16_GRAD_TOL = 5e-2


def _cfg(**kw):
    return small_config(ARCH, **kw)


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _frames(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S), dtype=np.int32)


@pytest.mark.parametrize("full", [False, True])
def test_schema_matches_reference(full):
    """Leaf names, shapes and init rules of the parameter and cache
    schemas (the full config's without allocating)."""
    from repro.configs import get_config as ref_get_config

    rcfg = ref_get_config(ARCH) if full else _cfg()
    port = get_model(port_config(rcfg))
    want = ref_ckpt._flatten(ref_get_model(rcfg).schema)
    got = ckpt.flatten(port.schema)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert (got[k].shape, got[k].axes, got[k].init) == (w.shape, w.axes, w.init), k
    cache_want = ref_ckpt._flatten(ref_encdec.cache_schema(rcfg, 2, 16))
    cache_got = ckpt.flatten(port.cache_schema(2, 16))
    assert {k: v.shape for k, v in cache_got.items()} == {k: v.shape for k, v in cache_want.items()}
    assert cache_got["enc_k"].shape[2] == encdec.ENC_MEMORY == ref_encdec.ENC_MEMORY
    assert encdec.DEC_RATIO == ref_encdec.DEC_RATIO
    if full:
        from repro.models.layers import param_count as ref_count
        from repro_torch.models.layers import param_count

        assert param_count(port.schema) == ref_count(ref_get_model(rcfg).schema)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_encode_and_forward_match_reference(dtype, tol):
    cfg = _cfg(dtype=dtype)
    jp, tp = bridged(cfg)
    frames, toks = _frames(cfg, 2, 24, 0), _tokens(cfg, 2, 6, 1)
    want = ref_encdec.encode(jp, jnp.asarray(frames), cfg)
    got = encdec.encode(tp, torch.from_numpy(frames), port_config(cfg))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, tol)
    want = ref_get_model(cfg).forward(jp, jnp.asarray(frames), jnp.asarray(toks))
    got = get_model(port_config(cfg)).forward(tp, torch.from_numpy(frames),
                                              torch.from_numpy(toks))
    assert tuple(got.shape) == want.shape == (2, 6, cfg.padded_vocab)
    _close(got, want, tol)


@pytest.mark.parametrize("remat", ["full", "none"])
def test_loss_and_grads_match_reference(remat):
    """fp32: the loss and every gradient (the reference's ``jax.checkpoint``
    of each block under ``full``, none under ``none``)."""
    (jl, jg), (tl, tg), metrics = _loss_and_grads(_cfg(remat_policy=remat))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_TOL)
    _assert_grads(tg, jg)
    assert sorted(metrics) == ["loss", "xent"]  # no aux term


def test_bf16_loss_and_grads_match_reference():
    (jl, jg), (tl, tg), _ = _loss_and_grads(_cfg(dtype="bfloat16"))
    np.testing.assert_allclose(tl, jl, rtol=BF16_LOSS_TOL)
    assert sorted(tg) == sorted(jg)
    for k, w in jg.items():
        g = tg[k].detach().float().numpy()
        assert np.abs(g - w).max() <= BF16_GRAD_TOL * np.abs(w).max(), k


def test_dots_remat_is_full_remat():
    """``"dots"`` rematerialises the whole block, as the reference's
    ``jax.checkpoint`` does for any policy but ``"none"``: the same loss
    and gradients, bit for bit, as ``"full"``."""
    _, (dl, dg), _ = _loss_and_grads(_cfg(remat_policy="dots"))
    _, (fl, fg), _ = _loss_and_grads(_cfg(remat_policy="full"))
    assert dl == fl
    for k in fg:
        assert torch.equal(dg[k], fg[k]), k


def test_masked_labels_match_reference():
    cfg = _cfg()
    jp, tp = bridged(cfg, 1)
    jb, tb = _batch(cfg, 3)
    labels = np.asarray(jb["labels"]).copy()
    labels[:, ::3] = -1
    jl, _ = ref_get_model(cfg).loss(jp, {**jb, "labels": jnp.asarray(labels)})
    tl, _ = get_model(port_config(cfg)).loss(tp, {**tb, "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_TOL)


def _filled_caches(cfg, jp, tp, B, cap, seed):
    """(reference cache, port cache) whose encoder memory is ``_enc_kv`` of
    each layer over ``encode`` of ``ENC_MEMORY`` seeded frames."""
    frames = _frames(cfg, B, encdec.ENC_MEMORY, seed)
    jout = ref_encdec.encode(jp, jnp.asarray(frames), cfg)
    tout = encdec.encode(tp, torch.from_numpy(frames), port_config(cfg))
    _close(tout, jout)
    from repro.serve.kvcache import init_cache as ref_init_cache
    from repro_torch.serve.kvcache import init_cache

    jcache = ref_init_cache(ref_get_model(cfg), B, cap)
    tcache = init_cache(get_model(port_config(cfg)), B, cap, "cpu")
    jk, jv, tk, tv = [], [], [], []
    for i in range(cfg.num_layers):
        jlp = jax.tree.map(lambda x: x[i], jp["dec_layers"])
        tlp = tree_map(lambda x: x[i], tp["dec_layers"])
        a, b = ref_encdec._enc_kv(jlp, jout, cfg)
        c, d = encdec._enc_kv(tlp, tout, port_config(cfg))
        jk.append(a), jv.append(b), tk.append(c), tv.append(d)
    jcache = {**jcache, "enc_k": jnp.stack(jk), "enc_v": jnp.stack(jv)}
    tcache["enc_k"].copy_(torch.stack(tk))
    tcache["enc_v"].copy_(torch.stack(tv))
    _close(tcache["enc_k"], jcache["enc_k"])
    return jcache, tcache


@pytest.mark.parametrize("memory", ["zero", "encoded"])
def test_decode_steps_match_reference(memory):
    """Five ``decode_step``s from an empty decoder cache (scalar
    ``cache_len``), cross-attending over all ``ENC_MEMORY`` entries of the
    encoder memory: zeros (as ``ServingEngine`` serves) or ``_enc_kv`` of
    encoded frames."""
    cfg = _cfg()
    jp, tp = bridged(cfg)
    api, ref = get_model(port_config(cfg)), ref_get_model(cfg)
    B, cap = 2, 8
    if memory == "zero":
        from repro.serve.kvcache import init_cache as ref_init_cache
        from repro_torch.serve.kvcache import init_cache

        jcache, tcache = ref_init_cache(ref, B, cap), init_cache(api, B, cap, "cpu")
    else:
        jcache, tcache = _filled_caches(cfg, jp, tp, B, cap, seed=5)
    feed = _tokens(cfg, B, 5, 6)
    for i in range(5):
        tok = feed[:, i:i + 1]
        want, jcache = ref.decode_step(jp, jnp.asarray(tok), jcache, jnp.int32(i))
        got, out = api.decode_step(tp, torch.from_numpy(tok), tcache, i)
        assert out is tcache  # written in place
        _close(got, want)
        for key in ("k", "v", "enc_k", "enc_v"):
            _close(tcache[key], jcache[key])


def test_serving_engine_tokens_match_reference():
    """``ServingEngine.generate``: the prompt fed through ``decode_step``
    token by token (no fused prefill), against the zero encoder memory
    ``init_cache`` makes, in both packages."""
    cfg = _cfg()
    jparams, tparams = bridged(cfg)
    prompts = _tokens(cfg, 2, 6, 11)
    want = RefServing(cfg, jparams, batch=2, capacity=16).generate(prompts, 5)
    eng = ServingEngine(port_config(cfg), tparams, batch=2, capacity=16, device="cpu")
    got = eng.generate(prompts, 5)
    np.testing.assert_array_equal(got, want)
    assert eng.api.prefill is None
    assert eng.stats.prefills == 1 and eng.stats.decode_steps == 4
    assert not eng._cache["enc_k"].any()


def test_continuous_engine_fails_at_admit_like_reference():
    """Both packages accept an encoder-decoder config (``block_type``
    ``attn_mlp``) and fail at the first ``admit``: the family has no
    ``prefill``."""
    cfg = _cfg()
    jparams, tparams = bridged(cfg)
    kw = dict(lanes=2, n_pages=4, page_tokens=4, lane_capacity=8)
    prompt = _tokens(cfg, 1, 5, 2)[0]
    ref = RefContinuous(cfg, jparams, **kw)
    port = ContinuousBatchingEngine(port_config(cfg), tparams, device="cpu", **kw)
    errors = []
    for eng in (ref, port):
        with pytest.raises(TypeError) as e:
            eng.admit(Request(rid=0, prompt=prompt, max_new_tokens=2))
        errors.append(str(e.value))
    assert errors[0] == errors[1] == "'NoneType' object is not callable"


@pytest.mark.parametrize("seed,start,seq", [(0, 0, 32), (3, 5, 16), (7, 2, 100)])
def test_host_batch_bit_identical(seed, start, seq):
    """``make_host_batch`` and ``SyntheticLMData`` give the reference's
    arrays for the same (seed, step): decoder tokens ``max(seq // 4, 8)``
    drawn first, then fp32 frames."""
    cfg = _cfg()
    ref = RefData(cfg, 2, seq, seed=seed, start_step=start)
    port = SyntheticLMData(port_config(cfg), 2, seq, seed=seed, start_step=start,
                           device="cpu")
    try:
        for i in range(2):
            want = ref._make_host_batch(start + i)
            hb = make_host_batch(port_config(cfg), 2, seq, seed, start + i)
            got = next(port)
            assert sorted(hb) == sorted(want) == ["frames", "labels", "tokens"]
            assert hb["tokens"].shape == (2, max(seq // 4, 8))
            for k, w in want.items():
                assert hb[k].dtype == w.dtype, k
                np.testing.assert_array_equal(hb[k], w, err_msg=k)
                np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
            assert got["frames"].dtype == torch.float32 and got["tokens"].dtype == torch.int64
            nxt = next(ref)
            np.testing.assert_array_equal(np.asarray(nxt["frames"]), want["frames"])
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("seq", [8, 32, 64, 4096])
def test_input_specs_and_make_batch_shapes(seq):
    """``train_input_specs``: ``max(S // 4, 16)`` decoder tokens; ``make_batch``:
    ``max(seq // 4, 8)``, frames in ``cfg.dtype``; both as the reference's."""
    cfg = get_config(ARCH)
    from repro.configs import TRAIN_4K as REF_TRAIN_4K
    from repro.configs import get_config as ref_get_config

    shape = dataclasses.replace(TRAIN_4K, seq_len=seq, global_batch=2)
    want = ref_specs(ref_get_config(ARCH), dataclasses.replace(REF_TRAIN_4K, seq_len=seq,
                                                               global_batch=2))
    got = train_input_specs(cfg, shape)
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert t.device.type == "meta" and tuple(t.shape) == want[k].shape, k
    assert got["frames"].dtype == torch.bfloat16 and got["tokens"].dtype == torch.long
    assert got["tokens"].shape[1] == max(seq // 4, 16)
    small = _cfg(dtype="bfloat16")
    want = ref_make_batch(jax.random.PRNGKey(0), small, 2, seq)
    got = make_batch(port_config(small), 2, seq, torch.Generator().manual_seed(0), "cpu")
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert tuple(t.shape) == want[k].shape, k
        assert str(t.dtype).removeprefix("torch.") == (
            "int64" if want[k].dtype == jnp.int32 else str(want[k].dtype)), k
    assert got["tokens"].shape[1] == max(seq // 4, 8)
    assert ((got["tokens"] >= 0) & (got["tokens"] < small.vocab_size)).all()


def test_three_adamw_steps_match_reference():
    """One AdamW step (every parameter and moment) and three steps of
    losses against the reference's jitted train step, on the pipeline's
    enc-dec batches."""
    _step_and_trajectory(_cfg(), steps=3)


def test_launch_train_and_serve_on_cpu(capsys):
    from repro_torch.launch import serve, train

    train.main(["--arch", ARCH, "--steps", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "done on cpu: steps=3" in out
    serve.main(["--arch", ARCH, "--device", "cpu"])
    assert "generated (4, 16) tokens on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    """fp32 statistics, ``scale`` and ``bias``, cast back to the input dtype."""
    rng = np.random.default_rng(0)
    x = (3.0 + 2.0 * rng.standard_normal((2, 5, 48))).astype(np.float32)
    scale, bias = rng.standard_normal(48).astype(np.float32), rng.standard_normal(48).astype(
        np.float32)
    want = ref_layer_norm(jnp.asarray(x).astype(dtype), jnp.asarray(scale), jnp.asarray(bias),
                          1e-5)
    got = layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(scale),
                     torch.from_numpy(bias), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, 1e-5 if dtype == "float32" else 1e-2)


def test_train_state_params_all_get_gradients():
    """Every leaf of the enc-dec tree reaches the loss (none is left out of
    the stack the port unbinds)."""
    cfg = port_config(_cfg())
    _, tp = bridged(_cfg())
    _, tb = _batch(_cfg(), 0)
    leaves = [p.requires_grad_(True) for p in tree_leaves(tp)]
    loss, _ = get_model(cfg).loss(tp, tb)
    grads = torch.autograd.grad(loss, leaves)
    assert all(bool(g.abs().sum() > 0) for g in grads)
