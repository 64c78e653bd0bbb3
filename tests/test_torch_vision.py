"""pixtral-12b's vision prefix in the port against
``repro.models.transformer``, on the CPU.

Reduced pixtral (2 layers, d_model 128, 4 query heads over 1 KV head of
32) on bridged weights, the reference called outside any
``fsdp.context``: the schema with ``frontend_proj``, ``forward`` with
``patch_embeds=``, the loss over text positions only with every gradient
against ``jax.value_and_grad(api.loss)``, ``prefill`` with patches and
then decode steps, ``ServingEngine.generate`` (the fused prefill without
patches, as the reference's engine runs it), the host batches bit for
bit, both length rules of the batch builders, three AdamW steps, and the
train and serve CLIs.

Tolerances as ``tests/test_torch_encdec.py``: fp32 at 1e-4 on logits
and caches, losses at 1e-5 relative, gradients at 1e-5 relative plus
1e-5 of each leaf's largest; in bf16, where the two frameworks round at
different points, logits at 5e-2 absolute, the loss at 1e-2 relative,
gradients at 5e-2 of each leaf's largest.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.data.pipeline import SyntheticLMData as RefData
from repro.models import get_model as ref_get_model
from repro.models import transformer as ref_transformer
from repro.models.api import make_batch as ref_make_batch
from repro.models.api import train_input_specs as ref_specs
from repro.serve.engine import ServingEngine as RefServing
from repro_torch.checkpoint import ckpt
from repro_torch.configs import TRAIN_4K, get_config
from repro_torch.data.pipeline import SyntheticLMData, make_host_batch
from repro_torch.models import get_model, transformer
from repro_torch.models.api import make_batch, train_input_specs
from repro_torch.models.layers import softmax_xent
from repro_torch.serve.engine import ServingEngine
from repro_torch.train.step import make_forward
from test_torch_bridge import bridged, port_config, small_config
from test_torch_train import _batch, _step_and_trajectory
from test_torch_transformer_train import _assert_grads, _loss_and_grads

ARCH = "pixtral-12b"
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


def _patches(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S), dtype=np.int32)


@pytest.mark.parametrize("full", [False, True])
def test_schema_matches_reference(full):
    from repro.configs import get_config as ref_get_config

    rcfg = ref_get_config(ARCH) if full else _cfg()
    schema = get_model(port_config(rcfg)).schema
    want = ref_ckpt._flatten(ref_get_model(rcfg).schema)
    got = ckpt.flatten(schema)
    assert sorted(got) == sorted(want) and "frontend_proj" in got
    for k, w in want.items():
        assert (got[k].shape, got[k].axes, got[k].init) == (w.shape, w.axes, w.init), k
    assert transformer.VISION_PREFIX == ref_transformer.VISION_PREFIX


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_forward_with_patches_matches_reference(dtype, tol):
    """Patches projected and prepended; positions over patches and text;
    and without patches the plain text forward."""
    cfg = _cfg(dtype=dtype)
    jp, tp = bridged(cfg)
    ref, port = ref_get_model(cfg), get_model(port_config(cfg))
    pe, toks = _patches(cfg, 2, 5, 0), _tokens(cfg, 2, 7, 1)
    want = ref.forward(jp, jnp.asarray(toks), patch_embeds=jnp.asarray(pe))
    got = port.forward(tp, torch.from_numpy(toks), patch_embeds=torch.from_numpy(pe))
    assert tuple(got.shape) == want.shape == (2, 12, cfg.padded_vocab)
    _close(got, want, tol)
    fwd = make_forward(port)(tp, {"tokens": torch.from_numpy(toks),
                                  "patch_embeds": torch.from_numpy(pe)})
    assert torch.equal(fwd, got)
    _close(port.forward(tp, torch.from_numpy(toks)), ref.forward(jp, jnp.asarray(toks)), tol)


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_loss_and_grads_match_reference(remat):
    """fp32, on the pipeline's vision batch (8 patches, 24 text tokens)."""
    (jl, jg), (tl, tg), metrics = _loss_and_grads(_cfg(remat_policy=remat))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_TOL)
    _assert_grads(tg, jg)
    assert float(metrics["moe_aux"]) == 0.0


def test_bf16_loss_and_grads_match_reference():
    (jl, jg), (tl, tg), _ = _loss_and_grads(_cfg(dtype="bfloat16"))
    np.testing.assert_allclose(tl, jl, rtol=BF16_LOSS_TOL)
    assert sorted(tg) == sorted(jg)
    for k, w in jg.items():
        g = tg[k].detach().float().numpy()
        assert np.abs(g - w).max() <= BF16_GRAD_TOL * np.abs(w).max(), k


def test_loss_is_over_text_positions_only():
    """The loss is the cross-entropy of the text positions' logits of the
    full forward: the patch positions are dropped before the unembedding."""
    cfg = _cfg()
    _, tp = bridged(cfg)
    _, tb = _batch(cfg, 1)
    api = get_model(port_config(cfg))
    S_img = tb["patch_embeds"].shape[1]
    loss, _ = api.loss(tp, tb)
    logits = api.forward(tp, tb["tokens"], patch_embeds=tb["patch_embeds"])
    assert logits.shape[1] == S_img + tb["tokens"].shape[1]
    want = softmax_xent(logits[:, S_img:], tb["labels"])
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=0)


def test_prefill_with_patches_then_decode_steps():
    """``prefill(..., patch_embeds=)``: the last logits and a cache of the
    S_img + S_txt positions, then three decode steps, as the reference's."""
    cfg = _cfg()
    jp, tp = bridged(cfg)
    ref, port = ref_get_model(cfg), get_model(port_config(cfg))
    pe, toks = _patches(cfg, 2, 6, 2), _tokens(cfg, 2, 5, 3)
    want, jcache = ref.prefill(jp, jnp.asarray(toks), 16, patch_embeds=jnp.asarray(pe))
    got, tcache = port.prefill(tp, torch.from_numpy(toks), 16,
                               patch_embeds=torch.from_numpy(pe))
    _close(got, want)
    full = port.forward(tp, torch.from_numpy(toks), patch_embeds=torch.from_numpy(pe))
    _close(got, full[:, -1].detach().numpy())
    for key in ("k", "v"):
        assert tuple(tcache[key].shape) == jcache[key].shape
        _close(tcache[key], jcache[key])
        assert not tcache[key][:, :, 11:].any()  # 6 patches + 5 tokens filled
    feed = _tokens(cfg, 2, 3, 4)
    for i in range(3):
        tok = feed[:, i:i + 1]
        want, jcache = ref.decode_step(jp, jnp.asarray(tok), jcache, jnp.int32(11 + i))
        got, tcache = port.decode_step(tp, torch.from_numpy(tok), tcache, 11 + i)
        _close(got, want)
        for key in ("k", "v"):
            _close(tcache[key], jcache[key])


def test_serving_engine_tokens_match_reference():
    """The engines run the fused prefill without patches, in both packages."""
    cfg = _cfg()
    jparams, tparams = bridged(cfg)
    prompts = _tokens(cfg, 2, 7, 11)
    want = RefServing(cfg, jparams, batch=2, capacity=16).generate(prompts, 5)
    eng = ServingEngine(port_config(cfg), tparams, batch=2, capacity=16, device="cpu")
    np.testing.assert_array_equal(eng.generate(prompts, 5), want)
    assert eng.api.prefill is not None and eng.stats.decode_steps == 4


@pytest.mark.parametrize("seed,start,seq", [(0, 0, 32), (3, 5, 12), (7, 2, 100)])
def test_host_batch_bit_identical(seed, start, seq):
    """Text tokens (``seq - max(seq // 4, 4)``) drawn first, then fp32
    patches (``max(seq // 4, 4)``), bit for bit the reference's."""
    cfg = _cfg()
    ref = RefData(cfg, 2, seq, seed=seed, start_step=start)
    port = SyntheticLMData(port_config(cfg), 2, seq, seed=seed, start_step=start,
                           device="cpu")
    try:
        for i in range(2):
            want = ref._make_host_batch(start + i)
            hb = make_host_batch(port_config(cfg), 2, seq, seed, start + i)
            got = next(port)
            assert sorted(hb) == sorted(want) == ["labels", "patch_embeds", "tokens"]
            si = max(seq // 4, 4)
            assert hb["patch_embeds"].shape == (2, si, cfg.d_model)
            assert hb["tokens"].shape == (2, seq - si)
            for k, w in want.items():
                assert hb[k].dtype == w.dtype, k
                np.testing.assert_array_equal(hb[k], w, err_msg=k)
                np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
            assert got["patch_embeds"].dtype == torch.float32
            assert got["tokens"].dtype == torch.int64
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("seq", [12, 32, 64, 8192])
def test_input_specs_and_make_batch_shapes(seq):
    """``train_input_specs``: ``min(VISION_PREFIX, S // 4)`` patch positions;
    ``make_batch``: ``max(seq // 4, 4)``; patches in ``cfg.dtype``."""
    from repro.configs import TRAIN_4K as REF_TRAIN_4K
    from repro.configs import get_config as ref_get_config

    shape = dataclasses.replace(TRAIN_4K, seq_len=seq, global_batch=2)
    want = ref_specs(ref_get_config(ARCH), dataclasses.replace(REF_TRAIN_4K, seq_len=seq,
                                                               global_batch=2))
    got = train_input_specs(get_config(ARCH), shape)
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert t.device.type == "meta" and tuple(t.shape) == want[k].shape, k
    assert got["patch_embeds"].shape[1] == min(transformer.VISION_PREFIX, seq // 4)
    assert got["patch_embeds"].dtype == torch.bfloat16 and got["labels"].dtype == torch.long
    small = _cfg(dtype="bfloat16")
    if seq > 4096:
        return  # make_batch draws real arrays: smoke scale only
    want = ref_make_batch(jax.random.PRNGKey(0), small, 2, seq)
    got = make_batch(port_config(small), 2, seq, torch.Generator().manual_seed(0), "cpu")
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert tuple(t.shape) == want[k].shape, k
    assert got["patch_embeds"].shape[1] == max(seq // 4, 4)
    assert got["patch_embeds"].dtype == torch.bfloat16


def test_three_adamw_steps_match_reference():
    _step_and_trajectory(_cfg(), steps=3)


def test_launch_train_and_serve_on_cpu(capsys):
    from repro_torch.launch import serve, train

    train.main(["--arch", ARCH, "--steps", "3", "--device", "cpu"])
    assert "done on cpu: steps=3" in capsys.readouterr().out
    serve.main(["--arch", ARCH, "--device", "cpu"])
    assert "generated (4, 16) tokens on cpu" in capsys.readouterr().out
