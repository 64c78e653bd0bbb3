"""The port's attention paths against the reference on the same inputs.

``flash_attention_plain`` (the CUDA kernel's plain version, which the
wrapper takes on the CPU) is held against ``repro.kernels.ref`` and against
the Pallas kernel run in interpret mode, over the sweep of
``tests/test_kernels.py:18-34`` with its tolerances, and at d_head 80;
ragged lengths and a window whose first tile is fully masked against the
reference oracle; its row log-sum-exp and its autograd gradients (the
backward kernel's plain version) against ``jax.grad`` of the reference's
``full_attention``; and the model-level paths against
``repro.models.attention``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kernels
from repro.models import attention as ref_attn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels import ref as port_ref
from repro_torch.models import attention as port_attn

TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py:11


def _qkv(B, Sq, Skv, H, KV, d, seed):
    rng = np.random.default_rng(seed)
    mk = lambda s, n: rng.standard_normal((B, s, n, d)).astype(np.float32)
    return mk(Sq, H), mk(Skv, KV), mk(Skv, KV)


def _both(arrays, dtype):
    """The same values as jax and torch arrays of ``dtype`` (both round
    fp32 to bf16 to nearest even)."""
    j = [jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrays]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return j, t


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("oracle", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("window", [0, 96])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("S", [128, 256])
def test_plain_matches_reference_and_pallas(S, H, KV, dtype, window, oracle):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, S, S, H, KV, 64, S * H + KV), dtype)
    if oracle == "reference":
        want = ref_kernels.attention_reference(jq, jk, jv, causal=True, window=window)
    else:
        want = ref_ops.attention(jq, jk, jv, causal=True, window=window,
                                 force="pallas_interpret")
    got = fa.flash_attention_plain(tq, tk, tv, causal=True, window=window)
    assert got.dtype == tq.dtype
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 17, 200])
def test_plain_ragged_lengths(S, causal):
    """Lengths that are no block multiple (the Pallas kernel asserts they
    are): short last kv tile, and keys past Skv masked when non-causal."""
    for dtype in ("float32", "bfloat16"):
        (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, S, S, 4, 2, 32, S), dtype)
        want = ref_kernels.attention_reference(jq, jk, jv, causal=causal)
        _close(fa.flash_attention_plain(tq, tk, tv, causal=causal), want, TOL[dtype])
        _close(port_ref.attention_reference(tq, tk, tv, causal=causal), want, TOL[dtype])


def test_plain_window_with_fully_masked_first_tile():
    """Rows past 128 + window see no key of the first 128-key tile: their
    first tile accumulates exp(0) garbage under the finite NEG_INF, which
    the first live tile wipes (alpha = 0).  -inf would give NaN here."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 300, 300, 4, 1, 32, 9), "float32")
    want = ref_kernels.attention_reference(jq, jk, jv, causal=True, window=16)
    assert fa.BLOCK_K == 128
    got = fa.flash_attention_plain(tq, tk, tv, causal=True, window=16)
    assert torch.isfinite(got).all()
    _close(got, want, TOL["float32"])


def test_ops_attention_on_cpu_takes_plain_path_without_launch():
    (_, _, _), (tq, tk, tv) = _both(_qkv(1, 40, 40, 4, 2, 32, 1), "float32")
    before = dict(fa.launches)
    got = port_ops.attention(tq, tk, tv, causal=True, window=8)
    assert fa.launches == before  # the counters move only on a kernel launch
    torch.testing.assert_close(
        got, fa.flash_attention_plain(tq, tk, tv, causal=True, window=8))


def test_wrapper_rejects_what_the_kernel_cannot_take():
    (_, _, _), (tq, tk, tv) = _both(_qkv(1, 8, 8, 4, 2, 32, 2), "float32")
    with pytest.raises(NotImplementedError, match="softcap"):
        fa.flash_attention(tq, tk, tv, softcap=30.0)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(tq[:, :, :3], tk, tv)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention(tq, tk[..., :16], tv)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(tq, tk.double(), tv)


@pytest.mark.parametrize("oracle", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV,window", [(4, 4, 0), (4, 2, 96)])
def test_plain_head_dim_80(H, KV, window, dtype, oracle):
    """zamba2's shared attention has d_head 80 (five k16 slices)."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 128, 128, H, KV, 80, H + KV + window), dtype)
    if oracle == "reference":
        want = ref_kernels.attention_reference(jq, jk, jv, causal=True, window=window)
    else:
        want = ref_ops.attention(jq, jk, jv, causal=True, window=window,
                                 force="pallas_interpret")
    _close(fa.flash_attention_plain(tq, tk, tv, causal=True, window=window), want, TOL[dtype])


@pytest.mark.parametrize("causal,window,S", [(True, 0, 40), (True, 16, 150), (False, 0, 33)])
def test_plain_lse(causal, window, S):
    """The row log-sum-exp the forward kernel writes for the backward."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, S, S, 4, 2, 80, S), "float32")
    _, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                      return_lse=True)
    kr = jnp.repeat(jk, 2, axis=2)
    s = jnp.einsum("bshd,bthd->bhst", jq, kr) / np.sqrt(80.0)
    pos = jnp.arange(S)
    ok = jnp.ones((S, S), bool)
    if causal:
        ok &= pos[None, :] <= pos[:, None]
    if window:
        ok &= pos[None, :] > pos[:, None] - window
    want = jax.nn.logsumexp(jnp.where(ok, s, -1e30), axis=-1)
    assert lse.shape == (2, 4, S) and lse.dtype == torch.float32
    _close(lse, want, 1e-5)


GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV,d,causal,window,S", [
    (4, 4, 80, True, 0, 64), (4, 2, 64, True, 24, 100), (8, 1, 32, True, 0, 37),
    (4, 2, 80, False, 0, 50), (2, 2, 128, True, 7, 20)])
def test_plain_gradients_match_jax_grad(H, KV, d, causal, window, S, dtype):
    """dq, dk, dv of <o, P> through ``flash_attention_plain`` (the backward
    kernel's plain version) against ``jax.grad`` of the reference's
    ``full_attention``: causal, window, GQA, ragged S, fp32 and bf16.  fp32
    to 1e-4; bf16 to 3e-2 of each gradient's largest magnitude (both
    round the bf16 inputs alike, then the output and the gradients to bf16
    at different points)."""
    arrs = _qkv(2, S, S, H, KV, d, H * d + S)
    proj = np.random.default_rng(1).standard_normal((2, S, H, d)).astype(np.float32)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, dtype)
    jproj = jnp.asarray(proj).astype(jnp.dtype(dtype))

    def jloss(q, k, v):
        o = ref_attn.full_attention(q, k, v, causal=causal, window=window)
        return jnp.sum((o * jproj).astype(jnp.float32))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    o = fa.flash_attention_plain(*leaves, causal=causal, window=window)
    got = torch.autograd.grad((o * torch.from_numpy(proj).to(o.dtype)).float().sum(), leaves)
    for g, w in zip(got, want):
        assert g.dtype == tq.dtype
        w = np.asarray(w.astype(jnp.float32))
        if dtype == "bfloat16":
            atol, rtol = GRAD_TOL[dtype] * float(np.abs(w).max()), 0.0
        else:
            atol = rtol = GRAD_TOL[dtype]
        np.testing.assert_allclose(g.float().numpy(), w, atol=atol, rtol=rtol)


def test_cpu_output_carries_autograd():
    """The wrapper never hands back a detached output: on the CPU autograd
    runs through the plain version (on the card through the kernels'
    ``FlashAttentionFunction``)."""
    (_, _, _), (tq, tk, tv) = _both(_qkv(1, 12, 12, 4, 2, 80, 3), "float32")
    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    o = port_ops.attention(*leaves, causal=True)
    assert o.grad_fn is not None
    assert all(g is not None and g.abs().sum() > 0
               for g in torch.autograd.grad(o.square().sum(), leaves))


# ---------------------------------------------------------------------------
# model-level paths vs repro.models.attention (fp32)
# ---------------------------------------------------------------------------

MODEL_TOL = 1e-5


@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (True, 5, 0.0), (True, 0, 30.0), (False, 0, 0.0)])
def test_full_attention(causal, window, softcap):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 13, 13, 4, 2, 32, 3), "float32")
    want = ref_attn.full_attention(jq, jk, jv, causal=causal, window=window,
                                   softcap=softcap)
    got = port_attn.full_attention(tq, tk, tv, causal=causal, window=window,
                                   softcap=softcap)
    _close(got, want, MODEL_TOL)


@pytest.mark.parametrize("window", [0, 100])
def test_blocked_attention(window):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 512, 512, 4, 1, 32, 4), "float32")
    want = ref_attn.blocked_attention(jq, jk, jv, window=window, block_q=128)
    got = port_attn.blocked_attention(tq, tk, tv, window=window, block_q=128)
    _close(got, want, MODEL_TOL)
    # attend on the CPU picks the same path as the reference's attend
    _close(port_attn.attend(tq, tk, tv, window=window, block_q=128, min_blocked_len=256),
           ref_attn.attend(jq, jk, jv, window=window, block_q=128, min_blocked_len=256),
           MODEL_TOL)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (6, 0.0), (0, 30.0)])
def test_decode_attention(per_row, window, softcap):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(3, 1, 24, 8, 2, 32, 5), "float32")
    lens = np.array([24, 7, 15], np.int32) if per_row else np.int32(11)
    want = ref_attn.decode_attention(jq, jk, jv, jnp.asarray(lens), window=window,
                                     softcap=softcap)
    got = port_attn.decode_attention(tq, tk, tv, torch.as_tensor(lens), window=window,
                                     softcap=softcap)
    _close(got, want, MODEL_TOL)
