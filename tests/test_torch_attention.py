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
import functools

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
@pytest.mark.parametrize("S", [1, 17, 200, 129])
def test_plain_ragged_lengths(S, causal):
    """Lengths that are no block multiple (the Pallas kernel asserts they
    are): short last kv tile, and keys past Skv masked when non-causal.
    129 is one past the kernels' 128-row and 128-key tiles."""
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
    with pytest.raises(ValueError, match="softcap"):  # a cap is > 0, or 0 for none
        fa.flash_attention(tq, tk, tv, softcap=-1.0)
    torch.testing.assert_close(fa.flash_attention(tq, tk, tv, softcap=30.0),
                               fa.flash_attention_plain(tq, tk, tv, softcap=30.0))
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


@pytest.mark.parametrize("causal,window,S", [(True, 0, 40), (True, 16, 150), (False, 0, 33),
                                             (True, 0, 129), (False, 0, 129), (True, 96, 257)])
def test_plain_lse(causal, window, S):
    """The row log-sum-exp the forward kernel writes for the backward (d 80;
    129 and 257 are one past the kernels' tiles)."""
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
    (4, 2, 80, False, 0, 50), (2, 2, 128, True, 7, 20), (4, 2, 80, True, 96, 129),
    (4, 4, 64, False, 0, 129)])
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


# softcap: the reference's models/attention paths are the oracle (the Pallas
# kernel has none)
@pytest.mark.parametrize("oracle", ["full", "blocked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV,causal,window,cap", [
    (4, 4, True, 0, 30.0), (4, 2, True, 96, 30.0), (8, 1, True, 0, 5.0),
    (4, 2, False, 0, 5.0), (6, 2, True, 40, 2.0)])
def test_plain_softcap_matches_reference(H, KV, causal, window, cap, dtype, oracle):
    """``flash_attention_plain(softcap=...)`` against the reference's
    ``full_attention`` and ``blocked_attention`` with the same cap:
    causal, window, GQA, non-causal; S = 256 spans two kv tiles."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 256, 256, H, KV, 64, H + KV), dtype)
    jq, tq = jq * 3, tq * 3  # scores of a few units: the cap bends them
    if oracle == "full":
        ref = functools.partial(ref_attn.full_attention, causal=causal, window=window,
                                softcap=cap)
    else:
        ref = functools.partial(ref_attn.blocked_attention, causal=causal, window=window,
                                softcap=cap, block_q=128)
    want = jax.jit(ref)(jq, jk, jv)
    got = fa.flash_attention_plain(tq, tk, tv, causal=causal, window=window, softcap=cap)
    assert got.dtype == tq.dtype
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV,d,causal,window,S,cap", [
    (4, 2, 64, True, 0, 64, 30.0), (8, 1, 32, True, 24, 100, 5.0),
    (4, 4, 80, False, 0, 50, 5.0), (2, 2, 128, True, 0, 129, 30.0)])
def test_plain_softcap_gradients_match_jax_grad(H, KV, d, causal, window, S, cap, dtype):
    """dq, dk, dv through the capped ``flash_attention_plain`` (the capped
    backward kernels' plain version) against ``jax.grad`` of the
    reference's ``full_attention`` with the same cap, at ``GRAD_TOL``."""
    arrs = _qkv(2, S, S, H, KV, d, H * d + S + 1)
    arrs = (3 * arrs[0],) + arrs[1:]
    proj = np.random.default_rng(3).standard_normal((2, S, H, d)).astype(np.float32)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, dtype)
    jproj = jnp.asarray(proj).astype(jnp.dtype(dtype))

    def jloss(q, k, v):
        o = ref_attn.full_attention(q, k, v, causal=causal, window=window, softcap=cap)
        return jnp.sum((o * jproj).astype(jnp.float32))

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jq, jk, jv)
    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    o = fa.flash_attention_plain(*leaves, causal=causal, window=window, softcap=cap)
    got = torch.autograd.grad((o * torch.from_numpy(proj).to(o.dtype)).float().sum(), leaves)
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        if dtype == "bfloat16":
            atol, rtol = GRAD_TOL[dtype] * float(np.abs(w).max()), 0.0
        else:
            atol = rtol = GRAD_TOL[dtype]
        np.testing.assert_allclose(g.float().numpy(), w, atol=atol, rtol=rtol)


def test_softcap_masks_after_the_cap():
    """A small cap, where masking first would leak: tanh of the mask value
    is -cap, so a key masked before the cap would keep a weight of
    exp(-cap - m).  Row 0 of causal attention sees key 0 alone, so its
    output is v[0]; the window's rows see only their window.  The plain
    version and its LSE against the reference's ``full_attention``."""
    cap = 0.5
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 40, 40, 4, 2, 32, 7), "float32")
    out, lse = fa.flash_attention_plain(tq, tk, tv, causal=True, softcap=cap,
                                        return_lse=True)
    torch.testing.assert_close(out[:, 0], tv[:, 0].repeat_interleave(2, dim=1))
    ref = jax.jit(ref_attn.full_attention, static_argnames=("causal", "window", "softcap"))
    _close(out, ref(jq, jk, jv, causal=True, softcap=cap), TOL["float32"])
    # the row LSE is that of the capped scores: row 0 has one live key
    s0 = cap * torch.tanh((tq[:, 0] * tk[:, 0].repeat_interleave(2, dim=1)).sum(-1)
                          / np.sqrt(32) / cap)
    torch.testing.assert_close(lse[:, :, 0], s0)
    win = fa.flash_attention_plain(tq, tk, tv, causal=True, window=3, softcap=cap)
    _close(win, ref(jq, jk, jv, causal=True, window=3, softcap=cap), TOL["float32"])
    leak = fa.flash_attention_plain(tq, tk, tv, causal=False, softcap=cap)
    assert not torch.allclose(leak[:, 0], out[:, 0], atol=1e-3)


def _jax_lse(jq, jk, causal, window):
    """Rows' log-sum-exp of the scaled, masked scores, by jax."""
    G = jq.shape[2] // jk.shape[2]
    s = jnp.einsum("bshd,bthd->bhst", jq, jnp.repeat(jk, G, axis=2)) / np.sqrt(jq.shape[3])
    q_pos, k_pos = jnp.arange(jq.shape[1])[:, None], jnp.arange(jk.shape[1])[None, :]
    ok = jnp.ones((jq.shape[1], jk.shape[1]), bool)
    if causal:
        ok &= k_pos <= q_pos
    if window:
        ok &= k_pos > q_pos - window
    return jax.nn.logsumexp(jnp.where(ok, s, -1e30), axis=-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv,d", [(100, 300, 80), (300, 100, 64), (129, 1, 32),
                                      (1, 257, 128)])
def test_plain_cross_lengths(Sq, Skv, d, dtype):
    """Non-causal attention with Sq != Skv (cross-attention lengths, ragged
    against the kernels' tiles): output and LSE against the reference
    oracle, gradients against ``jax.grad`` of ``full_attention``, at the
    tolerances above."""
    q, k, v = _qkv(2, Sq, Skv, 8, 2, d, Sq + Skv + d)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    got, lse = fa.flash_attention_plain(tq, tk, tv, causal=False, return_lse=True)
    _close(got, ref_kernels.attention_reference(jq, jk, jv, causal=False), TOL[dtype])
    (fq, fk, _), _ = _both((q, k, v), "float32")
    _, lse32 = fa.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                        causal=False, return_lse=True)
    _close(lse32, _jax_lse(fq, fk, False, 0), 1e-5)
    assert lse.shape == (2, 8, Sq) and bool(torch.isfinite(lse).all())

    proj = np.random.default_rng(2).standard_normal((2, Sq, 8, d)).astype(np.float32)
    jproj = jnp.asarray(proj).astype(jnp.dtype(dtype))
    want = jax.grad(lambda a, b, c: jnp.sum(
        (ref_attn.full_attention(a, b, c, causal=False) * jproj).astype(jnp.float32)),
        argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    o = fa.flash_attention_plain(*leaves, causal=False)
    grads = torch.autograd.grad((o * torch.from_numpy(proj).to(o.dtype)).float().sum(), leaves)
    for g, w in zip(grads, want):
        w = np.asarray(w.astype(jnp.float32))
        if dtype == "bfloat16":
            atol, rtol = GRAD_TOL[dtype] * float(np.abs(w).max()), 0.0
        else:
            atol = rtol = GRAD_TOL[dtype]
        np.testing.assert_allclose(g.float().numpy(), w, atol=atol, rtol=rtol)


def _misaligned(shape):
    """A contiguous bf16 tensor whose data starts 2 bytes past its storage."""
    n = int(np.prod(shape))
    t = torch.zeros(n + 8, dtype=torch.bfloat16)[1:n + 1].view(shape)
    assert t.is_contiguous() and t.data_ptr() % 16 == 2
    return t


@pytest.mark.parametrize("case", ["dtype", "head_dim", "noncontiguous", "misaligned",
                                  "grid", "accepted_bf16", "accepted_fp32"])
def test_check_kernel_refuses_what_the_kernels_cannot_take(case):
    """``_check_kernel`` (a pure function of the layouts, so it runs on CPU
    tensors) raises on every layout the CUDA kernels refuse (no fallback):
    a dtype other than fp32/bf16, d outside {32, 64, 80, 128}, a
    non-contiguous or not 16-byte-aligned tensor (TMA's bases and strides),
    and more than 65535 (b, head) pairs in the grid."""
    bf = torch.bfloat16
    mk = lambda B, S, n, d, dt=bf: torch.zeros((B, S, n, d), dtype=dt)
    q, k, v = mk(1, 8, 4, 80), mk(1, 8, 2, 80), mk(1, 8, 2, 80)
    if case == "accepted_bf16":
        fa._check_kernel(q, k, v)
        return
    if case == "accepted_fp32":
        fa._check_kernel(*(t.float() for t in (q, k, v)))
        return
    if case == "dtype":
        err, args = TypeError, [t.half() for t in (q, k, v)]
    elif case == "head_dim":
        err, args = ValueError, [mk(1, 8, 4, 96), mk(1, 8, 2, 96), mk(1, 8, 2, 96)]
    elif case == "noncontiguous":
        err, args = ValueError, [mk(1, 4, 8, 80).transpose(1, 2), k, v]
    elif case == "misaligned":
        err, args = ValueError, [q, k, _misaligned((1, 8, 2, 80))]
    else:
        err, args = ValueError, [mk(1, 1, 65536, 32), mk(1, 1, 1, 32), mk(1, 1, 1, 32)]
    with pytest.raises(err):
        fa._check_kernel(*args)


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
