"""The port's attention paths against the reference on the same inputs.

``flash_attention_plain`` (the CUDA kernel's plain version, which the
wrapper takes on the CPU) is held against ``repro.kernels.ref`` and against
the Pallas kernel run in interpret mode, over the sweep of
``tests/test_kernels.py:18-34`` with its tolerances; ragged lengths and a
window whose first tile is fully masked against the reference oracle; and
the model-level paths against ``repro.models.attention``.
"""
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
    before = fa.launches
    got = port_ops.attention(tq, tk, tv, causal=True, window=8)
    assert fa.launches == before  # the counter moves only on a kernel launch
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
