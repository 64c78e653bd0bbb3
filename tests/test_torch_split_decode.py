"""Split-KV decoding (``dist/fsdp.py``'s rule) emulated in one process.

The cache is cut along its sequence into 1-8 slices.  Each slice goes
through ``decode_attention_partial`` with its offset, as a rank calls it,
and the partials are merged by ``merge_partials`` with the all-reduces
replaced by reductions over the stacked slices.  The result is held against
the port's ``decode_attention`` over the whole cache and against the
reference's (``repro.models.attention.decode_attention``), to 1e-5 of the
largest magnitude in fp32 and to one bf16 ulp of it in bf16 (both sides
reduce in fp32 and round once).  The owner-rank write (``cache_write``) on
the slices equals the write into the whole cache.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro_torch.models import attention as port_attn

B, SKV, HD = 3, 48, 16
FP32_TOL = 1e-5
HEADS = {"mha": (4, 4), "gqa": (8, 2)}


def _inputs(H, KV, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, HD)).astype(np.float32)
    k = rng.standard_normal((B, SKV, KV, HD)).astype(np.float32)
    v = rng.standard_normal((B, SKV, KV, HD)).astype(np.float32)
    return q, k, v


def split_decode(q, k, v, cache_len, n_slices, window, softcap):
    """The split form over ``n_slices`` slices of the cache, merged over
    the stacked slices as the ranks merge over their axes."""
    S = k.shape[1] // n_slices
    parts = [port_attn.decode_attention_partial(q, k[:, i * S:(i + 1) * S],
                                                v[:, i * S:(i + 1) * S], cache_len, i * S,
                                                window=window, softcap=softcap)
             for i in range(n_slices)]
    out = torch.stack([o for o, _ in parts])
    lse = torch.stack([m for _, m in parts])
    merged = port_attn.merge_partials(out, lse, lambda x: x.amax(0, keepdim=True),
                                      lambda x: x.sum(0))
    return merged.to(q.dtype)


def _lengths(n_slices, per_row):
    """Cache lengths at every slice boundary (the last position of a slice,
    the first of the next) and the whole cache."""
    S = SKV // n_slices
    ends = sorted({1, SKV} | {b for i in range(1, n_slices + 1) for b in (i * S, i * S + 1)
                              if b <= SKV})
    if not per_row:
        return [np.int32(n) for n in ends]
    return [np.array([ends[i % len(ends)], ends[(i + 1) % len(ends)], ends[(i + 2) % len(ends)]],
                     np.int32) for i in range(len(ends))]


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (0, 5.0), (7, 0.0), (20, 5.0)])
@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("n_slices", [1, 2, 3, 8])
def test_split_decode_matches_whole_cache(n_slices, heads, window, softcap, per_row):
    """fp32: the merged split form equals ``decode_attention`` over the whole
    cache and the reference's, at every slice boundary; a window of 7 or 20
    over 48 positions in 8 slices of 6 masks whole slices, whose weight
    must be 0 (a NaN or a leak fails)."""
    H, KV = HEADS[heads]
    q, k, v = _inputs(H, KV, seed=n_slices * 31 + H + window)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for lens in _lengths(n_slices, per_row):
        n = torch.as_tensor(lens)
        got = split_decode(tq, tk, tv, n, n_slices, window, softcap)
        whole = port_attn.decode_attention(tq, tk, tv, n, window=window, softcap=softcap)
        want = np.asarray(ref_attn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                                    jnp.asarray(v), jnp.asarray(lens),
                                                    window=window, softcap=softcap))
        assert torch.isfinite(got).all()
        tol = FP32_TOL * np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0, atol=tol,
                                   err_msg=str(lens))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol, err_msg=str(lens))


@pytest.mark.parametrize("window", [0, 20])
@pytest.mark.parametrize("n_slices", [2, 8])
def test_split_decode_bf16_within_one_ulp(n_slices, window):
    """bf16 inputs: both forms compute in fp32 and round once, so they agree
    to one bf16 ulp of the largest magnitude."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _inputs(8, 2, seed=7 + n_slices))
    for lens in _lengths(n_slices, per_row=False):
        n = torch.as_tensor(lens)
        got = split_decode(q, k, v, n, n_slices, window, 0.0).float()
        want = port_attn.decode_attention(q, k, v, n, window=window).float()
        top = want.abs().max().item()
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
        assert (got - want).abs().max().item() <= ulp, lens


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("n_slices", [1, 2, 3, 8])
def test_cache_write_on_slices_equals_the_whole_write(n_slices, per_row):
    """Only the slice holding position ``n`` changes, at ``n - offset``;
    every other slice keeps its entries, whatever lane is written where."""
    rng = np.random.default_rng(n_slices)
    cache = torch.from_numpy(rng.standard_normal((B, SKV, 2, HD)).astype(np.float32))
    new = torch.from_numpy(rng.standard_normal((B, 1, 2, HD)).astype(np.float32))
    S = SKV // n_slices
    for lens in _lengths(n_slices, per_row):
        n = torch.as_tensor(lens).long() - 1  # the position the new token takes
        whole = cache.clone()
        port_attn.cache_write(whole, new, n)
        slices = [cache[:, i * S:(i + 1) * S].clone() for i in range(n_slices)]
        for i, sl in enumerate(slices):
            port_attn.cache_write(sl, new, n, i * S)
        assert torch.equal(torch.cat(slices, dim=1), whole), lens
        rows = torch.arange(B)
        assert torch.equal(whole[rows, n.expand(B)], new[:, 0])
