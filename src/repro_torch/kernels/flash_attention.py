"""Flash attention: the hand-written CUDA kernels (forward and backward)
and their plain version.

Replaces ``repro/kernels/flash_attention.py::_flash_kernel`` (the Pallas
TPU kernel).  The kernel, ``csrc/flash_attention.cu``, computes blocked
online-softmax attention over q ``(B, Sq, H, d)`` and k/v ``(B, Skv, KV, d)``:
causal or not, optional sliding window (``k > q - window``), GQA by
indexing (query head h reads kv head ``h // (H // KV)``), fp32 m/l
statistics and accumulator, the finite ``NEG_INF`` and the ``l == 0 -> 1``
guard.  Any ``Sq, Skv >= 1`` works; the Pallas block-multiple assert does
not carry over.  An optional logit softcap (grok-1's 30.0; the Pallas
kernel has none, the reference's ``models/attention.py`` applies it)
replaces each scaled score ``s = (q / sqrt(d)) . k`` by
``cap * tanh(s / cap)`` before the causal/window mask: a compile-time
branch of each kernel, so the kernels without a cap are unchanged.

On an H100 the kernels are bound by tensor-core FLOPs (989 TFLOP/s bf16)
at prefill and training shapes.  bf16 runs every product on ``wgmma``
with tiles brought into swizzled shared memory by TMA from a producer
warpgroup, S/P/m/l and the accumulators in registers; fp32 runs on plain
FMAs (see the header of the ``.cu`` source for the design).

The backward (the TPU kernel has none) recomputes ``P = exp(S - LSE)``
from the row log-sum-exp the forward writes (of the capped scores, with a
cap, and then ``dS = P (dP - rowsum(dO O)) (1 - tanh^2(s / cap))``), and
gives dq, dk and dv
(summed over each GQA group in a fixed order, so bit-identical from run
to run); autograd through ``flash_attention_plain`` is its plain
version.

Each C entry is a registered operator, ``repro_torch::flash_attention_fwd``
and ``repro_torch::flash_attention_bwd``: the real implementation (CUDA
tensors) checks the pointers the kernels read and launches; a fake one
(fake and meta tensors: ``launch/dryrun.py``) returns empty outputs of the
right shapes; a FLOP formula (``flops_fwd``, ``flops_bwd``, the operation
count of ``PERF.md``'s bound column) serves ``torch.utils.flop_counter``.

``flash_attention`` is the wrapper: a CUDA tensor launches the kernels (or
the wrapper raises) through ``FlashAttentionFunction`` whenever an input
needs a gradient, so the output always carries autograd; a meta or fake
tensor takes the same operators' fake implementation; a CPU tensor takes
``flash_attention_plain``.  ``launches`` counts kernel launches per
direction and nothing else.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import _library

NEG_INF = -1.0e30
HEAD_DIMS = (32, 64, 80, 128)
BLOCK_K = 128  # the plain version's kv tile: the Pallas kernel's block
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535  # the kernels' grid is (tiles, B x heads)

launches = {"fwd": 0, "bwd": 0}  # kernel launches through ``flash_attention``


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0, return_lse: bool = False):
    """The kernel's algorithm in plain PyTorch: kv tiles of ``BLOCK_K``
    folded into fp32 running max/sum/accumulator, masked with the finite
    ``NEG_INF``, ``l == 0 -> 1`` at the end.  Ragged ``Skv`` is a short
    last tile.  ``softcap > 0`` caps each scaled score to
    ``softcap * tanh(s / softcap)`` before the mask.  With ``return_lse``
    also the rows' log-sum-exp of the (capped) scaled scores, fp32
    ``(B, H, Sq)`` (+inf where a row saw no key), as the kernel writes it
    for the backward."""
    B, Sq, H, d = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    f32 = torch.float32
    qg = q.to(f32).reshape(B, Sq, KV, G, d) * (1.0 / math.sqrt(d))
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=f32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, d), dtype=f32, device=q.device)
    for k0 in range(0, Skv, BLOCK_K):
        kt = k[:, k0:k0 + BLOCK_K].to(f32)
        vt = v[:, k0:k0 + BLOCK_K].to(f32)
        s = torch.einsum("bsngh,btnh->bngst", qg, kt)
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        k_pos = torch.arange(k0, k0 + kt.shape[1], device=q.device)[None, :]
        ok = torch.ones((Sq, kt.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            ok &= k_pos <= q_pos
        if window > 0:
            ok &= k_pos > q_pos - window
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bngst,btnh->bngsh", p, vt)
        m = m_new
    seen = l != 0.0
    l = torch.where(seen, l, torch.ones_like(l))
    out = acc / l[..., None]  # (B, KV, G, Sq, d)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, d).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(seen, m + torch.log(l), torch.full_like(l, float("inf")))
    return out, lse.reshape(B, H, Sq)


def _check(q, k, v, causal, window, softcap) -> None:
    if not softcap >= 0:
        raise ValueError(f"softcap must be >= 0 (0: none), got {softcap}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, heads, d)")
    B, Sq, H, d = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if H % k.shape[2] != 0:
        raise ValueError(f"{H} query heads not a multiple of {k.shape[2]} kv heads")
    if Sq < 1 or k.shape[1] < 1:
        raise ValueError("empty sequence")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1:
        raise ValueError(f"q, k, v on different devices: {devs}")
    if len({q.dtype, k.dtype, v.dtype}) != 1:
        raise ValueError("q, k, v must share one dtype")


def _check_layout(q, k, v) -> None:
    """The layouts the CUDA kernels take, read from shapes, strides and
    dtypes alone (so fake and meta tensors are checked too); anything else
    raises (no fallback).  The grid's second axis holds B x heads."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"not {q.dtype}")
    d = q.shape[3]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes d in {HEAD_DIMS}, not {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel needs contiguous {name}")
    if q.shape[0] * q.shape[2] > _MAX_GRID_Y:
        raise ValueError(f"flash_attention kernel takes B x heads <= {_MAX_GRID_Y}, "
                         f"not {q.shape[0] * q.shape[2]}")


def _check_kernel(q, k, v) -> None:
    """What the CUDA kernels take: the layout, and TMA's (bf16) 16-byte
    aligned bases, which only a tensor with memory behind it has."""
    _check_layout(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel needs 16-byte aligned {name}")


def attention_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """The live (query, key) pairs: query i sees keys ``[lo, hi)``, ``hi =
    min(i + 1, Skv)`` when causal (else ``Skv``) and ``lo = i - window + 1``
    with a window."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i + 1, Skv) if causal else np.full_like(i, Skv)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros_like(i)
    return int(np.clip(hi - lo, 0, None).sum())


def flops_fwd(B: int, Sq: int, Skv: int, H: int, d: int, causal: bool, window: int) -> int:
    """The forward's operations: Q.K^T and P.V over the live pairs, 2 a
    multiply-add (the cap adds no product)."""
    return 4 * B * H * d * attention_pairs(Sq, Skv, causal, window)


def flops_bwd(B: int, Sq: int, Skv: int, H: int, d: int, causal: bool, window: int) -> int:
    """The backward's: 5 products (S, dP, dV, dK, dQ), 2.5x the forward."""
    return 10 * B * H * d * attention_pairs(Sq, Skv, causal, window)


def _fwd(q, k, v, causal, window, softcap, want_lse):
    """Launch the forward kernel -> ``(o, lse)``; ``lse`` is empty unless
    ``want_lse``."""
    _check_kernel(q, k, v)
    B, Sq, H, d = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq) if want_lse else (0,), dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if want_lse else None, _DTYPE_CODE[q.dtype], B, Sq, Skv, H,
        KV, d, *strides, int(bool(causal)), int(window), float(softcap), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: {_error(err)}")
    launches["fwd"] += 1
    return o, lse


def _fwd_fake(q, k, v, causal, window, softcap, want_lse):
    B, Sq, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, Sq) if want_lse else (0,),
                                            dtype=torch.float32)


_fwd_op = _library.define(
    "flash_attention_fwd(Tensor q, Tensor k, Tensor v, bool causal, int window, "
    "float softcap, bool want_lse) -> (Tensor, Tensor)", _fwd, _fwd_fake,
    lambda q, k, v, causal, window, softcap, want_lse, **_:
    flops_fwd(q[0], q[1], k[1], q[2], q[3], causal, window))


def _bwd(q, k, v, o, do, lse, causal, window, softcap):
    """Launch the backward kernels (a ``rowsum(dO * O)`` pre-pass, then
    dk/dv and dq) -> ``(dq, dk, dv)``."""
    B, Sq, H, d = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if do.data_ptr() % 16:  # TMA and the pre-pass read 16-byte-aligned rows
        do = do.clone()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rowdot = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), rowdot.data_ptr(),
        _DTYPE_CODE[q.dtype], B, Sq, Skv, H, KV, d, int(bool(causal)),
        int(window), float(softcap), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed: {_error(err)}")
    launches["bwd"] += 1
    return dq, dk, dv


_bwd_op = _library.define(
    "flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor o, Tensor do, Tensor lse, "
    "bool causal, int window, float softcap) -> (Tensor, Tensor, Tensor)", _bwd,
    lambda q, k, v, *_: (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)),
    lambda q, k, v, o, do, lse, causal, window, softcap, **_:
    flops_bwd(q[0], q[1], k[1], q[2], q[3], causal, window))


class FlashAttentionFunction(torch.autograd.Function):
    """The CUDA kernels under autograd: ``forward`` launches the forward
    kernel with the row LSE, ``backward`` the backward kernels (a
    ``rowsum(dO * O)`` pre-pass, then dk/dv and dq), with the same cap."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap=0.0):
        o, lse = _fwd_op(q, k, v, causal, window, softcap, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.softcap = causal, window, softcap
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        dq, dk, dv = _bwd_op(q, k, v, o, do, lse, ctx.causal, ctx.window, ctx.softcap)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Attention, with an optional logit softcap (0: none).  CUDA tensors
    launch the kernels on the current stream (no synchronisation): through
    ``FlashAttentionFunction`` when grad mode is on and an input requires
    grad, else the forward alone.  Meta tensors take the same path through
    the operators' fake implementation.  CPU tensors take the plain
    version."""
    _check(q, k, v, causal, window, softcap)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, softcap=softcap)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda or cpu (or meta, which models the "
                         f"card), not {q.device}")
    _check_layout(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, causal, window, softcap)
    return _fwd_op(q, k, v, causal, window, softcap, False)[0]


_fns = None


def _error(err: int) -> str:
    site = _lib().flash_attention_error_site().decode()
    return f"error {err} at {site or 'an unnamed step'}"


def _lib():
    """The C entries ``flash_attention_fwd``, ``flash_attention_bwd`` and
    ``flash_attention_error_site``, built and typed at first use."""
    global _fns
    if _fns is None:
        from repro_torch.kernels import _build

        lib = _build.load("flash_attention")
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.flash_attention_fwd.restype = i
        lib.flash_attention_fwd.argtypes = [p] * 5 + [i] * 7 + [ll] * 12 + [i] * 2 + [f, p]
        lib.flash_attention_bwd.restype = i
        lib.flash_attention_bwd.argtypes = [p] * 10 + [i] * 9 + [f, p]
        lib.flash_attention_error_site.restype = ctypes.c_char_p
        lib.flash_attention_error_site.argtypes = []
        _fns = lib
    return _fns
