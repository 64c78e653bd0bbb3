"""Flash attention: the hand-written CUDA kernels (forward and backward)
and their plain version.

Replaces ``repro/kernels/flash_attention.py::_flash_kernel`` (the Pallas
TPU kernel).  The kernel, ``csrc/flash_attention.cu``, computes blocked
online-softmax attention over q ``(B, Sq, H, d)`` and k/v ``(B, Skv, KV, d)``:
causal or not, optional sliding window (``k > q - window``), GQA by
indexing (query head h reads kv head ``h // (H // KV)``), fp32 m/l
statistics and accumulator, the finite ``NEG_INF`` and the ``l == 0 -> 1``
guard.  Any ``Sq, Skv >= 1`` works; the Pallas block-multiple assert does
not carry over.

On an H100 the kernels are bound by tensor-core FLOPs (989 TFLOP/s bf16)
at prefill and training shapes.  bf16 runs every product on ``wgmma``
with tiles brought into swizzled shared memory by TMA from a producer
warpgroup, S/P/m/l and the accumulators in registers; fp32 runs on plain
FMAs (see the header of the ``.cu`` source for the design).

The backward (the TPU kernel has none) recomputes ``P = exp(S - LSE)``
from the row log-sum-exp the forward writes, and gives dq, dk and dv
(summed over each GQA group in a fixed order, so bit-identical from run
to run); autograd through ``flash_attention_plain`` is its plain
version.

``flash_attention`` is the wrapper: a CUDA tensor launches the kernels (or
the wrapper raises) through ``FlashAttentionFunction`` whenever an input
needs a gradient, so the output always carries autograd; a CPU tensor
takes ``flash_attention_plain``.  ``launches`` counts kernel launches per
direction and nothing else.
"""
from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1.0e30
HEAD_DIMS = (32, 64, 80, 128)
BLOCK_K = 128  # the plain version's kv tile: the Pallas kernel's block
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535  # the kernels' grid is (tiles, B x heads)

launches = {"fwd": 0, "bwd": 0}  # kernel launches through ``flash_attention``


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          return_lse: bool = False):
    """The kernel's algorithm in plain PyTorch: kv tiles of ``BLOCK_K``
    folded into fp32 running max/sum/accumulator, masked with the finite
    ``NEG_INF``, ``l == 0 -> 1`` at the end.  Ragged ``Skv`` is a short
    last tile.  With ``return_lse`` also the rows' log-sum-exp of the
    scaled scores, fp32 ``(B, H, Sq)`` (+inf where a row saw no key), as
    the kernel writes it for the backward."""
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
    if softcap:
        raise NotImplementedError(
            "flash_attention has no logit softcap (the Pallas kernel has "
            "none); softcap in the kernel is queued with the grok-1 port")
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


def _check_kernel(q, k, v) -> None:
    """What the CUDA kernels take; anything else raises (no fallback).  A
    pure function of the tensors' layouts: TMA (bf16) reads 16-byte-aligned
    bases and strides, and the grid's second axis holds B x heads."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"not {q.dtype}")
    d = q.shape[3]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes d in {HEAD_DIMS}, not {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel needs contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel needs 16-byte aligned {name}")
    if q.shape[0] * q.shape[2] > _MAX_GRID_Y:
        raise ValueError(f"flash_attention kernel takes B x heads <= {_MAX_GRID_Y}, "
                         f"not {q.shape[0] * q.shape[2]}")


def _forward(q, k, v, causal, window, want_lse):
    """Launch the forward kernel -> ``(o, lse or None)``."""
    B, Sq, H, d = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), _DTYPE_CODE[q.dtype], B, Sq, Skv, H,
        KV, d, *strides, int(bool(causal)), int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: {_error(err)}")
    launches["fwd"] += 1
    return o, lse


class FlashAttentionFunction(torch.autograd.Function):
    """The CUDA kernels under autograd: ``forward`` launches the forward
    kernel with the row LSE, ``backward`` the backward kernels (a
    ``rowsum(dO * O)`` pre-pass, then dk/dv and dq)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = _forward(q, k, v, causal, window, want_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        B, Sq, H, d = q.shape
        Skv, KV = k.shape[1], k.shape[2]
        do = do.to(q.dtype).contiguous()
        if do.data_ptr() % 16:  # TMA and the pre-pass read 16-byte-aligned rows
            do = do.clone()
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        rowdot = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), rowdot.data_ptr(),
            _DTYPE_CODE[q.dtype], B, Sq, Skv, H, KV, d, int(bool(ctx.causal)),
            int(ctx.window), stream)
        if err != 0:
            raise RuntimeError(f"flash_attention backward kernel launch failed: {_error(err)}")
        launches["bwd"] += 1
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Attention.  CUDA tensors launch the kernels on the current stream (no
    synchronisation): through ``FlashAttentionFunction`` when grad mode is
    on and an input requires grad, else the forward alone.  CPU tensors
    take the plain version."""
    _check(q, k, v, causal, window, softcap)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _check_kernel(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window, want_lse=False)[0]


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
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_fwd.restype = i
        lib.flash_attention_fwd.argtypes = [p] * 5 + [i] * 7 + [ll] * 12 + [i] * 2 + [p]
        lib.flash_attention_bwd.restype = i
        lib.flash_attention_bwd.argtypes = [p] * 10 + [i] * 9 + [p]
        lib.flash_attention_error_site.restype = ctypes.c_char_p
        lib.flash_attention_error_site.argtypes = []
        _fns = lib
    return _fns
