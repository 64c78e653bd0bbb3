"""Flash-attention forward: the hand-written CUDA kernel and its plain version.

Replaces ``repro/kernels/flash_attention.py::_flash_kernel`` (the Pallas
TPU kernel).  The kernel, ``csrc/flash_attention.cu``, computes blocked
online-softmax attention over q ``(B, Sq, H, d)`` and k/v ``(B, Skv, KV, d)``:
causal or not, optional sliding window (``k > q - window``), GQA by
indexing (query head h reads kv head ``h // (H // KV)``), fp32 m/l
statistics and accumulator, the finite ``NEG_INF`` and the ``l == 0 -> 1``
guard.  Any ``Sq, Skv >= 1`` works; the Pallas block-multiple assert does
not carry over.

On an H100 the kernel is bound by tensor-core FLOPs (989 TFLOP/s bf16) at
prefill shapes; bf16 runs on ``mma.sync`` with Q, S, P, m/l and O in
registers and K/V tiles in shared memory, fp32 on plain FMAs (see the
header of the ``.cu`` source for the design).

``flash_attention`` is the wrapper: a CUDA tensor launches the kernel (or
the wrapper raises), a CPU tensor takes ``flash_attention_plain``.
``launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1.0e30
HEAD_DIMS = (32, 64, 128)
BLOCK_K = 128  # the plain version's kv tile: the Pallas kernel's block
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches through ``flash_attention``


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """The kernel's algorithm in plain PyTorch: kv tiles of ``BLOCK_K``
    folded into fp32 running max/sum/accumulator, masked with the finite
    ``NEG_INF``, ``l == 0 -> 1`` at the end.  Ragged ``Skv`` is a short
    last tile."""
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
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = acc / l[..., None]  # (B, KV, G, Sq, d)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, d).to(q.dtype)


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


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Attention forward.  CUDA tensors launch the kernel on the current
    stream (no synchronisation); CPU tensors take the plain version."""
    _check(q, k, v, causal, window, softcap)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
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
    global launches
    B, Sq, H, _ = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    _DTYPE_CODE[q.dtype], B, Sq, Skv, H, KV, d, *strides,
                    int(bool(causal)), int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return o


_fwd = None


def _kernel():
    """The C entry ``flash_attention_fwd``, built and typed at first use."""
    global _fwd
    if _fwd is None:
        from repro_torch.kernels import _build

        fn = _build.load("flash_attention").flash_attention_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        _fwd = fn
    return _fwd
