"""RWKV-6 WKV: the hand-written CUDA kernels (forward and backward) and
their plain version.

Replaces ``repro/kernels/wkv6.py::_wkv6_kernel`` (the Pallas TPU kernel,
forward only).  Semantics are those of the sequential oracle
``ref.wkv6_reference`` with decays clipped to ``[1e-6, 1]``::

    o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)     S_t = diag(w_t) S_{t-1} + k_t v_t^T

r/k/w ``(B, S, H, K)``, v ``(B, S, H, V)``, u ``(H, K)``, optional
``init_state`` ``(B, H, K, V)`` fp32; returns ``(o, final_state)`` with
``o`` in r's dtype and the state in fp32.  Any ``S >= 1``.

The TPU kernel's chunked form multiplies ``k`` by ``exp(-cumsum(log w))``,
which overflows fp32 once decays are strong (NaN from ``w`` about 0.19 at
chunk 64).  Both versions here keep every exponent non-positive:

* ``csrc/wkv6.cu`` runs the recurrence step by step (design and bound in
  its header); ``wkv6_bwd`` recomputes the state from checkpoints, so
  ``dw`` is an exact dot product at every decay.
* ``wkv6_plain`` is a chunked form in plain PyTorch whose decay exponents
  are each a masked sum of exactly the ``log w`` steps they span
  (``exp(sum_{j<m<t} log w_m)`` for a pair ``j < t``), never a difference
  of cumulative sums, so autograd through it is free of cancellation too.

``wkv6`` is the wrapper: CUDA tensors go through ``WKV6Function`` (the
forward kernel, and the backward kernel under autograd) or raise; CPU
tensors take ``wkv6_plain`` and autograd through it.  ``launches`` counts
kernel launches per direction and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

W_MIN = 1e-6  # the decay clip of the reference (log(clip(w, 1e-6, 1)))
HEAD_SIZES = (32, 64)  # K = V the kernels take
CHUNK = 16  # the plain version's chunk
SEG = 8  # the backward kernel's checkpoint interval (csrc/wkv6.cu: SEG)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = {"fwd": 0, "bwd": 0}  # kernel launches through ``wkv6``


def _masks(L: int, device) -> tuple:
    """0/1 fp32 selectors over a chunk's steps: ``between[t, j, m]`` is
    ``j < m < t``, ``before[t, m]`` is ``m < t``, ``after[j, m]`` is
    ``m > j`` (so ``before`` is also the strict lower triangle ``j < t``)."""
    i = torch.arange(L, device=device)
    t, j, m = i[:, None, None], i[None, :, None], i[None, None, :]
    f32 = torch.float32
    return (((j < m) & (m < t)).to(f32), (i[None, :] < i[:, None]).to(f32),
            (i[None, :] > i[:, None]).to(f32))


def wkv6_plain(r, k, v, w, u, init_state: Optional[torch.Tensor] = None) -> tuple:
    """WKV-6 in plain PyTorch, chunked with non-positive exponents only.
    fp32 throughout; returns ``(o in r.dtype, final_state fp32)``."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    f32 = torch.float32
    L = CHUNK
    pad = (-S) % L
    rf, kf, vf = (F.pad(x.to(f32), (0, 0, 0, 0, 0, pad)) for x in (r, k, v))
    lw = F.pad(torch.log(torch.clamp(w.to(f32), W_MIN, 1.0)), (0, 0, 0, 0, 0, pad))
    n = (S + pad) // L
    rc, kc, lwc = (x.reshape(B, n, L, H, K) for x in (rf, kf, lw))
    vc = vf.reshape(B, n, L, H, V)
    between, before, after = _masks(L, r.device)

    # intra-chunk: A[t, j] = sum_k r_t k_j exp(sum_{j<m<t} lw_m), j < t
    decay = torch.exp(torch.einsum("tjm,bnmhk->bntjhk", between, lwc))
    A = (rc[:, :, :, None] * kc[:, :, None, :] * decay).sum(-1)  # (B, n, t, j, H)
    A = A * before[None, None, :, :, None]  # j < t
    diag = (rc * u.to(f32) * kc).sum(-1)  # (B, n, L, H)
    o = torch.einsum("bntjh,bnjhv->bnthv", A, vc) + diag[..., None] * vc

    # chunk summaries: S_next = exp(sum lw) S + sum_j (k_j exp(sum_{m>j} lw_m)) v_j^T
    r_in = rc * torch.exp(torch.einsum("tm,bnmhk->bnthk", before, lwc))
    k_out = kc * torch.exp(torch.einsum("jm,bnmhk->bnjhk", after, lwc))
    chunk_states = torch.einsum("bnjhk,bnjhv->bnhkv", k_out, vc)
    chunk_decay = torch.exp(lwc.sum(2))  # (B, n, H, K)
    state = (torch.zeros((B, H, K, V), dtype=f32, device=r.device)
             if init_state is None else init_state.to(f32))
    prev = []
    for c in range(n):
        prev.append(state)
        state = state * chunk_decay[:, c, :, :, None] + chunk_states[:, c]
    o = o + torch.einsum("bnthk,bnhkv->bnthv", r_in, torch.stack(prev, 1))
    return o.reshape(B, n * L, H, V)[:, :S].to(r.dtype), state


def _check(r, k, v, w, u, init_state) -> None:
    if r.dim() != 4 or r.shape != k.shape or r.shape != w.shape:
        raise ValueError(f"r, k, w must share one (B, S, H, K) shape: r{tuple(r.shape)} "
                         f"k{tuple(k.shape)} w{tuple(w.shape)}")
    B, S, H, K = r.shape
    if v.dim() != 4 or tuple(v.shape[:3]) != (B, S, H):
        raise ValueError(f"v must be (B, S, H, V) with r's B, S, H: v{tuple(v.shape)}")
    if tuple(u.shape) != (H, K):
        raise ValueError(f"u must be (H, K) = {(H, K)}, got {tuple(u.shape)}")
    if S < 1:
        raise ValueError("empty sequence")
    if init_state is not None and tuple(init_state.shape) != (B, H, K, v.shape[3]):
        raise ValueError(f"init_state must be (B, H, K, V) = {(B, H, K, v.shape[3])}, "
                         f"got {tuple(init_state.shape)}")
    tensors = (r, k, v, w, u) + (() if init_state is None else (init_state,))
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"wkv6 inputs on different devices: {devs}")


def _check_kernel(r, k, v, w, u, init_state) -> None:
    """What the CUDA kernels take; anything else raises (no fallback)."""
    if r.dtype not in _DTYPE_CODE or len({r.dtype, k.dtype, v.dtype, w.dtype}) != 1:
        raise TypeError(f"wkv6 kernel takes r, k, v, w of one dtype, float32 or "
                        f"bfloat16, not {(r.dtype, k.dtype, v.dtype, w.dtype)}")
    if u.dtype not in _DTYPE_CODE:
        raise TypeError(f"wkv6 kernel takes u in float32 or bfloat16, not {u.dtype}")
    K, V = r.shape[3], v.shape[3]
    if K != V or K not in HEAD_SIZES:
        raise ValueError(f"wkv6 kernel takes K = V in {HEAD_SIZES}, not K={K} V={V}")
    named = dict(r=r, k=k, v=v, w=w, u=u)
    if init_state is not None:
        if init_state.dtype != torch.float32:
            raise TypeError(f"wkv6 kernel takes a float32 init_state, not {init_state.dtype}")
        named["init_state"] = init_state
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"wkv6 kernel needs contiguous {name}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


class WKV6Function(torch.autograd.Function):
    """The CUDA kernels under autograd: ``forward`` launches ``wkv6_fwd``,
    ``backward`` launches ``wkv6_bwd`` (which recomputes the states it
    needs, so nothing but the inputs is saved; correct under
    ``torch.utils.checkpoint`` recompute)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, init_state):
        B, S, H, N = r.shape
        u32 = u.float().contiguous()
        o = torch.empty_like(v)
        sT = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _lib().wkv6_fwd(_ptr(r), _ptr(k), _ptr(v), _ptr(w), _ptr(u32),
                              _ptr(init_state), _ptr(o), _ptr(sT),
                              _DTYPE_CODE[r.dtype], B, S, H, N, stream)
        if err != 0:
            raise RuntimeError(f"wkv6 forward kernel launch failed: CUDA error {err}")
        launches["fwd"] += 1
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u32, init_state)
        ctx.u_dtype = u.dtype
        return o, sT

    @staticmethod
    def backward(ctx, do, dsT):
        r, k, v, w, u32, init_state = ctx.saved_tensors
        B, S, H, N = r.shape
        do = torch.zeros_like(v) if do is None else do.to(r.dtype).contiguous()
        dsT = None if dsT is None else dsT.float().contiguous()
        dr, dk, dv, dw = (torch.empty_like(x) for x in (r, k, v, w))
        dev = r.device
        du = torch.empty((H, N), dtype=torch.float32, device=dev)
        du_part = torch.empty((B, H, N), dtype=torch.float32, device=dev)
        ckpt = torch.empty((B * H, -(-S // SEG), N, N), dtype=torch.float32, device=dev)
        ds0 = (torch.empty_like(init_state)
               if init_state is not None and ctx.needs_input_grad[5] else None)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().wkv6_bwd(_ptr(r), _ptr(k), _ptr(v), _ptr(w), _ptr(u32),
                              _ptr(init_state), _ptr(do), _ptr(dsT), _ptr(dr), _ptr(dk),
                              _ptr(dv), _ptr(dw), _ptr(du), _ptr(ds0), _ptr(du_part),
                              _ptr(ckpt), _DTYPE_CODE[r.dtype], B, S, H, N, stream)
        if err != 0:
            raise RuntimeError(f"wkv6 backward kernel launch failed: CUDA error {err}")
        launches["bwd"] += 1
        return dr, dk, dv, dw, du.to(ctx.u_dtype), ds0


def wkv6(r, k, v, w, u, init_state: Optional[torch.Tensor] = None) -> tuple:
    """WKV-6 -> ``(o, final_state)``.  CUDA tensors launch the kernels on
    the current stream (no synchronisation) or raise; CPU tensors take
    ``wkv6_plain``."""
    _check(r, k, v, w, u, init_state)
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, init_state)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 runs on cuda or cpu, not {r.device}")
    _check_kernel(r, k, v, w, u, init_state)
    return WKV6Function.apply(r, k, v, w, u, init_state)


_fns = None


def _lib():
    """The C entries ``wkv6_fwd`` and ``wkv6_bwd``, built and typed at first use."""
    global _fns
    if _fns is None:
        from repro_torch.kernels import _build

        lib = _build.load("wkv6")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wkv6_fwd.restype = i
        lib.wkv6_fwd.argtypes = [p] * 8 + [i] * 5 + [p]
        lib.wkv6_bwd.restype = i
        lib.wkv6_bwd.argtypes = [p] * 16 + [i] * 5 + [p]
        _fns = lib
    return _fns
