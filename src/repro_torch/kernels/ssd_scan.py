"""Mamba-2 SSD scan: the hand-written CUDA kernels (forward and backward)
and their plain version.

Replaces ``repro/kernels/ssd_scan.py::_ssd_kernel`` (the Pallas TPU kernel,
forward only).  Semantics are those of the sequential oracle
``ref.ssd_reference``, with one scalar decay per head and step::

    S_t = exp(dt_t A) S_{t-1} + (x_t dt_t) B_t^T        y_t = S_t C_t

x ``(B, S, H, P)``, dt ``(B, S, H)`` fp32, A ``(H,)`` fp32, Bm/Cm
``(B, S, N)`` shared by the heads, optional ``init_state`` ``(B, H, P, N)``
fp32; returns ``(y, final_state)`` with ``y`` in x's dtype and the state
in fp32.  Any ``S >= 1``.

* ``csrc/ssd_scan.cu`` runs the recurrence step by step (design and bound
  in its header); its backward recomputes the state from checkpoints, so
  the decay gradient is an exact dot product at every decay.
* ``ssd_plain`` is the chunked form of ``models/mamba2.ssd_chunked`` in
  plain PyTorch, any S (padded with ``dt = 0`` steps, which leave the
  state alone), with the segment sums masked to ``-inf`` *before* ``exp``,
  so autograd through it stays finite where the Pallas kernel's
  ``exp``-then-mask form reaches ``exp(+88)`` above the diagonal.  Each
  exponent is a masked sum of exactly the steps ``dt A`` it spans, never a
  difference of cumulative sums: at strong decays that difference cancels,
  and its gradient for ``A`` was off by 5e-4 against an fp64 oracle.

``ssd`` is the wrapper: CUDA tensors go through ``SSDFunction`` (the
forward kernel, and the backward kernel under autograd) or raise; CPU
tensors take ``ssd_plain`` and autograd through it.  ``launches`` counts
kernel launches per direction and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

HEAD_DIMS = (32, 64)  # P the kernels take
STATE_DIMS = (16, 32, 64)  # N the kernels take
CHUNK = 64  # the plain version's chunk
SEG = 8  # the backward kernel's checkpoint interval (csrc/ssd_scan.cu: SEG)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = {"fwd": 0, "bwd": 0}  # kernel launches through ``ssd``


def _masks(L: int, device) -> tuple:
    """0/1 fp32 selectors over a chunk's steps: ``between[i, j, m]`` is
    ``j < m <= i`` (the steps a pair's decay spans), ``after[l, m]`` is
    ``m > l``."""
    i = torch.arange(L, device=device)
    t, j, m = i[:, None, None], i[None, :, None], i[None, None, :]
    return ((j < m) & (m <= t)).float(), (i[None, :] > i[:, None]).float()


def ssd_plain(x, dt, A, Bm, Cm, init_state: Optional[torch.Tensor] = None) -> tuple:
    """The chunked SSD in plain PyTorch, fp32 throughout; returns
    ``(y in x.dtype, final_state fp32)``."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    L = CHUNK
    pad = (-S) % L
    nc = (S + pad) // L
    dtf = F.pad(dt.to(f32), (0, 0, 0, pad))
    xb = (F.pad(x.to(f32), (0, 0, 0, 0, 0, pad)) * dtf[..., None]).reshape(Bsz, nc, L, H, P)
    Bc = F.pad(Bm.to(f32), (0, 0, 0, pad)).reshape(Bsz, nc, L, N)
    Cc = F.pad(Cm.to(f32), (0, 0, 0, pad)).reshape(Bsz, nc, L, N)
    dA = (dtf * A.to(f32)).reshape(Bsz, nc, L, H).permute(0, 1, 3, 2)  # (B, nc, H, L)
    cum = torch.cumsum(dA, dim=-1)
    between, after = _masks(L, x.device)

    # intra-chunk: Y = (C B^T ⊙ exp(segsum)) X̄, masked before exp
    tril = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    seg = torch.where(tril, torch.einsum("ijm,bchm->bchij", between, dA),
                      torch.full((), float("-inf"), device=x.device))
    CB = torch.einsum("bcln,bcmn->bclm", Cc, Bc)
    y = torch.einsum("bchlm,bcmhp->bclhp", torch.exp(seg) * CB[:, :, None], xb)

    # chunk summaries and the inter-chunk recurrence
    decay_to_end = torch.exp(torch.einsum("lm,bchm->bchl", after, dA))  # (B, nc, H, L)
    states = torch.einsum("bchl,bcln,bclhp->bchpn", decay_to_end, Bc, xb)
    chunk_decay = torch.exp(cum[..., -1])  # (B, nc, H)
    state = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    y = y + torch.einsum("bcln,bchl,bchpn->bclhp", Cc, torch.exp(cum), torch.stack(prev, 1))
    return y.reshape(Bsz, nc * L, H, P)[:, :S].to(x.dtype), state


def _check(x, dt, A, Bm, Cm, init_state) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    Bsz, S, H, P = x.shape
    if tuple(dt.shape) != (Bsz, S, H):
        raise ValueError(f"dt must be (B, S, H) = {(Bsz, S, H)}, got {tuple(dt.shape)}")
    if tuple(A.shape) != (H,):
        raise ValueError(f"A must be (H,) = {(H,)}, got {tuple(A.shape)}")
    if Bm.dim() != 3 or tuple(Bm.shape[:2]) != (Bsz, S) or Cm.shape != Bm.shape:
        raise ValueError(f"Bm and Cm must share one (B, S, N) shape with B, S = {(Bsz, S)}: "
                         f"Bm{tuple(Bm.shape)} Cm{tuple(Cm.shape)}")
    if S < 1:
        raise ValueError("empty sequence")
    N = Bm.shape[2]
    if init_state is not None and tuple(init_state.shape) != (Bsz, H, P, N):
        raise ValueError(f"init_state must be (B, H, P, N) = {(Bsz, H, P, N)}, "
                         f"got {tuple(init_state.shape)}")
    tensors = (x, dt, A, Bm, Cm) + (() if init_state is None else (init_state,))
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"ssd inputs on different devices: {devs}")


def _check_kernel(x, dt, A, Bm, Cm, init_state) -> None:
    """What the CUDA kernels take; anything else raises (no fallback)."""
    if x.dtype not in _DTYPE_CODE or len({x.dtype, Bm.dtype, Cm.dtype}) != 1:
        raise TypeError(f"ssd kernel takes x, Bm, Cm of one dtype, float32 or bfloat16, "
                        f"not {(x.dtype, Bm.dtype, Cm.dtype)}")
    named = dict(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm)
    if init_state is not None:
        named["init_state"] = init_state
    for name in ("dt", "A", "init_state"):
        if name in named and named[name].dtype != torch.float32:
            raise TypeError(f"ssd kernel takes {name} in float32, not {named[name].dtype}")
    P, N = x.shape[3], Bm.shape[2]
    if P not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"ssd kernel takes P in {HEAD_DIMS} and N in {STATE_DIMS}, "
                         f"not P={P} N={N}")
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"ssd kernel needs contiguous {name}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


class SSDFunction(torch.autograd.Function):
    """The CUDA kernels under autograd: ``forward`` launches ``ssd_fwd``,
    ``backward`` launches ``ssd_bwd`` (which recomputes the states it
    needs, so nothing but the inputs is saved; correct under
    ``torch.utils.checkpoint`` recompute)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, init_state):
        Bsz, S, H, P = x.shape
        N = Bm.shape[2]
        y = torch.empty_like(x)
        sT = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().ssd_fwd(_ptr(x), _ptr(dt), _ptr(A), _ptr(Bm), _ptr(Cm),
                             _ptr(init_state), _ptr(y), _ptr(sT), _DTYPE_CODE[x.dtype],
                             Bsz, S, H, P, N, stream)
        if err != 0:
            raise RuntimeError(f"ssd forward kernel launch failed: CUDA error {err}")
        launches["fwd"] += 1
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm, init_state)
        return y, sT

    @staticmethod
    def backward(ctx, dy, dsT):
        x, dt, A, Bm, Cm, init_state = ctx.saved_tensors
        Bsz, S, H, P = x.shape
        N = Bm.shape[2]
        dev = x.device
        dy = torch.zeros_like(x) if dy is None else dy.to(x.dtype).contiguous()
        dsT = None if dsT is None else dsT.float().contiguous()
        dx, dBm, dCm = torch.empty_like(x), torch.empty_like(Bm), torch.empty_like(Cm)
        ddt = torch.empty_like(dt)
        dA = torch.empty_like(A)
        f32 = torch.float32
        dB_part = torch.empty((Bsz, S, H, N), dtype=f32, device=dev)
        dC_part = torch.empty((Bsz, S, H, N), dtype=f32, device=dev)
        dA_part = torch.empty((Bsz, H), dtype=torch.float64, device=dev)
        ckpt = torch.empty((Bsz * H, -(-S // SEG), P, N), dtype=f32, device=dev)
        ds0 = (torch.empty_like(init_state)
               if init_state is not None and ctx.needs_input_grad[5] else None)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ssd_bwd(_ptr(x), _ptr(dt), _ptr(A), _ptr(Bm), _ptr(Cm),
                             _ptr(init_state), _ptr(dy), _ptr(dsT), _ptr(dx), _ptr(ddt),
                             _ptr(dA), _ptr(dBm), _ptr(dCm), _ptr(ds0), _ptr(dB_part),
                             _ptr(dC_part), _ptr(dA_part), _ptr(ckpt),
                             _DTYPE_CODE[x.dtype], Bsz, S, H, P, N, stream)
        if err != 0:
            raise RuntimeError(f"ssd backward kernel launch failed: CUDA error {err}")
        launches["bwd"] += 1
        return dx, ddt, dA, dBm, dCm, ds0


def ssd(x, dt, A, Bm, Cm, init_state: Optional[torch.Tensor] = None) -> tuple:
    """SSD scan -> ``(y, final_state)``.  CUDA tensors launch the kernels on
    the current stream (no synchronisation) or raise; CPU tensors take
    ``ssd_plain``."""
    _check(x, dt, A, Bm, Cm, init_state)
    if x.device.type == "cpu":
        return ssd_plain(x, dt, A, Bm, Cm, init_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd runs on cuda or cpu, not {x.device}")
    _check_kernel(x, dt, A, Bm, Cm, init_state)
    return SSDFunction.apply(x, dt, A, Bm, Cm, init_state)


_fns = None


def _lib():
    """The C entries ``ssd_fwd`` and ``ssd_bwd``, built and typed at first use."""
    global _fns
    if _fns is None:
        from repro_torch.kernels import _build

        lib = _build.load("ssd_scan")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_fwd.restype = i
        lib.ssd_fwd.argtypes = [p] * 8 + [i] * 6 + [p]
        lib.ssd_bwd.restype = i
        lib.ssd_bwd.argtypes = [p] * 18 + [i] * 6 + [p]
        _fns = lib
    return _fns
