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

* ``csrc/ssd_scan.cu`` holds the kernels (design and bound in its header).
  bf16 takes the chunked form on tensor cores: chunks of ``CHUNK`` = 64
  steps, ``HEAD_GROUP`` = 16 heads a CTA; forward, each chunk's own state,
  a short pass over chunks for the state entering each (``Sp``, saved for
  the backward), then the output; backward, the mirror, with a reverse pass
  for the state gradient at chunk boundaries.  Every operand that is not
  an input is split into two bf16 halves, so the products are fp32-grade;
  exponents are span sums masked before ``exp``; deterministic.  fp32 runs
  the recurrence step by step; its backward recomputes the state from
  checkpoints, so the decay gradient is an exact dot product.
* ``ssd_chunked_grads_plain`` is the bf16 backward's formulas in plain
  PyTorch, for the tests.
* ``ssd_plain`` is the chunked form of ``models/mamba2.ssd_chunked`` in
  plain PyTorch, any S (padded with ``dt = 0`` steps, which leave the
  state alone), with the segment sums masked to ``-inf`` *before* ``exp``,
  so autograd through it stays finite where the Pallas kernel's
  ``exp``-then-mask form reaches ``exp(+88)`` above the diagonal.  Each
  exponent is a masked sum of exactly the steps ``dt A`` it spans, never a
  difference of cumulative sums: at strong decays that difference cancels,
  and its gradient for ``A`` was off by 5e-4 against an fp64 oracle.

``ssd`` is the wrapper: CUDA tensors go through ``SSDFunction`` (the
forward kernels, and the backward kernels under autograd) or raise; CPU
tensors take ``ssd_plain`` and autograd through it.  ``launches`` counts
calls that launch kernels, one per direction however many kernels a
direction runs, and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

HEAD_DIMS = (32, 64)  # P the kernels take
STATE_DIMS = (16, 32, 64)  # N the kernels take
CHUNK = 64  # the chunk of the plain version and of the bf16 kernels (csrc/ssd_scan.cu: L)
HEAD_GROUP = 16  # heads per CTA of the bf16 kernels (csrc/ssd_scan.cu: HG)
SEG = 8  # the fp32 backward kernel's checkpoint interval (csrc/ssd_scan.cu: SEG)
_DTYPES = (torch.float32, torch.bfloat16)  # x, Bm, Cm: fp32 the recurrence, bf16 chunked

_VECTOR_READ = ("x", "Bm", "Cm", "init_state")  # read 16 bytes at a time by the bf16 kernels

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


def ssd_chunked_grads_plain(x, dt, A, Bm, Cm, init_state, dy, dsT=None, chunk: int = CHUNK):
    """The gradients of ``<y, dy> + <final_state, dsT>`` by the formulas of
    the bf16 backward kernels, in plain PyTorch and in the inputs' float
    dtype (fp32 or fp64); used only by the tests, which hold it against
    autograd.  Returns ``(dx, ddt, dA, dBm, dCm, d_init_state)``.

    Per chunk and head, with span sums ``seg[i, j] = sum_{j<m<=i} dA_m``,
    ``cum_i = sum_{m<=i} dA_m``, ``rev_l = sum_{m>l} dA_m`` and the chunk's
    total ``tot``, ``E = exp(seg)`` masked to 0 above the diagonal before
    ``exp``, and ``W = CB ⊙ E``:

    * state pass forward ``S_c = exp(tot_c) S_{c-1} + sum_l exp(rev_l) X̄_l B_l^T``
      gives the state entering each chunk, ``Sp``;
    * ``D_c = sum_i exp(cum_i) dy_i^T C_i``; reverse pass
      ``G_{c-1} = exp(tot_c) G_c + D_c`` from ``G_last = dsT`` gives the
      gradient of the state leaving each chunk, and ``G_{-1}`` that of the
      initial state;
    * ``dCB = (dy x^T) ⊙ dt_j ⊙ E``; ``dX̄ = W^T dy + exp(rev) ⊙ (B G^T)``;
      ``dC = dCB B + exp(cum) ⊙ (dy Sp)``; ``dB = dCB^T C + exp(rev) dt ⊙ (x G)``
      (both summed over heads);
    * the decay gradient ``g_m = d/d(dA_m)`` is
      ``sum_{i>=m>j} dCB_ij CB_ij + sum_{i>=m} r_i + sum_{l<m} u_l + e`` with
      ``r_i = C_i . (exp(cum_i) dy_i Sp)``, ``u_l = dt_l x_l . (exp(rev_l) G B_l)``,
      ``e = exp(tot) <G, Sp>``; ``ddt = dX̄ . x + A g``, ``dA = sum dt g``.
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    f = x.dtype if x.dtype == torch.float64 else torch.float32
    L = chunk
    pad = (-S) % L
    nc = (S + pad) // L

    def chunks(t, *tail):  # (B, S, *tail) -> (B, nc, L, *tail), padded with zeros
        t = F.pad(t.to(f), (0, 0) * len(tail) + (0, pad))
        return t.reshape(Bsz, nc, L, *tail)

    xc, dyc = chunks(x, H, P), chunks(dy, H, P)
    dtc = chunks(dt, H)  # padded steps have dt = 0: no decay, no input
    Bc, Cc = chunks(Bm, N), chunks(Cm, N)
    Af = A.to(f)
    dA = (dtc * Af).permute(0, 1, 3, 2)  # (B, nc, H, L)
    between, after = (m.to(f) for m in _masks(L, x.device))
    upto = 1.0 - after  # upto[l, m] = m <= l
    tril = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    seg = torch.einsum("ijm,bchm->bchij", between, dA)
    E = torch.exp(torch.where(tril, seg, torch.full((), float("-inf"), dtype=f,
                                                    device=x.device)))
    cum = torch.einsum("lm,bchm->bchl", upto, dA)
    rev = torch.einsum("lm,bchm->bchl", after, dA)
    tot = dA.sum(-1)  # (B, nc, H)
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    W = CB[:, :, None] * E  # (B, nc, H, L, L)

    # forward state pass: the state entering each chunk
    xb = xc * dtc[..., None]
    states = torch.einsum("bchl,bcln,bclhp->bchpn", torch.exp(rev), Bc, xb)
    s = (torch.zeros((Bsz, H, P, N), dtype=f, device=x.device)
         if init_state is None else init_state.to(f))
    Sp = []
    for c in range(nc):
        Sp.append(s)
        s = torch.exp(tot[:, c])[..., None, None] * s + states[:, c]
    Sp = torch.stack(Sp, 1)  # (B, nc, H, P, N)

    # reverse state pass: the gradient of the state leaving each chunk
    D = torch.einsum("bchi,bcihp,bcin->bchpn", torch.exp(cum), dyc, Cc)
    g = (torch.zeros((Bsz, H, P, N), dtype=f, device=x.device)
         if dsT is None else dsT.to(f))
    G = [None] * nc
    for c in reversed(range(nc)):
        G[c] = g
        g = torch.exp(tot[:, c])[..., None, None] * g + D[:, c]
    G = torch.stack(G, 1)
    ds0 = g

    # in-chunk products
    dCB = torch.einsum("bcihp,bcjhp->bchij", dyc, xc) * dtc.permute(0, 1, 3, 2)[..., None, :] * E
    dXs = torch.exp(rev)[..., None] * torch.einsum("bcjn,bchpn->bchjp", Bc, G)
    dXb = torch.einsum("bchij,bcihp->bchjp", W, dyc) + dXs  # (B, nc, H, L, P)
    xh = xc.permute(0, 1, 3, 2, 4)  # (B, nc, H, L, P)
    dth = dtc.permute(0, 1, 3, 2)  # (B, nc, H, L)
    u = dth * (xh * dXs).sum(-1)
    dCoff = torch.exp(cum)[..., None] * torch.einsum("bcihp,bchpn->bchin", dyc, Sp)
    r = (Cc[:, :, None] * dCoff).sum(-1)
    dC = torch.einsum("bchij,bcjn->bcin", dCB, Bc) + dCoff.sum(2)
    dBs = (torch.exp(rev) * dth)[..., None] * torch.einsum("bcjhp,bchpn->bchjn", xc, G)
    dB = torch.einsum("bchij,bcin->bcjn", dCB, Cc) + dBs.sum(2)
    e = torch.exp(tot) * (G * Sp).sum((-1, -2))  # (B, nc, H)
    T = torch.einsum("ijm,bchij->bchm", between, dCB * CB[:, :, None])
    gm = (T + torch.einsum("im,bchi->bchm", upto, r) + torch.einsum("lm,bchl->bchm", after, u)
          + e[..., None])
    ddt = (dXb * xh).sum(-1) + Af[:, None] * gm  # (B, nc, H, L)
    dAh = (dth * gm).sum((0, 1, 3))

    def unchunk(t):  # (B, nc, H, L, *tail) -> (B, S, H, *tail)
        t = t.transpose(2, 3)
        return t.reshape(Bsz, nc * L, *t.shape[3:])[:, :S]

    dx = unchunk(dXb * dth[..., None])
    dBm = dB.reshape(Bsz, nc * L, N)[:, :S]
    dCm = dC.reshape(Bsz, nc * L, N)[:, :S]
    return (dx.to(x.dtype), unchunk(ddt).to(dt.dtype), dAh.to(A.dtype), dBm.to(Bm.dtype),
            dCm.to(Cm.dtype), None if init_state is None else ds0.to(init_state.dtype))


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
    if x.dtype not in _DTYPES or len({x.dtype, Bm.dtype, Cm.dtype}) != 1:
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
        if x.dtype == torch.bfloat16 and name in _VECTOR_READ and t.data_ptr() % 16:
            raise ValueError(f"ssd kernel needs {name} 16-byte aligned")
    if x.dtype == torch.bfloat16 and x.shape[0] * x.shape[2] > 65535:
        raise ValueError(f"ssd bf16 kernels take B x H <= 65535, not {x.shape[0] * x.shape[2]}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (a copy if it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _call(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"ssd kernel {name} failed: CUDA error {err}")


class SSDFunction(torch.autograd.Function):
    """The CUDA kernels under autograd.  bf16: ``forward`` launches
    ``ssd_chunk_fwd`` and saves the state entering each chunk, ``backward``
    launches ``ssd_chunk_bwd``.  fp32: ``ssd_fwd`` and ``ssd_bwd`` (the
    recurrence, which recomputes its states, so only the inputs are saved).
    Either is correct under ``torch.utils.checkpoint`` recompute."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, init_state):
        Bsz, S, H, P = x.shape
        N = Bm.shape[2]
        dev = x.device
        y = torch.empty_like(x)
        sT = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ins = (_ptr(x), _ptr(dt), _ptr(A), _ptr(Bm), _ptr(Cm), _ptr(init_state))
        if x.dtype == torch.bfloat16:
            nc = -(-S // CHUNK)
            Sp = torch.empty((Bsz, nc, H, P, N), dtype=torch.float32, device=dev)
            tot = torch.empty((Bsz, nc, H), dtype=torch.float32, device=dev)
            _call("forward", _lib().ssd_chunk_fwd(*ins, _ptr(y), _ptr(sT), _ptr(Sp), _ptr(tot),
                                                  Bsz, S, H, P, N, stream))
            saved = (Sp, tot)
        else:
            _call("forward", _lib().ssd_fwd(*ins, _ptr(y), _ptr(sT), Bsz, S, H, P, N, stream))
            saved = ()
        launches["fwd"] += 1
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm, init_state, *saved)
        return y, sT

    @staticmethod
    def backward(ctx, dy, dsT):
        x, dt, A, Bm, Cm, init_state, *saved = ctx.saved_tensors
        Bsz, S, H, P = x.shape
        N = Bm.shape[2]
        dev = x.device
        dy = torch.zeros_like(x) if dy is None else _aligned(dy.to(x.dtype))
        dsT = None if dsT is None else _aligned(dsT.float())
        dx, dBm, dCm = torch.empty_like(x), torch.empty_like(Bm), torch.empty_like(Cm)
        ddt = torch.empty_like(dt)
        dA = torch.empty_like(A)
        f32 = torch.float32
        ds0 = (torch.empty_like(init_state)
               if init_state is not None and ctx.needs_input_grad[5] else None)
        stream = torch.cuda.current_stream(dev).cuda_stream
        outs = (_ptr(dx), _ptr(ddt), _ptr(dA), _ptr(dBm), _ptr(dCm), _ptr(ds0))
        if x.dtype == torch.bfloat16:
            Sp, tot = saved
            nc = Sp.shape[1]
            G = torch.empty_like(Sp)
            dBC_part = torch.empty((2, -(-H // HEAD_GROUP), Bsz, S, N), dtype=f32, device=dev)
            dA_part = torch.empty((Bsz, nc, H), dtype=torch.float64, device=dev)
            _call("backward", _lib().ssd_chunk_bwd(
                _ptr(x), _ptr(dt), _ptr(A), _ptr(Bm), _ptr(Cm), _ptr(dy), _ptr(dsT), _ptr(Sp),
                _ptr(tot), *outs, _ptr(G), _ptr(dBC_part), _ptr(dA_part), Bsz, S, H, P, N,
                stream))
        else:
            dB_part = torch.empty((Bsz, S, H, N), dtype=f32, device=dev)
            dC_part = torch.empty((Bsz, S, H, N), dtype=f32, device=dev)
            dA_part = torch.empty((Bsz, H), dtype=torch.float64, device=dev)
            ckpt = torch.empty((Bsz * H, -(-S // SEG), P, N), dtype=f32, device=dev)
            _call("backward", _lib().ssd_bwd(
                _ptr(x), _ptr(dt), _ptr(A), _ptr(Bm), _ptr(Cm), _ptr(init_state), _ptr(dy),
                _ptr(dsT), *outs, _ptr(dB_part), _ptr(dC_part), _ptr(dA_part), _ptr(ckpt),
                Bsz, S, H, P, N, stream))
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
    """The C entries (``ssd_fwd``, ``ssd_bwd`` for fp32, ``ssd_chunk_fwd``,
    ``ssd_chunk_bwd`` for bf16), built and typed at first use."""
    global _fns
    if _fns is None:
        from repro_torch.kernels import _build

        lib = _build.load("ssd_scan")
        p, i = ctypes.c_void_p, ctypes.c_int
        for name, n_ptr, n_int in (("ssd_fwd", 8, 5), ("ssd_bwd", 18, 5),
                                   ("ssd_chunk_fwd", 10, 5), ("ssd_chunk_bwd", 18, 5)):
            fn = getattr(lib, name)
            fn.restype = i
            fn.argtypes = [p] * n_ptr + [i] * n_int + [p]
        _fns = lib
    return _fns
