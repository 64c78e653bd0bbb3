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

Each C entry is a registered operator, ``repro_torch::ssd_chunk_fwd``/
``_bwd`` (bf16) and ``repro_torch::ssd_fwd``/``_bwd`` (fp32): the real
implementation (CUDA tensors) checks the pointers the kernels read and
launches; a fake one (fake and meta tensors: ``launch/dryrun.py``) returns
empty outputs of the right shapes; a FLOP formula (``chunk_flops``,
``recurrence_flops``) serves ``torch.utils.flop_counter``.

``ssd`` is the wrapper: CUDA tensors go through ``SSDFunction`` (the
forward kernels, and the backward kernels under autograd) or raise; meta
and fake tensors take the same path through the operators' fake
implementation; CPU tensors take ``ssd_plain`` and autograd through it.
``launches`` counts calls that launch kernels, one per direction however
many kernels a direction runs, and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _library

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


def _check_layout(x, dt, A, Bm, Cm, init_state) -> None:
    """The layouts the CUDA kernels take, read from shapes, strides and
    dtypes alone (so fake and meta tensors are checked too); anything else
    raises (no fallback)."""
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
    if x.dtype == torch.bfloat16 and x.shape[0] * x.shape[2] > 65535:
        raise ValueError(f"ssd bf16 kernels take B x H <= 65535, not {x.shape[0] * x.shape[2]}")


def _check_kernel(x, dt, A, Bm, Cm, init_state) -> None:
    """What the CUDA kernels take: the layout, and the 16-byte aligned
    bases the bf16 kernels read 16 bytes at a time from, which only a
    tensor with memory behind it has."""
    _check_layout(x, dt, A, Bm, Cm, init_state)
    if x.dtype == torch.bfloat16:
        named = dict(x=x, Bm=Bm, Cm=Cm, init_state=init_state)
        for name in _VECTOR_READ:
            if named[name] is not None and named[name].data_ptr() % 16:
                raise ValueError(f"ssd kernel needs {name} 16-byte aligned")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t`` (contiguous) 16-byte aligned: a copy if it is not."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def _call(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"ssd kernel {name} failed: CUDA error {err}")


def chunk_flops(B: int, S: int, H: int, P: int, N: int, backward: bool = False) -> int:
    """The operations of the chunked form at the TPU kernel's chunk of 128
    steps, its matmul form and the least work for the function: per chunk
    ``C B^T``, its product with ``X``, and the state in and out (``2 L^2 N
    + 2 L^2 P + 4 L N P``), taken per step; the backward does two products
    per forward product."""
    L = 128
    fwd = B * H * S * (2 * L * (N + P) + 4 * N * P)
    return 2 * fwd if backward else fwd


def recurrence_flops(B: int, S: int, H: int, P: int, N: int, backward: bool = False) -> int:
    """The fp32 recurrence's operations per (b, t, h) step: the state's
    decay and rank-1 update and ``S C`` (``5 P N``); the backward, which
    recomputes the states, ``14 P N``."""
    return B * S * H * P * N * (14 if backward else 5)


def _state_shapes(x, Bm):
    Bsz, S, H, P = x.shape
    return (Bsz, H, P, Bm.shape[2]), (Bsz, -(-S // CHUNK), H)


def _chunk_fwd(x, dt, A, Bm, Cm, init_state):
    """The bf16 forward kernels -> ``(y, final_state, Sp, tot)``: ``Sp``,
    the state entering each chunk, and ``tot``, each chunk's summed decay,
    are saved for the backward."""
    _check_kernel(x, dt, A, Bm, Cm, init_state)
    Bsz, S, H, P = x.shape
    N, nc = Bm.shape[2], -(-S // CHUNK)
    f32, dev = torch.float32, x.device
    y = torch.empty_like(x)
    sT = torch.empty((Bsz, H, P, N), dtype=f32, device=dev)
    Sp = torch.empty((Bsz, nc, H, P, N), dtype=f32, device=dev)
    tot = torch.empty((Bsz, nc, H), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _call("forward", _lib().ssd_chunk_fwd(
        _ptr(x), _ptr(dt), _ptr(A), _ptr(Bm), _ptr(Cm), _ptr(init_state), _ptr(y), _ptr(sT),
        _ptr(Sp), _ptr(tot), Bsz, S, H, P, N, stream))
    launches["fwd"] += 1
    return y, sT, Sp, tot


def _chunk_fwd_fake(x, dt, A, Bm, Cm, init_state):
    state, (Bsz, nc, H) = _state_shapes(x, Bm)
    f32 = torch.float32
    return (torch.empty_like(x), x.new_empty(state, dtype=f32),
            x.new_empty((Bsz, nc) + state[1:], dtype=f32), x.new_empty((Bsz, nc, H), dtype=f32))


def _chunk_bwd(x, dt, A, Bm, Cm, dy, dsT, Sp, tot, want_ds0):
    """The bf16 backward kernels -> ``(dx, ddt, dA, dBm, dCm, ds0)``;
    ``ds0`` is empty unless ``want_ds0``."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[2]
    dev, f32 = x.device, torch.float32
    dy, dsT = _aligned(dy), _aligned(dsT)
    dx, dBm, dCm = torch.empty_like(x), torch.empty_like(Bm), torch.empty_like(Cm)
    ddt, dA = torch.empty_like(dt), torch.empty_like(A)
    ds0 = torch.empty((Bsz, H, P, N) if want_ds0 else (0,), dtype=f32, device=dev)
    G = torch.empty_like(Sp)
    dBC_part = torch.empty((2, -(-H // HEAD_GROUP), Bsz, S, N), dtype=f32, device=dev)
    dA_part = torch.empty((Bsz, Sp.shape[1], H), dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _call("backward", _lib().ssd_chunk_bwd(
        _ptr(x), _ptr(dt), _ptr(A), _ptr(Bm), _ptr(Cm), _ptr(dy), _ptr(dsT), _ptr(Sp),
        _ptr(tot), _ptr(dx), _ptr(ddt), _ptr(dA), _ptr(dBm), _ptr(dCm),
        _ptr(ds0) if want_ds0 else None, _ptr(G), _ptr(dBC_part), _ptr(dA_part),
        Bsz, S, H, P, N, stream))
    launches["bwd"] += 1
    return dx, ddt, dA, dBm, dCm, ds0


def _fwd(x, dt, A, Bm, Cm, init_state):
    """The fp32 recurrence -> ``(y, final_state)``."""
    _check_kernel(x, dt, A, Bm, Cm, init_state)
    Bsz, S, H, P = x.shape
    N = Bm.shape[2]
    y = torch.empty_like(x)
    sT = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _call("forward", _lib().ssd_fwd(
        _ptr(x), _ptr(dt), _ptr(A), _ptr(Bm), _ptr(Cm), _ptr(init_state), _ptr(y), _ptr(sT),
        Bsz, S, H, P, N, stream))
    launches["fwd"] += 1
    return y, sT


def _fwd_fake(x, dt, A, Bm, Cm, init_state):
    state, _ = _state_shapes(x, Bm)
    return torch.empty_like(x), x.new_empty(state, dtype=torch.float32)


def _bwd(x, dt, A, Bm, Cm, init_state, dy, dsT, want_ds0):
    """The fp32 recurrence's backward (recomputing its states from
    checkpoints) -> ``(dx, ddt, dA, dBm, dCm, ds0)``."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[2]
    dev, f32 = x.device, torch.float32
    dy, dsT = _aligned(dy), _aligned(dsT)
    dx, dBm, dCm = torch.empty_like(x), torch.empty_like(Bm), torch.empty_like(Cm)
    ddt, dA = torch.empty_like(dt), torch.empty_like(A)
    ds0 = torch.empty((Bsz, H, P, N) if want_ds0 else (0,), dtype=f32, device=dev)
    dB_part = torch.empty((Bsz, S, H, N), dtype=f32, device=dev)
    dC_part = torch.empty((Bsz, S, H, N), dtype=f32, device=dev)
    dA_part = torch.empty((Bsz, H), dtype=torch.float64, device=dev)
    ckpt = torch.empty((Bsz * H, -(-S // SEG), P, N), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _call("backward", _lib().ssd_bwd(
        _ptr(x), _ptr(dt), _ptr(A), _ptr(Bm), _ptr(Cm), _ptr(init_state), _ptr(dy),
        _ptr(dsT), _ptr(dx), _ptr(ddt), _ptr(dA), _ptr(dBm), _ptr(dCm),
        _ptr(ds0) if want_ds0 else None, _ptr(dB_part), _ptr(dC_part), _ptr(dA_part),
        _ptr(ckpt), Bsz, S, H, P, N, stream))
    launches["bwd"] += 1
    return dx, ddt, dA, dBm, dCm, ds0


def _bwd_fake(x, dt, A, Bm, Cm, want_ds0):
    state, _ = _state_shapes(x, Bm)
    return (torch.empty_like(x), torch.empty_like(dt), torch.empty_like(A),
            torch.empty_like(Bm), torch.empty_like(Cm),
            x.new_empty(state if want_ds0 else (0,), dtype=torch.float32))


def _flops(count, backward):
    return lambda x, dt, A, Bm, *_, **__: count(*x, Bm[2], backward=backward)


_INPUTS = "Tensor x, Tensor dt, Tensor A, Tensor Bm, Tensor Cm"
_GRADS = "(Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)"
_chunk_fwd_op = _library.define(
    f"ssd_chunk_fwd({_INPUTS}, Tensor? init_state) -> (Tensor, Tensor, Tensor, Tensor)",
    _chunk_fwd, _chunk_fwd_fake, _flops(chunk_flops, False))
_chunk_bwd_op = _library.define(
    f"ssd_chunk_bwd({_INPUTS}, Tensor dy, Tensor? dsT, Tensor Sp, Tensor tot, "
    f"bool want_ds0) -> {_GRADS}", _chunk_bwd,
    lambda x, dt, A, Bm, Cm, dy, dsT, Sp, tot, want_ds0: _bwd_fake(x, dt, A, Bm, Cm, want_ds0),
    _flops(chunk_flops, True))
_fwd_op = _library.define(
    f"ssd_fwd({_INPUTS}, Tensor? init_state) -> (Tensor, Tensor)", _fwd, _fwd_fake,
    _flops(recurrence_flops, False))
_bwd_op = _library.define(
    f"ssd_bwd({_INPUTS}, Tensor? init_state, Tensor dy, Tensor? dsT, bool want_ds0) "
    f"-> {_GRADS}", _bwd,
    lambda x, dt, A, Bm, Cm, init_state, dy, dsT, want_ds0:
    _bwd_fake(x, dt, A, Bm, Cm, want_ds0), _flops(recurrence_flops, True))


class SSDFunction(torch.autograd.Function):
    """The CUDA kernels under autograd.  bf16: ``forward`` launches
    ``ssd_chunk_fwd`` and saves the state entering each chunk, ``backward``
    launches ``ssd_chunk_bwd``.  fp32: ``ssd_fwd`` and ``ssd_bwd`` (the
    recurrence, which recomputes its states, so only the inputs are saved).
    Either is correct under ``torch.utils.checkpoint`` recompute."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, init_state):
        if x.dtype == torch.bfloat16:
            y, sT, *saved = _chunk_fwd_op(x, dt, A, Bm, Cm, init_state)
        else:
            (y, sT), saved = _fwd_op(x, dt, A, Bm, Cm, init_state), ()
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm, init_state, *saved)
        return y, sT

    @staticmethod
    def backward(ctx, dy, dsT):
        x, dt, A, Bm, Cm, init_state, *saved = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.to(x.dtype).contiguous()
        dsT = None if dsT is None else dsT.float().contiguous()
        want_ds0 = init_state is not None and ctx.needs_input_grad[5]
        if x.dtype == torch.bfloat16:
            *grads, ds0 = _chunk_bwd_op(x, dt, A, Bm, Cm, dy, dsT, *saved, want_ds0)
        else:
            *grads, ds0 = _bwd_op(x, dt, A, Bm, Cm, init_state, dy, dsT, want_ds0)
        return (*grads, ds0 if want_ds0 else None)


def ssd(x, dt, A, Bm, Cm, init_state: Optional[torch.Tensor] = None) -> tuple:
    """SSD scan -> ``(y, final_state)``.  CUDA tensors launch the kernels on
    the current stream (no synchronisation) or raise; meta tensors take the
    operators' fake implementation; CPU tensors take ``ssd_plain``."""
    _check(x, dt, A, Bm, Cm, init_state)
    if x.device.type == "cpu":
        return ssd_plain(x, dt, A, Bm, Cm, init_state)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd runs on cuda or cpu (or meta, which models the "
                         f"card), not {x.device}")
    _check_layout(x, dt, A, Bm, Cm, init_state)
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
