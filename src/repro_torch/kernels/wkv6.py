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
chunk 64).  Every version here keeps every exponent non-positive:

* ``csrc/wkv6.cu`` holds the kernels (design and bound in its header).
  bf16 takes the chunked form: chunks of ``KCHUNK`` = 64 steps, sub-chunks
  of ``SUB`` = 16, one CTA per (chunk, head, batch); forward, each chunk's
  own state, a short pass over chunks for the state entering each (saved
  for the backward), then the output ``r Sp + A v``; backward, the mirror
  (a reverse pass for the gradient of the state leaving each chunk), then
  ``dv`` and a ``du`` partial per chunk, and ``dr``, ``dk``, ``dw`` from each
  chunk's own 64-step walk, so ``dw`` stays an exact dot product.  The
  state-sized products run on tensor cores with every operand that is not
  an input split into two bf16 halves (fp32-grade); the in-chunk matrix
  ``A``, whose decay differs per key channel, is formed from sub-chunks:
  the blocks across sub-chunks by the same split products, those inside
  one in fp32 on the CUDA cores; deterministic.  fp32 runs the recurrence
  step by step; its backward recomputes the state from checkpoints.
* ``wkv6_chunked_grads_plain`` is the bf16 kernels' formulas in plain
  PyTorch, for the tests.
* ``wkv6_plain`` is a chunked form in plain PyTorch whose decay exponents
  are each a masked sum of exactly the ``log w`` steps they span
  (``exp(sum_{j<m<t} log w_m)`` for a pair ``j < t``), never a difference
  of cumulative sums, so autograd through it is free of cancellation too.

``wkv6`` is the wrapper: CUDA tensors go through ``WKV6Function`` (the
forward kernels, and the backward kernels under autograd) or raise; CPU
tensors take ``wkv6_plain`` and autograd through it.  ``launches`` counts
calls that launch kernels, one per direction however many kernels a
direction runs, and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

W_MIN = 1e-6  # the decay clip of the reference (log(clip(w, 1e-6, 1)))
HEAD_SIZES = (32, 64)  # K = V the kernels take
CHUNK = 16  # the plain version's chunk
KCHUNK = 64  # the bf16 kernels' chunk (csrc/wkv6.cu: L)
SUB = 16  # the bf16 kernels' sub-chunk (csrc/wkv6.cu: SUB)
SEG = 8  # the fp32 backward kernel's checkpoint interval (csrc/wkv6.cu: SEG)
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


def wkv6_chunked_grads_plain(r, k, v, w, u, init_state, do, dsT=None):
    """The forward and the gradients of ``<o, do> + <final_state, dsT>`` by
    the formulas of the bf16 kernels, in plain PyTorch and in the inputs'
    float dtype (fp32 or fp64); used only by the tests, which hold it against
    autograd.  Returns ``(o, final_state, dr, dk, dv, dw, du, d_init_state)``.

    Per chunk of ``KCHUNK`` steps and head, with ``lw = log clip(w)`` (padded
    steps: ``w = 1``, ``r = k = v = 0``), sub-chunks of ``SUB`` steps, and
    every exponent a sum of exactly the steps it spans:

    * own state ``sum_j (k_j ⊙ exp(sum_{m>j} lw_m)) v_j^T``; state pass
      ``S_c = diag(exp(tot_c)) S_{c-1} + own_c`` gives ``S_in`` of each chunk;
    * ``A[t, j] = sum_k r_t k_j exp(sum_{j<m<t} lw_m)`` for ``j < t``, with
      ``A[t, t] = r_t . (u ⊙ k_t)``: across sub-chunks ``I > J`` as
      ``(r_t ⊙ exp(pe_t)) . (k_j ⊙ exp(ke_j) ⊙ gap_JI)`` (``pe_t`` the sum
      from the start of t's sub-chunk to ``t - 1``, ``ke_j`` from ``j + 1`` to
      the end of j's, ``gap_JI`` the whole sub-chunks between); inside a
      sub-chunk each pair's own span;
    * ``o = rdec S_in + A v`` with ``rdec_t = r_t ⊙ exp(pe_t) ⊙ exp(pre_I)``
      (``pre_I``: the sub-chunks before t's);
    * ``D_c = sum_i (r_i ⊙ exp(sum_{m<i} lw_m))^T do_i``; reverse pass
      ``G_{c-1} = diag(exp(tot_c)) G_c + D_c`` from ``dsT`` gives ``G_out``
      of each chunk and the initial state's gradient;
    * ``dv = A^T do + kdec G_out^T``-shaped: ``dv_j = sum_t A[t, j] do_t +
      G_out^T kdec_j``, ``kdec_j = k_j ⊙ exp(ke_j) ⊙ exp(post_J)``;
    * ``dr``, ``dk``, ``dw`` by each chunk's own walk: ``S_{t-1}`` forward
      from ``S_in``, ``G_t`` backward from ``G_out``;
      ``dr_t = S_{t-1} do_t + u ⊙ k_t (do_t . v_t)``,
      ``dk_t = G_t v_t + u ⊙ r_t (do_t . v_t)``,
      ``dw_t = rowsum(G_t ⊙ S_{t-1})`` where ``w_t`` is in ``[1e-6, 1]``
      (an exact dot product: never a division by ``w``);
    * ``du = sum_{b, c} sum_t r_t ⊙ k_t (do_t . v_t)``, b then c, in fp64.
    """
    B, S, H, K = r.shape
    V = v.shape[-1]
    f = r.dtype if r.dtype == torch.float64 else torch.float32
    dev = r.device
    L, sub = KCHUNK, SUB
    ns = L // sub
    pad = (-S) % L
    nc = (S + pad) // L

    def chunks(t, fill=0.0):  # (B, S, H, X) -> (B, nc, H, L, X)
        t = F.pad(t.to(f), (0, 0, 0, 0, 0, pad), value=fill)
        return t.reshape(B, nc, L, H, t.shape[-1]).transpose(2, 3)

    rc, kc, vc, doc = chunks(r), chunks(k), chunks(v), chunks(do)
    wraw = chunks(w, fill=1.0)
    wc = torch.clamp(wraw, W_MIN, 1.0)
    lw = torch.log(wc)  # 0 on padded steps
    uf = u.to(f)[None, None, :, None, :]  # (1, 1, H, 1, K)
    i = torch.arange(L, device=dev)
    s_of = i // sub
    same = s_of[:, None] == s_of[None, :]
    sel = lambda m: m.to(f)
    before, after = sel(i[None, :] < i[:, None]), sel(i[None, :] > i[:, None])  # [t, m]
    pe = torch.einsum("tm,bchmk->bchtk", before * sel(same), lw)
    ke = torch.einsum("jm,bchmk->bchjk", after * sel(same), lw)
    subtot = lw.reshape(B, nc, H, ns, sub, K).sum(4)  # (B, nc, H, ns, K)
    sidx = torch.arange(ns, device=dev)
    pre = torch.einsum("is,bchsk->bchik", sel(sidx[None, :] < sidx[:, None]), subtot)
    post = torch.einsum("js,bchsk->bchjk", sel(sidx[None, :] > sidx[:, None]), subtot)
    up = lambda x: x.repeat_interleave(sub, dim=3)  # per sub-chunk -> per step
    rq, kb = rc * torch.exp(pe), kc * torch.exp(ke)
    rdec, kdec = rq * torch.exp(up(pre)), kb * torch.exp(up(post))

    # A: across sub-chunks through the boundary factorisation, inside them
    # each pair's own span, the bonus on the diagonal
    between = sel((i[None, :, None] < i[None, None, :]) & (i[None, None, :] < i[:, None, None]))
    gap = torch.exp(torch.einsum("IJs,bchsk->bchIJk", sel(
        (sidx[None, :, None] < sidx[None, None, :]) & (sidx[None, None, :] < sidx[:, None, None])),
        subtot))  # gap[I, J] = exp(sum of the sub-chunks strictly between J and I)
    A_off = torch.einsum("bchtk,bchjk,bchtjk->bchtj", rq, kb,
                         up(up(gap.transpose(3, 4)).transpose(3, 4)))
    A_in = torch.einsum("bchtk,bchjk,bchtjk->bchtj", rc, kc,
                        torch.exp(torch.einsum("tjm,bchmk->bchtjk", between, lw)))
    lower = i[None, :] < i[:, None]
    A = (torch.where(lower & ~same, A_off, torch.zeros((), dtype=f, device=dev))
         + torch.where(lower & same, A_in, torch.zeros((), dtype=f, device=dev))
         + torch.diag_embed((rc * uf * kc).sum(-1)))

    # forward: own states, the state pass, the output
    own = torch.einsum("bchjk,bchjv->bchkv", kc * torch.exp(torch.einsum(
        "jm,bchmk->bchjk", after, lw)), vc)
    tot = subtot.sum(3)  # (B, nc, H, K)
    s = (torch.zeros((B, H, K, V), dtype=f, device=dev)
         if init_state is None else init_state.to(f))
    S_in = []
    for c in range(nc):
        S_in.append(s)
        s = torch.exp(tot[:, c])[..., None] * s + own[:, c]
    sT = s
    S_in = torch.stack(S_in, 1)  # (B, nc, H, K, V)
    o = torch.einsum("bchtk,bchkv->bchtv", rdec, S_in) + torch.einsum("bchtj,bchjv->bchtv", A, vc)

    # reverse pass: the gradient of the state leaving each chunk
    D = torch.einsum("bchik,bchiv->bchkv", rc * torch.exp(torch.einsum(
        "im,bchmk->bchik", before, lw)), doc)
    g = (torch.zeros((B, H, K, V), dtype=f, device=dev) if dsT is None else dsT.to(f))
    G = [None] * nc
    for c in reversed(range(nc)):
        G[c] = g
        g = torch.exp(tot[:, c])[..., None] * g + D[:, c]
    ds0 = g
    G = torch.stack(G, 1)

    dv = (torch.einsum("bchtj,bchtv->bchjv", A, doc)
          + torch.einsum("bchjk,bchkv->bchjv", kdec, G))
    dvv = (doc * vc).sum(-1, keepdim=True)  # do_t . v_t

    # each chunk's walk
    hist, st = [], S_in
    dr = []
    for t in range(L):
        hist.append(st)
        dr.append(torch.einsum("bchkv,bchv->bchk", st, doc[:, :, :, t]))
        st = wc[:, :, :, t, :, None] * st + kc[:, :, :, t, :, None] * vc[:, :, :, t, None, :]
    dr = torch.stack(dr, 3) + uf * kc * dvv
    dk, dw, gt = [None] * L, [None] * L, G
    for t in reversed(range(L)):
        dk[t] = torch.einsum("bchkv,bchv->bchk", gt, vc[:, :, :, t])
        dw[t] = (gt * hist[t]).sum(-1)
        gt = wc[:, :, :, t, :, None] * gt + rc[:, :, :, t, :, None] * doc[:, :, :, t, None, :]
    dk = torch.stack(dk, 3) + uf * rc * dvv
    in_range = (wraw >= W_MIN) & (wraw <= 1.0)
    dw = torch.where(in_range, torch.stack(dw, 3), torch.zeros((), dtype=f, device=dev))
    du = (rc * kc * dvv).sum(3).to(torch.float64).sum((0, 1))  # (H, K), b then c

    def unchunk(t):  # (B, nc, H, L, X) -> (B, S, H, X)
        return t.transpose(2, 3).reshape(B, nc * L, H, t.shape[-1])[:, :S]

    return (unchunk(o).to(r.dtype), sT, unchunk(dr).to(r.dtype), unchunk(dk).to(k.dtype),
            unchunk(dv).to(v.dtype), unchunk(dw).to(w.dtype), du.to(u.dtype),
            None if init_state is None else ds0.to(init_state.dtype))


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
        # the bf16 kernels read these (and write the final state) 16 bytes at a time
        if r.dtype == torch.bfloat16 and name != "u" and t.data_ptr() % 16:
            raise ValueError(f"wkv6 kernel needs {name} 16-byte aligned")
    if r.dtype == torch.bfloat16 and r.shape[0] * r.shape[2] > 65535:
        raise ValueError(f"wkv6 bf16 kernels take B x H <= 65535, not {r.shape[0] * r.shape[2]}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (a copy if it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _call(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"wkv6 {name} kernel launch failed: CUDA error {err}")


class WKV6Function(torch.autograd.Function):
    """The CUDA kernels under autograd.  bf16: ``forward`` launches
    ``wkv6_chunk_fwd`` and saves the state entering each chunk and each
    chunk's sum of ``log w``; ``backward`` launches ``wkv6_chunk_bwd``.
    fp32: ``wkv6_fwd`` and ``wkv6_bwd`` (the recurrence, which recomputes
    its states, so only the inputs are saved).  Either is correct under
    ``torch.utils.checkpoint`` recompute."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, init_state):
        B, S, H, N = r.shape
        dev = r.device
        u32 = u.float().contiguous()
        o = torch.empty_like(v)
        sT = torch.empty((B, H, N, N), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ins = (_ptr(r), _ptr(k), _ptr(v), _ptr(w), _ptr(u32), _ptr(init_state))
        if r.dtype == torch.bfloat16:
            nc = -(-S // KCHUNK)
            Sp = torch.empty((B, nc, H, N, N), dtype=torch.float32, device=dev)
            tot = torch.empty((B, nc, H, N), dtype=torch.float32, device=dev)
            _call("forward", _lib().wkv6_chunk_fwd(*ins, _ptr(o), _ptr(sT), _ptr(Sp), _ptr(tot),
                                                   B, S, H, N, stream))
            saved = (Sp, tot)
        else:
            _call("forward", _lib().wkv6_fwd(*ins, _ptr(o), _ptr(sT), _DTYPE_CODE[r.dtype],
                                             B, S, H, N, stream))
            saved = ()
        launches["fwd"] += 1
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u32, init_state, *saved)
        ctx.u_dtype = u.dtype
        return o, sT

    @staticmethod
    def backward(ctx, do, dsT):
        r, k, v, w, u32, init_state, *saved = ctx.saved_tensors
        B, S, H, N = r.shape
        dev = r.device
        do = torch.zeros_like(v) if do is None else _aligned(do.to(r.dtype))
        dsT = None if dsT is None else _aligned(dsT.float())
        dr, dk, dv, dw = (torch.empty_like(x) for x in (r, k, v, w))
        du = torch.empty((H, N), dtype=torch.float32, device=dev)
        ds0 = (torch.empty_like(init_state)
               if init_state is not None and ctx.needs_input_grad[5] else None)
        stream = torch.cuda.current_stream(dev).cuda_stream
        outs = (_ptr(dr), _ptr(dk), _ptr(dv), _ptr(dw), _ptr(du), _ptr(ds0))
        if r.dtype == torch.bfloat16:
            Sp, tot = saved
            G = torch.empty_like(Sp)
            du_part = torch.empty(tot.shape, dtype=torch.float64, device=dev)
            _call("backward", _lib().wkv6_chunk_bwd(
                _ptr(r), _ptr(k), _ptr(v), _ptr(w), _ptr(u32), _ptr(do), _ptr(dsT), _ptr(Sp),
                _ptr(tot), *outs, _ptr(G), _ptr(du_part), B, S, H, N, stream))
        else:
            du_part = torch.empty((B, H, N), dtype=torch.float32, device=dev)
            ckpt = torch.empty((B * H, -(-S // SEG), N, N), dtype=torch.float32, device=dev)
            _call("backward", _lib().wkv6_bwd(
                _ptr(r), _ptr(k), _ptr(v), _ptr(w), _ptr(u32), _ptr(init_state), _ptr(do),
                _ptr(dsT), *outs, _ptr(du_part), _ptr(ckpt), _DTYPE_CODE[r.dtype], B, S, H, N,
                stream))
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
    """The C entries (``wkv6_fwd``, ``wkv6_bwd`` for fp32, ``wkv6_chunk_fwd``,
    ``wkv6_chunk_bwd`` for bf16), built and typed at first use."""
    global _fns
    if _fns is None:
        from repro_torch.kernels import _build

        lib = _build.load("wkv6")
        p, i = ctypes.c_void_p, ctypes.c_int
        for name, n_ptr, n_int in (("wkv6_fwd", 8, 5), ("wkv6_bwd", 16, 5),
                                   ("wkv6_chunk_fwd", 10, 4), ("wkv6_chunk_bwd", 17, 4)):
            fn = getattr(lib, name)
            fn.restype = i
            fn.argtypes = [p] * n_ptr + [i] * n_int + [p]
        _fns = lib
    return _fns
