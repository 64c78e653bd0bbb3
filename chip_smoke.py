#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. device  — the card's name and power limit; TF32 off for fp32 products.
  2. build   — compile every CUDA source of ``src/repro_torch/kernels/csrc``.
  3. kernels — the flash-attention kernel against its plain PyTorch version
     at the slice's own prefill shapes (phase 5's prompt lengths), then over
     a sweep of head layouts, head dims, ragged lengths (129 and 257 one
     past the kernel's 128-row tiles), windows and dtypes, and non-causal
     cases with Sq != Skv (tolerance fp32 2e-5, bf16 2e-2, absolute and
     relative, as ``tests/test_kernels.py``); then its time at the
     llama3-8b prefill shape beside the plain version,
     ``scaled_dot_product_attention`` (the library yardstick, never used by
     the port) and the card's bound.
  4. model   — llama3-8b at full width cut to 4 layers: prefill logits of a
     1000-token prompt through the kernel and through the plain attention
     path agree (bf16 tolerance below) and pick the same next token.
  5. slice   — llama3-8b at full width and depth (32 layers, bf16, random
     weights from a seeded generator) serves an 8-request trace through
     ``ContinuousBatchingEngine`` + ``ContinuousScheduler``; every request
     gets exactly ``max_new`` tokens, no page leaks, and the kernel ran
     once per prefill and layer.
  6. profile — device time by kernel over one prefill and over 8 decode
     ticks of the same engine, and the device's busy share.
Slice 2, training rwkv6-1.6b:
  3b. wkv6 — the WKV-6 forward and backward kernels against
     ``wkv6_plain``: first at the slice's shape (B=4, S=4096, 32 heads of
     64, bf16, decays from the model's formula), then over S, head size,
     decay strength (down to below the 1e-6 clip), init state and dtype;
     o, final state and every gradient (tolerance fp32 5e-4, bf16 2e-2,
     absolute and relative); then both kernels' times at the slice shape
     beside the plain version and the card's bound (no library call
     computes WKV-6).
  4b. model  — rwkv6-1.6b at full width cut to 4 layers: loss and every
     parameter gradient of one 2 x 1024 batch through the kernels and
     through ``wkv6_plain`` agree; exact launch counts.
  5b. slice  — rwkv6-1.6b at full width and depth (24 layers, fp32 params,
     bf16 compute, AdamW, per-layer remat) trains 8 steps at 4 x 4096
     through ``train.loop.train``: finite, falling loss; 2 forward and 1
     backward kernel launch per layer and step; finite parameters.
  6b. profile — one more training step under the profiler.
Slice 3, training zamba2-2.7b (3c and 3d run after 3b; 4c-6c after 6b,
once the rwkv6 state is freed):
  3c. ssd — the SSD-scan forward and backward kernels against
     ``ssd_plain``: first at the slice's shape (B=4, S=4096, 80 heads of
     64, state 64, bf16, dt and A from the model's formula at
     initialisation), then over S, P, N, decay strength, init state and
     dtype; y, final state and every gradient (tolerance fp32 5e-4, bf16
     2e-2, absolute and relative); then both kernels' times at the slice
     shape beside the plain version and the card's bound (no library call
     computes SSD).
  3d. flash backward — the forward at d_head 80 at the slice's shape
     (B=4, S=4096, 32 heads of 80, causal, window 4096) and its row LSE,
     then dq, dk, dv of the backward kernels against autograd through
     ``flash_attention_plain``: the slice shape, then over head layouts,
     d in {32, 64, 80, 128}, causal/window, ragged S (129 and 257 one past
     the tiles) and dtype (tolerance fp32 2e-4 absolute and relative; bf16
     2e-2 absolute and relative plus 2e-2 of each tensor's largest
     magnitude); then forward and backward times at the slice shape beside
     the plain version, autograd through ``scaled_dot_product_attention``
     and the card's bound, and two backward calls there must give
     bit-identical dq, dk, dv.
  4c. model — zamba2-2.7b at full width cut to 7 layers (the shared block
     runs twice): loss and every parameter gradient of one 2 x 1024 batch
     through the kernels and through the plain versions agree; exact
     launch counts.
  5c. slice — zamba2-2.7b at full width and depth (54 layers, fp32 params,
     bf16 compute, AdamW, per-layer remat) trains 20 steps at 4 x 4096
     through ``train.loop.train``: finite, falling loss; SSD launches
     108 forward and 54 backward per step, flash 18 and 9; finite
     parameters; median step, tokens/s and peak memory.
  6c. profile — one more training step under the profiler.
Phase 3 sweeps d_head 80 too.  Every timed kernel prints its TFLOP/s (of
the function's own operation count) and its share of the bound (bound ms /
kernel ms), and its JSON record carries both.  The last line is ``{"ok":
true, "device": {...}}``; the line before it is the kernels' JSON record
(six kernels: flash forward and backward, WKV-6 forward and backward, SSD
forward and backward).  Imports ``torch``, ``numpy`` and ``repro_torch``
only.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# In-model check: prefill logits through the kernel vs the plain path, in
# bf16, may differ by bf16 rounding carried through 4 layers; the bound is
# 5% of the largest logit, and the argmax must agree.
MODEL_RTOL = 5e-2
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM, dense
PEAK_BYTES = 3.35e12

SWEEP = dict(
    heads=[(32, 8), (4, 4), (8, 1)],
    d=[32, 64, 80, 128],
    S=[1, 17, 128, 129, 200, 257, 1000, 2048],  # 129, 257: one past the 128-row tiles
    window=[0, 96],
    dtype=["float32", "bfloat16"],
    causal=[True, False],
)
CROSS_LENS = [(100, 300), (300, 100), (129, 1), (1, 257), (1000, 2048)]  # (Sq, Skv)
PREFILL = dict(B=1, S=2048, H=32, KV=8, d=128)  # llama3-8b prefill attention


def slice_trace(vocab_size: int):
    """The request trace phase 5 serves (its prompt lengths are also the
    kernel's main-path shapes in phase 3)."""
    from repro_torch.serve.trace import generate_request_trace

    return generate_request_trace(8, seed=7, prompt_len=(128, 2048), max_new=(32, 64),
                                  vocab_size=vocab_size)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"card: {smi}")
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    return name, smi


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(paths)}")
    for name in sorted(paths):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas[{name}]: {line.strip()}")
    sys.stdout.flush()


def _inputs(B, Sq, Skv, H, KV, d, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    mk = lambda s, n: torch.randn((B, s, n, d), generator=g, device="cuda").to(dt)
    return mk(Sq, H), mk(Skv, KV), mk(Skv, KV)


def _time_ms(fn, reps=20, warmup=3):
    """Median of ``reps`` single-call times from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _rate(name, ops, ms, bound_ms):
    """Achieved TFLOP/s of the function's operation count and the share of
    the bound (bound ms / kernel ms), printed and returned for the record."""
    tflops, share = ops / (ms * 1e-3) / 1e12, bound_ms / ms
    print(f"{name}: {tflops:.1f} TFLOP/s, {share:.3f} of the bound", flush=True)
    return dict(tflops=tflops, bound_share=share)


def phase_kernels(prompt_lens):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    worst = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    B, H, KV, d = (PREFILL[x] for x in ("B", "H", "KV", "d"))
    main_path = [(B, (H, KV), d, (S, S), 0, "bfloat16", True) for S in prompt_lens]
    sweep = [(2, hd, dd, (S, S), w, dt, c)
             for hd, dd, S, w, dt, c in itertools.product(*SWEEP.values())]
    cross = [(2, hd, dd, lens, 0, dt, False)  # non-causal, Sq != Skv
             for hd, dd, lens, dt in itertools.product(
                 SWEEP["heads"], SWEEP["d"], CROSS_LENS, SWEEP["dtype"])]
    for b, (H, KV), d, (Sq, Skv), window, dtype, causal in main_path + sweep + cross:
        q, k, v = _inputs(b, Sq, Skv, H, KV, d, dtype, seed=n)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        tol = TOL[dtype]
        bad = ~(err <= tol + tol * want.float().abs())
        case = (f"B={b} H={H} KV={KV} d={d} Sq={Sq} Skv={Skv} window={window} {dtype} "
                f"causal={causal}")
        if bool(bad.any()) or not bool(torch.isfinite(got).all()):
            fail(f"kernel != plain at {case}: max abs err {float(err.max()):.3g}, "
                 f"{int(bad.sum())} elements beyond {tol}")
        worst[dtype] = max(worst[dtype], float(err.max()))
        n += 1
    print(f"kernels: flash_attention matches its plain version on {n} cases "
          f"({len(main_path)} at the slice's prompt lengths {sorted(prompt_lens)}, "
          f"{len(cross)} non-causal with Sq != Skv); max abs err fp32 {worst['float32']:.3g} (tol {TOL['float32']}), "
          f"bf16 {worst['bfloat16']:.3g} (tol {TOL['bfloat16']})")

    B, S, H, KV, d = (PREFILL[x] for x in ("B", "S", "H", "KV", "d"))
    q, k, v = _inputs(B, S, S, H, KV, d, "bfloat16", seed=1234)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # (B, heads, S, d) views
    kernel_ms = _time_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    plain_ms = _time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True), reps=10)
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True).transpose(1, 2)
    lib_err = float((fa.flash_attention(q, k, v, causal=True).float()
                     - lib_out.float()).abs().max())
    pairs = S * (S + 1) // 2  # live (query, key) pairs of causal attention
    flops = 4 * B * H * d * pairs  # Q.K^T and P.V, 2 operations per multiply-add
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())  # q, k, v in; o out
    bound_s = max(flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES)
    bound_by = "operations" if flops / PEAK_FLOPS["bfloat16"] >= nbytes / PEAK_BYTES else "bytes"
    print(f"prefill attention B={B} S={S} H={H} KV={KV} d={d} bf16 causal: "
          f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
          f"bound {bound_s * 1e3:.4f} ms ({bound_by}; {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB); kernel vs sdpa max abs err {lib_err:.3g}; "
          f"{flops / (kernel_ms * 1e-3) / 1e12:.1f} TFLOP/s", flush=True)
    rate = _rate("flash_attention (llama3-8b prefill)", flops, kernel_ms, bound_s * 1e3)
    return dict(**rate,
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:29",
        max_abs_err=max(worst.values()), max_abs_err_fp32=worst["float32"],
        max_abs_err_bf16=worst["bfloat16"], cases=n,
        ms=kernel_ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=bound_s * 1e3, bound_by=bound_by, library_ms=library_ms,
        shape=PREFILL,
    )


WKV_TOL = {"float32": 5e-4, "bfloat16": 2e-2}  # tests/test_kernels.py:68 for fp32
WKV_SLICE = dict(B=4, S=4096, H=32, N=64)  # rwkv6-1.6b training: 4 x 4096 tokens
WKV_SWEEP = dict(
    S=[1, 63, 64, 100, 1000, 4096],
    N=[32, 64],
    dec=[-2.0, 0.0, 1.0, 3.0],  # w = exp(-exp(dec)): 0.87, 0.37, 0.066, below the 1e-6 clip
    init=[False, True],
    dtype=["float32", "bfloat16"],
)
FP32_PEAK = 67e12  # H100 SXM fp32 outside the tensor cores


def _wkv_inputs(B, S, H, N, dtype, dec, init, seed):
    """r, k, v, w in ``dtype``, u fp32, optional init state; ``dec=None``
    draws the decays from the model's own formula at initialisation
    (w0 = 0 plus the rank-64 tanh LoRA of small-normal weights, as
    ``rwkv6_time_mix``), else ``w = exp(-exp(dec + 0.1 noise))``."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    mk = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    r, k, v = (mk(B, S, H, N).to(dt) for _ in range(3))
    if dec is None:
        D = H * N
        x = mk(B, S, D)
        a, b = 0.02 * mk(D, 64), 0.02 * mk(64, D)
        decay = torch.tanh(x @ a) @ b
    else:
        decay = dec + 0.1 * mk(B, S, H, N)
    w = torch.exp(-torch.exp(decay)).reshape(B, S, H, N).to(dt)
    u = 0.02 * mk(H, N)
    s0 = mk(B, H, N, N) if init else None
    return r, k, v, w, u, s0


def _scan_grads(fn, ins, do, dsT):
    """Forward outputs and the gradients of <o, do> + <final, dsT>."""
    import torch

    leaves = [x.detach().requires_grad_() for x in ins if x is not None]
    args = iter(leaves)
    o, sT = fn(*[next(args) if x is not None else None for x in ins])
    if dsT is None:  # the final state unused, as on the training path
        g = torch.autograd.grad([o], leaves, [do])
    else:
        g = torch.autograd.grad([o, sT], leaves, [do, dsT])
    return [o.detach(), sT.detach(), *g]


def _check_close(label, names, got, want, tol, worst, used, where, dtype, rel_to_max=False):
    """Fail unless every pair agrees within ``tol + tol |want|`` (plus
    ``tol max|want|`` when ``rel_to_max``); track the worst error and the
    largest share of an element's tolerance."""
    import torch

    for name, a, b in zip(names, got, want):
        a, b = a.float(), b.float()
        err = (a - b).abs()
        bound = tol + tol * b.abs()
        if rel_to_max:
            bound = bound + tol * b.abs().max()
        bad = ~(err <= bound)
        if bool(bad.any()) or not bool(torch.isfinite(a).all()):
            fail(f"{label}: kernel != plain for {name}: max abs err {float(err.max()):.3g}, "
                 f"{int(bad.sum())} elements beyond their bound (tol {tol})")
        worst[dtype] = max(worst[dtype], float(err.max()))
        share = float((err / bound).max())
        if share > used[dtype]:
            used[dtype], where[dtype] = share, f"{name} at {label}"


def phase_wkv6():
    """Phase 3b: both WKV-6 kernels against ``wkv6_plain``, then their times
    at the slice shape."""
    import torch

    from repro_torch.kernels import wkv6 as wk

    names = ["o", "final_state", "dr", "dk", "dv", "dw", "du", "d_init_state"]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    used = {"float32": 0.0, "bfloat16": 0.0}  # largest share of an element's tolerance
    where = {"float32": "", "bfloat16": ""}
    n = 0
    sl = WKV_SLICE
    main_path = [(sl["B"], sl["S"], sl["H"], sl["N"], None, False, "bfloat16")]
    sweep = [(2, S, 4, N, dec, init, dtype)
             for S, N, dec, init, dtype in itertools.product(*WKV_SWEEP.values())]
    for B, S, H, N, dec, init, dtype in main_path + sweep:
        ins = _wkv_inputs(B, S, H, N, dtype, dec, init, seed=100 + n)
        g = torch.Generator(device="cuda").manual_seed(n)
        do = torch.randn(ins[2].shape, generator=g, device="cuda").to(ins[0].dtype)
        dsT = None if dec is None else torch.randn((B, H, N, N), generator=g, device="cuda")
        got = _scan_grads(wk.wkv6, ins, do, dsT)
        want = _scan_grads(wk.wkv6_plain, ins, do, dsT)
        torch.cuda.synchronize()
        _check_close(f"wkv6 B={B} S={S} H={H} N={N} dec={dec} init={init} {dtype}", names,
                     got, want, WKV_TOL[dtype], worst, used, where, dtype)
        n += 1
    print(f"kernels: wkv6 forward and backward match wkv6_plain on {n} cases "
          f"(o, final state, dr, dk, dv, dw, du, d init_state; 1 at the slice shape); "
          f"max abs err fp32 {worst['float32']:.3g}, bf16 {worst['bfloat16']:.3g}; largest "
          f"share of an element's tolerance (tol + tol |plain|, tol fp32 {WKV_TOL['float32']}, "
          f"bf16 {WKV_TOL['bfloat16']}): fp32 {used['float32']:.3g} ({where['float32']}), "
          f"bf16 {used['bfloat16']:.3g} ({where['bfloat16']})",
          flush=True)

    B, S, H, N = (sl[x] for x in ("B", "S", "H", "N"))
    r, k, v, w, u, _ = _wkv_inputs(B, S, H, N, "bfloat16", None, False, seed=7)
    do = torch.randn(v.shape, device="cuda").to(v.dtype)
    with torch.no_grad():
        fwd_ms = _time_ms(lambda: wk.wkv6(r, k, v, w, u))
        plain_fwd_ms = _time_ms(lambda: wk.wkv6_plain(r, k, v, w, u), reps=5)
    leaves = [x.detach().requires_grad_() for x in (r, k, v, w, u)]
    o, _ = wk.wkv6(*leaves)
    bwd_ms = _time_ms(lambda: torch.autograd.grad(o, leaves, do, retain_graph=True))
    del o
    o, _ = wk.wkv6_plain(*leaves)
    plain_bwd_ms = _time_ms(lambda: torch.autograd.grad(o, leaves, do, retain_graph=True),
                            reps=5)
    del o, leaves
    torch.cuda.empty_cache()
    steps = B * S * H  # (b, t, h) recurrence steps
    elem = 2 * B * S * H * N  # bytes of one bf16 (B, S, H, N) tensor
    fwd_bytes = 5 * elem + 4 * H * N + 4 * B * H * N * N  # r k v w in, o out; u; final state
    bwd_bytes = 9 * elem + 2 * 4 * H * N  # r k v w do in, dr dk dv dw out; u, du
    fwd_ops = steps * (5 * N * N + 4 * N)  # readout 2N^2, decay+outer product 3N^2, bonus
    bwd_ops = steps * 14 * N * N  # state recompute 3, dr 2, G update 3, dk 2, dv 2, dw 2 (x N^2)
    records = []
    for name, ms, plain_ms, nbytes, ops in (
            ("wkv6_fwd", fwd_ms, plain_fwd_ms, fwd_bytes, fwd_ops),
            ("wkv6_bwd", bwd_ms, plain_bwd_ms, bwd_bytes, bwd_ops)):
        t_bytes, t_ops = nbytes / PEAK_BYTES, ops / FP32_PEAK
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        print(f"{name} B={B} S={S} H={H} N={N} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library none, bound {max(t_bytes, t_ops) * 1e3:.4f} ms ({bound_by}; "
              f"{ops / 1e9:.2f} GFLOP at fp32 {FP32_PEAK / 1e12:.0f} TFLOP/s = "
              f"{t_ops * 1e3:.4f} ms, {nbytes / 1e6:.1f} MB at 3.35 TB/s = "
              f"{t_bytes * 1e3:.4f} ms)", flush=True)
        records.append(dict(
            name=name, route="cuda", source="src/repro_torch/kernels/csrc/wkv6.cu",
            replaces="src/repro/kernels/wkv6.py:24", max_abs_err=max(worst.values()),
            max_abs_err_fp32=worst["float32"], max_abs_err_bf16=worst["bfloat16"],
            cases=n, ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by=bound_by, library_ms=None, shape=WKV_SLICE,
            **_rate(name, ops, ms, max(t_bytes, t_ops) * 1e3),
        ))
    return records


SSD_TOL = {"float32": 5e-4, "bfloat16": 2e-2}
SSD_SLICE = dict(B=4, S=4096, H=80, P=64, N=64)  # zamba2-2.7b training: 4 x 4096 tokens
SSD_SWEEP = dict(
    S=[1, 63, 128, 1000, 4096],
    PN=[(32, 16), (32, 32), (32, 64), (64, 32), (64, 64)],
    a_log=[-2.0, 0.0, 2.0],  # A = -exp(a_log) = -0.14, -1, -7.4 with dt = softplus(N(1, 1))
    init=[False, True],
    dtype=["float32", "bfloat16"],
)


def _ssd_inputs(B, S, H, P, N, dtype, a_log, init, seed):
    """x, Bm, Cm in ``dtype``, dt and A fp32, optional init state.
    ``a_log=None`` takes the model's formula at initialisation
    (``mamba2_apply``: dt = softplus(u wdt + 0) with u wdt about N(0, 1),
    A = -exp(0)); else dt = softplus(N(1, 1)), A = -exp(a_log + 0.1 noise)."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    dt_ = getattr(torch, dtype)
    x = (0.5 * mk(B, S, H, P)).to(dt_)
    if a_log is None:
        dt, A = F.softplus(mk(B, S, H)), -torch.ones(H, device="cuda")
    else:
        dt, A = F.softplus(mk(B, S, H) + 1.0), -torch.exp(a_log + 0.1 * mk(H))
    Bm, Cm = mk(B, S, N).to(dt_), mk(B, S, N).to(dt_)
    s0 = 0.5 * mk(B, H, P, N) if init else None
    return x, dt, A, Bm, Cm, s0


def phase_ssd(sweep=SSD_SWEEP):
    """Phase 3c: both SSD kernels against ``ssd_plain``, then their times at
    the slice shape."""
    import torch

    from repro_torch.kernels import ssd_scan as ss

    names = ["y", "final_state", "dx", "ddt", "dA", "dBm", "dCm", "d_init_state"]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    used = {"float32": 0.0, "bfloat16": 0.0}
    where = {"float32": "", "bfloat16": ""}
    n = 0
    sl = SSD_SLICE
    main_path = [(sl["B"], sl["S"], sl["H"], sl["P"], sl["N"], None, False, "bfloat16")]
    cases = [(2, S, 4, P, N, a, init, dtype)
             for S, (P, N), a, init, dtype in itertools.product(*sweep.values())]
    for B, S, H, P, N, a_log, init, dtype in main_path + cases:
        ins = _ssd_inputs(B, S, H, P, N, dtype, a_log, init, seed=300 + n)
        g = torch.Generator(device="cuda").manual_seed(n)
        dy = torch.randn(ins[0].shape, generator=g, device="cuda").to(ins[0].dtype)
        dsT = None if a_log is None else torch.randn((B, H, P, N), generator=g, device="cuda")
        got = _scan_grads(ss.ssd, ins, dy, dsT)
        want = _scan_grads(ss.ssd_plain, ins, dy, dsT)
        torch.cuda.synchronize()
        _check_close(f"B={B} S={S} H={H} P={P} N={N} a_log={a_log} init={init} {dtype}",
                     names, got, want, SSD_TOL[dtype], worst, used, where, dtype)
        n += 1
    print(f"kernels: ssd forward and backward match ssd_plain on {n} cases "
          f"(y, final state, dx, ddt, dA, dBm, dCm, d init_state; 1 at the slice shape); "
          f"max abs err fp32 {worst['float32']:.3g}, bf16 {worst['bfloat16']:.3g}; largest "
          f"share of an element's tolerance (tol + tol |plain|, tol fp32 {SSD_TOL['float32']}, "
          f"bf16 {SSD_TOL['bfloat16']}): fp32 {used['float32']:.3g} ({where['float32']}), "
          f"bf16 {used['bfloat16']:.3g} ({where['bfloat16']})", flush=True)

    B, S, H, P, N = (sl[x] for x in ("B", "S", "H", "P", "N"))
    x, dt, A, Bm, Cm, _ = _ssd_inputs(B, S, H, P, N, "bfloat16", None, False, seed=8)
    dy = torch.randn(x.shape, device="cuda").to(x.dtype)
    with torch.no_grad():
        fwd_ms = _time_ms(lambda: ss.ssd(x, dt, A, Bm, Cm))
        plain_fwd_ms = _time_ms(lambda: ss.ssd_plain(x, dt, A, Bm, Cm), reps=5)
    leaves = [t.detach().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    y, _ = ss.ssd(*leaves)
    bwd_ms = _time_ms(lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True))
    del y
    y, _ = ss.ssd_plain(*leaves)
    plain_bwd_ms = _time_ms(lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True),
                            reps=5)
    del y, leaves
    torch.cuda.empty_cache()
    L = 128  # the TPU kernel's chunk: its matmul form is the least work for the function
    fwd_ops = B * H * (S // L) * (2 * L * L * N + 2 * L * L * P + 4 * L * N * P)
    bwd_ops = 2 * fwd_ops  # two products per forward product
    big, small = 2 * B * S * H * P, 2 * B * S * N  # bytes of a bf16 x / Bm
    state = 4 * B * H * P * N
    fwd_bytes = 2 * big + 4 * B * S * H + 4 * H + 2 * small + state  # x, dt, A, Bm, Cm in; y, state out
    bwd_bytes = 3 * big + 8 * B * S * H + 8 * H + 4 * small  # x dy dx; dt ddt; A dA; Bm Cm dBm dCm
    records = []
    for name, ms, plain_ms, nbytes, ops in (
            ("ssd_fwd", fwd_ms, plain_fwd_ms, fwd_bytes, fwd_ops),
            ("ssd_bwd", bwd_ms, plain_bwd_ms, bwd_bytes, bwd_ops)):
        t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_FLOPS["bfloat16"]
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        print(f"{name} B={B} S={S} H={H} P={P} N={N} bf16: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library none, bound {max(t_bytes, t_ops) * 1e3:.4f} ms "
              f"({bound_by}; {ops / 1e9:.2f} GFLOP of the chunked form at 989 TFLOP/s = "
              f"{t_ops * 1e3:.4f} ms, {nbytes / 1e6:.1f} MB at 3.35 TB/s = "
              f"{t_bytes * 1e3:.4f} ms)", flush=True)
        records.append(dict(
            name=name, route="cuda", source="src/repro_torch/kernels/csrc/ssd_scan.cu",
            replaces="src/repro/kernels/ssd_scan.py:28", max_abs_err=max(worst.values()),
            max_abs_err_fp32=worst["float32"], max_abs_err_bf16=worst["bfloat16"],
            tol_share_fp32=used["float32"], tol_share_bf16=used["bfloat16"],
            cases=n, ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by=bound_by, library_ms=None, shape=SSD_SLICE,
            **_rate(name, ops, ms, max(t_bytes, t_ops) * 1e3),
        ))
    return records


FLASH_BWD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
FLASH_SLICE = dict(B=4, S=4096, H=32, KV=32, d=80, window=4096)  # zamba2 shared attention
FLASH_BWD_SWEEP = dict(
    heads=[(4, 4), (8, 2), (8, 1)],
    d=[32, 64, 80, 128],
    mask=[(True, 0), (True, 96), (False, 0)],
    S=[1, 17, 129, 200, 257, 1000],  # 129, 257: one past the 64- and 128-row tiles
    dtype=["float32", "bfloat16"],
)


def _attn_grads(fn, q, k, v, do, causal, window):
    import torch

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o = fn(*leaves, causal=causal, window=window)
    return [o.detach(), *torch.autograd.grad(o, leaves, do)]


def phase_flash_bwd(sweep=FLASH_BWD_SWEEP):
    """Phase 3d: the d=80 forward and its LSE at the slice shape, the
    backward kernels against autograd through ``flash_attention_plain``,
    then times at the slice shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    sl = FLASH_SLICE
    B, S, H, KV, d, W = (sl[x] for x in ("B", "S", "H", "KV", "d", "window"))
    q, k, v = _inputs(B, S, S, H, KV, d, "bfloat16", seed=77)
    with torch.no_grad():
        o, lse = fa._forward(q, k, v, True, W, want_lse=True)
        want_o, want_lse = fa.flash_attention_plain(q, k, v, causal=True, window=W,
                                                    return_lse=True)
    torch.cuda.synchronize()
    fwd_err = float((o.float() - want_o.float()).abs().max())
    lse_err = float((lse - want_lse).abs().max())
    print(f"flash forward d=80 at the slice shape B={B} S={S} H={H} KV={KV} window={W} "
          f"bf16: max abs err {fwd_err:.3g} (tol {TOL['bfloat16']}); row LSE max abs err "
          f"{lse_err:.3g}", flush=True)
    if not (fwd_err <= TOL["bfloat16"] and lse_err <= 1e-3):
        fail("flash forward at d=80 or its LSE disagrees with the plain version")
    del o, lse, want_o, want_lse

    names = ["o", "dq", "dk", "dv"]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    used = {"float32": 0.0, "bfloat16": 0.0}
    where = {"float32": "", "bfloat16": ""}
    n = 0
    main_path = [(B, (H, KV), d, (True, W), S, "bfloat16")]
    cases = [(2, *c) for c in itertools.product(*sweep.values())]
    for b, (h, kv), dd, (causal, window), s, dtype in main_path + cases:
        q, k, v = _inputs(b, s, s, h, kv, dd, dtype, seed=500 + n)
        do = torch.randn(q.shape, device="cuda").to(q.dtype)
        got = _attn_grads(fa.flash_attention, q, k, v, do, causal, window)
        want = _attn_grads(fa.flash_attention_plain, q, k, v, do, causal, window)
        torch.cuda.synchronize()
        _check_close(f"B={b} H={h} KV={kv} d={dd} S={s} causal={causal} window={window} "
                     f"{dtype}", names, got, want, FLASH_BWD_TOL[dtype], worst, used, where,
                     dtype, rel_to_max=dtype == "bfloat16")
        del got, want
        n += 1
    torch.cuda.empty_cache()
    print(f"kernels: flash backward matches autograd through flash_attention_plain on {n} "
          f"cases (o, dq, dk, dv; 1 at the slice shape); max abs err fp32 "
          f"{worst['float32']:.3g}, bf16 {worst['bfloat16']:.3g}; largest share of an "
          f"element's tolerance (fp32 tol + tol |plain|, tol {FLASH_BWD_TOL['float32']}; "
          f"bf16 tol (max|plain| + |plain|), tol {FLASH_BWD_TOL['bfloat16']}): fp32 "
          f"{used['float32']:.3g} ({where['float32']}), bf16 {used['bfloat16']:.3g} "
          f"({where['bfloat16']})", flush=True)

    q, k, v = _inputs(B, S, S, H, KV, d, "bfloat16", seed=78)
    do = torch.randn(q.shape, device="cuda").to(q.dtype)
    with torch.no_grad():
        fwd_ms = _time_ms(lambda: fa.flash_attention(q, k, v, causal=True, window=W))
        plain_fwd_ms = _time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True,
                                                                 window=W), reps=3)
        lib_fwd_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o = fa.flash_attention(*leaves, causal=True, window=W)
    bwd_ms = _time_ms(lambda: torch.autograd.grad(o, leaves, do, retain_graph=True))
    again = torch.autograd.grad(o, leaves, do, retain_graph=True)
    got = torch.autograd.grad(o, leaves, do)
    same = [torch.equal(a, b) for a, b in zip(again, got)]
    print(f"flash backward determinism at the slice shape: two calls give bit-identical "
          f"dq, dk, dv: {same}", flush=True)
    if not all(same):
        fail("flash backward is not deterministic: two calls differ")
    del o, again
    lt = [t.transpose(1, 2) for t in leaves]  # (B, heads, S, d) views
    o = F.scaled_dot_product_attention(*lt, is_causal=True)
    dot = do.transpose(1, 2)
    lib_bwd_ms = _time_ms(lambda: torch.autograd.grad(o, leaves, dot, retain_graph=True))
    lib = torch.autograd.grad(o, leaves, dot)
    lib_err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, lib))
    del o, got, lib
    torch.cuda.empty_cache()
    o = fa.flash_attention_plain(*leaves, causal=True, window=W)
    plain_bwd_ms = _time_ms(lambda: torch.autograd.grad(o, leaves, do, retain_graph=True),
                            reps=3, warmup=1)
    del o, leaves
    torch.cuda.empty_cache()
    pairs = S * (S + 1) // 2  # the 4096 window is no cut at S = 4096
    fwd_ops = 4 * B * H * d * pairs
    bwd_ops = 10 * B * H * d * pairs  # 5 products: S, dP, dV, dK, dQ (2.5x the forward)
    t_bytes = 2 * (q.numel() + k.numel() + v.numel())
    fwd_bytes = t_bytes + 2 * q.numel() + 4 * B * H * S  # o, lse out
    bwd_bytes = 2 * t_bytes + 4 * q.numel() + 4 * B * H * S  # q k v o dO in, dq dk dv out, lse
    records = []
    for name, ms, plain_ms, lib_ms, nbytes, ops in (
            ("flash_attention_d80", fwd_ms, plain_fwd_ms, lib_fwd_ms, fwd_bytes, fwd_ops),
            ("flash_attention_bwd", bwd_ms, plain_bwd_ms, lib_bwd_ms, bwd_bytes, bwd_ops)):
        t_b, t_o = nbytes / PEAK_BYTES, ops / PEAK_FLOPS["bfloat16"]
        bound_by = "operations" if t_o >= t_b else "bytes"
        print(f"{name} B={B} S={S} H={H} KV={KV} d={d} bf16 causal: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
              f"{max(t_b, t_o) * 1e3:.4f} ms ({bound_by}; {ops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB); {ops / (ms * 1e-3) / 1e12:.1f} TFLOP/s", flush=True)
        records.append(dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=max(t_b, t_o) * 1e3, bound_by=bound_by, shape=FLASH_SLICE,
                            **_rate(name, ops, ms, max(t_b, t_o) * 1e3)))
    print(f"flash backward vs sdpa backward at the slice shape: max abs err {lib_err:.3g}",
          flush=True)
    d80, bwd = records
    bwd.update(name="flash_attention_bwd", route="cuda",
               source="src/repro_torch/kernels/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention.py:29 (no TPU backward)",
               max_abs_err=max(worst.values()), max_abs_err_fp32=worst["float32"],
               max_abs_err_bf16=worst["bfloat16"], tol_share_fp32=used["float32"],
               tol_share_bf16=used["bfloat16"], cases=n, vs_sdpa_max_abs_err=lib_err,
               deterministic=all(same))
    d80.update(max_abs_err=fwd_err, lse_max_abs_err=lse_err)
    return d80, bwd


def phase_model(cfg):
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.api import get_model
    from repro_torch.serve.engine import serving_params

    cfg4 = dataclasses.replace(cfg, num_layers=4)
    api = get_model(cfg4)
    dev = torch.device("cuda")
    params = serving_params(api, api.init(torch.Generator(device=dev).manual_seed(1), dev), dev)
    tokens = torch.as_tensor(
        np.random.default_rng(11).integers(0, cfg.vocab_size, (1, 1000)), device=dev)
    fa.launches.update(fwd=0, bwd=0)
    via_kernel, _ = api.prefill(params, tokens, 1008)
    if fa.launches != {"fwd": cfg4.num_layers, "bwd": 0}:
        fail(f"4-layer prefill launched the kernel {fa.launches} times, "
             f"not {cfg4.num_layers} forward")
    kernel_attention = ops.attention
    ops.attention = lambda q, k, v, *, causal=True, window=0, softcap=0.0: (
        fa.flash_attention_plain(q, k, v, causal=causal, window=window))
    fa.launches.update(fwd=0, bwd=0)
    try:
        via_plain, _ = api.prefill(params, tokens, 1008)
    finally:
        ops.attention = kernel_attention
    if fa.launches != {"fwd": 0, "bwd": 0}:
        fail("the plain-attention prefill launched the kernel")
    a, b = via_kernel.float(), via_plain.float()
    diff, scale = float((a - b).abs().max()), float(b.abs().max())
    same = int(a.argmax()) == int(b.argmax())
    print(f"model: llama3-8b x4 layers, 1000-token prefill logits kernel vs plain: "
          f"max abs diff {diff:.4g} (bound {MODEL_RTOL} x max|logit| = "
          f"{MODEL_RTOL * scale:.4g}); argmax {int(a.argmax())} vs {int(b.argmax())}",
          flush=True)
    if not (torch.isfinite(a).all() and diff <= MODEL_RTOL * scale and same):
        fail("in-model kernel and plain prefill disagree")
    del params, via_kernel, via_plain
    torch.cuda.empty_cache()


def phase_slice(cfg, smi):
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.api import get_model
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.serve.scheduler import ContinuousScheduler
    from repro_torch.serve.trace import materialize_requests

    dev = torch.device("cuda")
    api = get_model(cfg)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
    eng = ContinuousBatchingEngine(cfg, params, lanes=4, n_pages=545, page_tokens=16,
                                   lane_capacity=2176, device=dev)
    del params
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"slice: {cfg.name} {cfg.num_layers} layers d_model {cfg.d_model} "
          f"{cfg.dtype}, {cfg.n_params() / 1e9:.2f} B params, set up in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    trace = slice_trace(cfg.vocab_size)
    reqs = materialize_requests(trace)
    torch.cuda.reset_peak_memory_stats()
    fa.launches.update(fwd=0, bwd=0)
    rep = ContinuousScheduler(eng).run(reqs)
    launches = fa.launches["fwd"]
    stats = eng.stats
    want = {r["id"]: r["max_new"] for r in trace.requests}
    got = {r.rid: len(r.tokens) for r in rep.completed}
    if got != want:
        fail(f"token counts {got} != budgets {want}")
    if eng.alloc.used_pages != 0:
        fail(f"{eng.alloc.used_pages} pages leaked")
    if fa.launches["bwd"] or launches != stats.prefills * cfg.num_layers:
        fail(f"kernel launches {launches} != prefills {stats.prefills} x "
             f"{cfg.num_layers} layers")
    vocab_ok = all(0 <= t < cfg.vocab_size for r in rep.completed for t in r.tokens)
    if not vocab_ok:
        fail("generated token outside the vocabulary")
    peak = torch.cuda.max_memory_allocated()
    prefill_ms = stats.prefill_s / stats.prefills * 1e3
    print(f"slice on {smi}: {len(rep.completed)} requests, prompts "
          f"{sorted(r.prompt_len for r in reqs)}, {rep.tokens_out()} tokens out; "
          f"prefill {prefill_ms:.2f} ms/request mean "
          f"({stats.prefills} prefills, {sum(r.prompt_len for r in reqs)} prompt tokens "
          f"in {stats.prefill_s:.3f} s); TTFT p50 {rep.ttft_percentile(50) * 1e3:.2f} ms "
          f"p99 {rep.ttft_percentile(99) * 1e3:.2f} ms; decode {stats.tokens_per_s:.2f} "
          f"tokens/s ({stats.decode_steps} steps, {stats.decode_tokens} tokens in "
          f"{stats.decode_s:.3f} s); kernel launches {launches}; "
          f"peak memory {peak / 2**30:.2f} GiB", flush=True)
    return launches, eng


TRAIN_MODEL_TOL = dict(loss=1e-2, grad=5e-2)  # relative loss; grads vs each leaf's max |g|
RWKV_TRAIN = dict(steps=8, batch=4, seq=4096)


def _wkv_counts():
    from repro_torch.kernels import wkv6 as wk

    return dict(wk.launches)


def phase_rwkv_model():
    """Phase 4b: rwkv6-1.6b at full width cut to 4 layers, one 2 x 1024
    batch: loss and every parameter gradient through the WKV kernels and
    through ``wkv6_plain`` agree; the kernels ran 2 x 4 times forward
    (remat recomputes each block) and 4 times backward."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models.api import get_model
    from repro_torch.models.layers import tree_leaves

    cfg = dataclasses.replace(get_config("rwkv6-1.6b"), num_layers=4)
    api = get_model(cfg)
    dev = torch.device("cuda")
    params = api.init(torch.Generator(device=dev).manual_seed(1), dev)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    toks = np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 1024))
    batch = {"tokens": torch.as_tensor(toks, device=dev),
             "labels": torch.as_tensor(np.roll(toks, -1, axis=1), device=dev)}

    def loss_and_grads():
        loss, _ = api.loss(params, batch)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    wk.launches.update(fwd=0, bwd=0)
    loss_k, grads_k = loss_and_grads()
    torch.cuda.synchronize()
    counts = _wkv_counts()
    want = {"fwd": 2 * cfg.num_layers, "bwd": cfg.num_layers}
    if counts != want:
        fail(f"4-layer train step launched the wkv6 kernels {counts} times, not {want}")
    kernel_wkv = ops.wkv
    ops.wkv = lambda r, k, v, w, u, init_state=None: wk.wkv6_plain(r, k, v, w, u, init_state)
    try:
        loss_p, grads_p = loss_and_grads()
    finally:
        ops.wkv = kernel_wkv
    if _wkv_counts() != want:
        fail("the plain-WKV train step launched a wkv6 kernel")
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    worst = max(float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))
                for a, b in zip(grads_k, grads_p))
    gnorm = float(torch.sqrt(sum(g.float().square().sum() for g in grads_k)))
    print(f"model: rwkv6-1.6b x4 layers, 2 x 1024 tokens, bf16: loss kernel {float(loss_k):.6f} "
          f"vs plain {float(loss_p):.6f} (rel diff {rel:.3g}, bound {TRAIN_MODEL_TOL['loss']}); "
          f"worst gradient leaf diff {worst:.3g} of its max |g| (bound {TRAIN_MODEL_TOL['grad']}) "
          f"over {len(leaves)} leaves; grad norm {gnorm:.4g}; wkv6 launches {counts}", flush=True)
    if not (rel <= TRAIN_MODEL_TOL["loss"] and worst <= TRAIN_MODEL_TOL["grad"]
            and np.isfinite(gnorm)):
        fail("in-model wkv6 kernel and plain train step disagree")
    del params, leaves, grads_k, grads_p
    torch.cuda.empty_cache()


def phase_rwkv_train(smi):
    """Phase 5b: rwkv6-1.6b at full width and depth trains 8 steps at
    4 x 4096 through ``train.loop.train``."""
    import torch

    from repro_torch.configs import TRAIN_4K, get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train.loop import TrainConfig, train

    cfg = get_config("rwkv6-1.6b")
    n = RWKV_TRAIN
    shape = dataclasses.replace(TRAIN_4K, seq_len=n["seq"], global_batch=n["batch"],
                                name="smoke")
    torch.cuda.reset_peak_memory_stats()
    fa.launches.update(fwd=0, bwd=0)
    wk.launches.update(fwd=0, bwd=0)
    rep = train(cfg, shape, TrainConfig(steps=n["steps"], seed=0, max_failures=0),
                device="cuda")
    counts, flash = _wkv_counts(), sum(fa.launches.values())
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_layers
    want = {"fwd": n["steps"] * L * 2, "bwd": n["steps"] * L}
    losses = rep.losses
    tokens = n["batch"] * n["seq"]
    step_s = float(np.median(rep.step_times))
    print(f"train slice on {smi}: {cfg.name} {L} layers d_model {cfg.d_model} "
          f"{cfg.param_dtype} params, {cfg.dtype} compute, "
          f"{cfg.n_params() / 1e9:.2f} B params; {n['steps']} steps of "
          f"{n['batch']} x {n['seq']} tokens; losses {[round(x, 4) for x in losses]}; "
          f"median step {step_s * 1e3:.1f} ms ({tokens / step_s:.0f} tokens/s); step times "
          f"{[round(t * 1e3, 1) for t in rep.step_times]} ms; peak memory "
          f"{peak / 2**30:.2f} GiB; wkv6 launches {counts}", flush=True)
    if rep.steps_done != n["steps"] or rep.restarts:
        fail(f"{rep.steps_done} steps done, {rep.restarts} restarts")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"losses not finite and falling: {losses}")
    if counts != want or flash:
        fail(f"wkv6 launches {counts} != {want} (flash launches {flash})")
    bad = [i for i, p in enumerate(tree_leaves(rep.state["params"]))
           if not bool(torch.isfinite(p).all())]
    if bad:
        fail(f"non-finite parameters after the last step: leaves {bad}")
    return counts, rep.state


def phase_rwkv_profile(state):
    """Phase 6b: one more training step of the slice under the profiler."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.api import get_model
    from repro_torch.optim.optimizer import make_optimizer
    from repro_torch.train.step import make_train_step

    cfg = get_config("rwkv6-1.6b")
    n = RWKV_TRAIN
    step = make_train_step(get_model(cfg), make_optimizer(cfg, total_steps=n["steps"]))
    data = SyntheticLMData(cfg, n["batch"], n["seq"], seed=0, start_step=n["steps"],
                           device="cuda")
    batch = next(data)
    data.close()
    _profile(f"train step {n['batch']} x {n['seq']}", lambda: step(state, batch), top=12)


# 20 steps: the reference's cosine schedule warms up for steps // 10 steps,
# none at 8, where the full-depth loss spikes and had not fallen by the
# last step (PERF.md); with 2 warmup steps it falls from step 11 on.
ZAMBA_TRAIN = dict(steps=20, batch=4, seq=4096)


def _counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss

    return {"ssd": dict(ss.launches), "flash": dict(fa.launches)}


def _reset_counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import wkv6 as wk

    for c in (ss.launches, fa.launches, wk.launches):
        c.update(fwd=0, bwd=0)


def phase_zamba_model():
    """Phase 4c: zamba2-2.7b at full width cut to 7 layers (the shared
    block runs at layers 0 and 6), one 2 x 1024 batch: loss and every
    parameter gradient through the kernels and through the plain versions
    agree; per-layer remat runs every kernel forward twice."""
    import torch

    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models.api import get_model
    from repro_torch.models.hybrid import n_shared_invocations
    from repro_torch.models.layers import tree_leaves

    cfg = dataclasses.replace(get_config("zamba2-2.7b"), num_layers=7)
    api = get_model(cfg)
    dev = torch.device("cuda")
    params = api.init(torch.Generator(device=dev).manual_seed(1), dev)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, (2, 1024))
    batch = {"tokens": torch.as_tensor(toks, device=dev),
             "labels": torch.as_tensor(np.roll(toks, -1, axis=1), device=dev)}

    def loss_and_grads():
        loss, _ = api.loss(params, batch)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    _reset_counts()
    loss_k, grads_k = loss_and_grads()
    torch.cuda.synchronize()
    counts = _counts()
    L, NS = cfg.num_layers, n_shared_invocations(cfg)
    want = {"ssd": {"fwd": 2 * L, "bwd": L}, "flash": {"fwd": 2 * NS, "bwd": NS}}
    if counts != want:
        fail(f"7-layer train step launched the kernels {counts} times, not {want}")
    kernel_ssd, kernel_attention = ops.ssd, ops.attention
    ops.ssd = lambda x, dt, A, Bm, Cm, init_state=None: ss.ssd_plain(x, dt, A, Bm, Cm,
                                                                      init_state)
    ops.attention = lambda q, k, v, *, causal=True, window=0, softcap=0.0: (
        fa.flash_attention_plain(q, k, v, causal=causal, window=window))
    try:
        loss_p, grads_p = loss_and_grads()
    finally:
        ops.ssd, ops.attention = kernel_ssd, kernel_attention
    if _counts() != want:
        fail("the plain-path train step launched a kernel")
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    diffs = [float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))
             for a, b in zip(grads_k, grads_p)]
    worst = max(diffs)
    worst_leaf = list(flatten(params))[diffs.index(worst)]  # flatten walks tree_leaves' order
    gnorm = float(torch.sqrt(sum(g.float().square().sum() for g in grads_k)))
    print(f"model: zamba2-2.7b x{L} layers ({NS} shared-block invocations), 2 x 1024 tokens, "
          f"bf16: loss kernel {float(loss_k):.6f} vs plain {float(loss_p):.6f} (rel diff "
          f"{rel:.3g}, bound {TRAIN_MODEL_TOL['loss']}); worst gradient leaf diff {worst:.3g} "
          f"of its max |g| ({worst_leaf}; bound {TRAIN_MODEL_TOL['grad']}) over {len(leaves)} "
          f"leaves; grad "
          f"norm {gnorm:.4g}; launches {counts}", flush=True)
    if not (rel <= TRAIN_MODEL_TOL["loss"] and worst <= TRAIN_MODEL_TOL["grad"]
            and np.isfinite(gnorm)):
        fail("in-model zamba2 kernels and plain train step disagree")
    del params, leaves, grads_k, grads_p
    torch.cuda.empty_cache()


def phase_zamba_train(smi):
    """Phase 5c: zamba2-2.7b at full width and depth trains 20 steps at
    4 x 4096 through ``train.loop.train``."""
    import torch

    from repro_torch.configs import TRAIN_4K, get_config
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models.hybrid import n_shared_invocations
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train.loop import TrainConfig, train

    cfg = get_config("zamba2-2.7b")
    n = ZAMBA_TRAIN
    shape = dataclasses.replace(TRAIN_4K, seq_len=n["seq"], global_batch=n["batch"],
                                name="smoke")
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    rep = train(cfg, shape, TrainConfig(steps=n["steps"], seed=0, max_failures=0),
                device="cuda")
    counts, wkv = _counts(), sum(wk.launches.values())
    peak = torch.cuda.max_memory_allocated()
    L, NS, steps = cfg.num_layers, n_shared_invocations(cfg), n["steps"]
    want = {"ssd": {"fwd": steps * 2 * L, "bwd": steps * L},
            "flash": {"fwd": steps * 2 * NS, "bwd": steps * NS}}
    losses = rep.losses
    tokens = n["batch"] * n["seq"]
    step_s = float(np.median(rep.step_times))
    print(f"train slice on {smi}: {cfg.name} {L} layers d_model {cfg.d_model} "
          f"{cfg.param_dtype} params, {cfg.dtype} compute, "
          f"{cfg.n_params() / 1e9:.2f} B params; {steps} steps of "
          f"{n['batch']} x {n['seq']} tokens; losses {[round(x, 4) for x in losses]}; "
          f"median step {step_s * 1e3:.1f} ms ({tokens / step_s:.0f} tokens/s); step times "
          f"{[round(t * 1e3, 1) for t in rep.step_times]} ms; peak memory "
          f"{peak / 2**30:.2f} GiB; launches {counts}", flush=True)
    if rep.steps_done != steps or rep.restarts:
        fail(f"{rep.steps_done} steps done, {rep.restarts} restarts")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"losses not finite and falling: {losses}")
    if counts != want or wkv:
        fail(f"launches {counts} != {want} (wkv6 launches {wkv})")
    bad = [i for i, p in enumerate(tree_leaves(rep.state["params"]))
           if not bool(torch.isfinite(p).all())]
    if bad:
        fail(f"non-finite parameters after the last step: leaves {bad}")
    return counts, rep.state


def phase_zamba_profile(state):
    """Phase 6c: one more training step of the zamba2 slice under the profiler."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.api import get_model
    from repro_torch.optim.optimizer import make_optimizer
    from repro_torch.train.step import make_train_step

    cfg = get_config("zamba2-2.7b")
    n = ZAMBA_TRAIN
    step = make_train_step(get_model(cfg), make_optimizer(cfg, total_steps=n["steps"]))
    data = SyntheticLMData(cfg, n["batch"], n["seq"], seed=0, start_step=n["steps"],
                           device="cuda")
    batch = next(data)
    data.close()
    _profile(f"zamba2 train step {n['batch']} x {n['seq']}", lambda: step(state, batch),
             top=14)


KERNEL_FAMILIES = {  # kernel-name substrings -> family, for the profiles' summary line
    "wkv6 kernels": ("wkv6_",),
    "ssd kernels": ("ssd_",),
    "flash kernels": ("flash_fwd", "flash_bwd"),
    "GEMM (cuBLAS)": ("nvjet", "gemm", "Gemm", "gemv"),
}


def _profile(label, fn, top=8):
    """Device time by kernel over ``fn()`` (torch.profiler/CUPTI), and the
    share of the wall time the device was busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = lambda e: getattr(e, "self_device_time_total", 0.0)  # microseconds
    cuda = torch.autograd.DeviceType.CUDA  # kernel rows, not the ops that launch them
    rows = [e for e in prof.key_averages() if e.device_type == cuda and dev(e) > 0]
    busy = sum(dev(e) for e in rows) * 1e-6
    if busy <= 0.0:
        fail(f"profile '{label}' recorded no device time")
    print(f"profile {label}: wall {wall * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms "
          f"({100 * busy / wall:.1f}%, idle {100 * (1 - busy / wall):.1f}%)")
    for e in sorted(rows, key=dev, reverse=True)[:top]:
        print(f"  {100 * dev(e) * 1e-6 / busy:5.1f}%  {dev(e) * 1e-3:9.3f} ms  "
              f"x{e.count:<5d} {e.key[:90]}")
    shares = {}
    for e in rows:
        fam = next((f for f, keys in KERNEL_FAMILIES.items() if any(k in e.key for k in keys)),
                   "other (elementwise, copies, reductions)")
        shares[fam] = shares.get(fam, 0.0) + dev(e) * 1e-6
    print("  by family: " + "; ".join(f"{f} {100 * t / busy:.1f}% ({t * 1e3:.2f} ms)"
                                      for f, t in sorted(shares.items(), key=lambda x: -x[1])))
    sys.stdout.flush()


def phase_profile(eng, cfg):
    """Where the slice's time goes: one 2048-token prefill, then 8 decode
    ticks with 4 live lanes, each under the profiler."""
    from repro_torch.serve.scheduler import Request

    eng.reset()
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (2048,)),
                    max_new_tokens=64) for i in range(4)]
    _profile("prefill 2048 tokens", lambda: eng.admit(reqs[0]))
    for r in reqs[1:]:
        eng.admit(r)
    _profile("decode 8 ticks x 4 lanes", lambda: [eng.step() for _ in range(8)])


def main() -> None:
    name, smi = phase_device()

    import torch

    from repro_torch.configs import get_config

    phase_build()
    cfg = get_config("llama3-8b")
    flash = phase_kernels([r["prompt_len"] for r in slice_trace(cfg.vocab_size).requests])
    wkv_fwd, wkv_bwd = phase_wkv6()
    ssd_fwd, ssd_bwd = phase_ssd()
    flash["d80"], flash_bwd = phase_flash_bwd()
    phase_model(cfg)
    serve_launches, eng = phase_slice(cfg, smi)
    phase_profile(eng, cfg)
    del eng
    torch.cuda.empty_cache()
    phase_rwkv_model()
    counts, state = phase_rwkv_train(smi)
    wkv_fwd["launches"], wkv_bwd["launches"] = counts["fwd"], counts["bwd"]
    phase_rwkv_profile(state)
    del state
    torch.cuda.empty_cache()
    phase_zamba_model()
    counts, state = phase_zamba_train(smi)
    phase_zamba_profile(state)
    del state
    torch.cuda.empty_cache()
    ssd_fwd["launches"], ssd_bwd["launches"] = counts["ssd"]["fwd"], counts["ssd"]["bwd"]
    flash_bwd["launches"] = counts["flash"]["bwd"]
    flash["launches_by_path"] = {"serve llama3-8b": serve_launches,
                                 "train zamba2-2.7b": counts["flash"]["fwd"]}
    flash["launches"] = sum(flash["launches_by_path"].values())
    print(f"card: {smi}")
    print(json.dumps({"kernels": [flash, flash_bwd, wkv_fwd, wkv_bwd, ssd_fwd, ssd_bwd]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
