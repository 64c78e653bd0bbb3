#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. device  — the card's name and power limit; TF32 off for fp32 products.
  2. build   — compile every CUDA source of ``src/repro_torch/kernels/csrc``.
  3. kernels — the flash-attention kernel against its plain PyTorch version
     at the slice's own prefill shapes (phase 5's prompt lengths), then over
     a sweep of head layouts, head dims, ragged lengths, windows and
     dtypes (tolerance fp32 2e-5, bf16 2e-2, absolute and relative, as
     ``tests/test_kernels.py``); then its time at the llama3-8b prefill
     shape beside the plain version, ``scaled_dot_product_attention`` (the
     library yardstick, never used by the port) and the card's bound.
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
The last line is ``{"ok": true, "device": {...}}``; the line before it
is the kernels' JSON record.  Imports ``torch``, ``numpy`` and
``repro_torch`` only.
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
    d=[32, 64, 128],
    S=[1, 17, 128, 200, 1000, 2048],
    window=[0, 96],
    dtype=["float32", "bfloat16"],
    causal=[True, False],
)
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


def phase_kernels(prompt_lens):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    worst = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    B, H, KV, d = (PREFILL[x] for x in ("B", "H", "KV", "d"))
    main_path = [(B, (H, KV), d, S, 0, "bfloat16", True) for S in prompt_lens]
    sweep = [(2, *c) for c in itertools.product(*SWEEP.values())]
    for b, (H, KV), d, S, window, dtype, causal in main_path + sweep:
        q, k, v = _inputs(b, S, S, H, KV, d, dtype, seed=n)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        tol = TOL[dtype]
        bad = ~(err <= tol + tol * want.float().abs())
        case = f"B={b} H={H} KV={KV} d={d} S={S} window={window} {dtype} causal={causal}"
        if bool(bad.any()) or not bool(torch.isfinite(got).all()):
            fail(f"kernel != plain at {case}: max abs err {float(err.max()):.3g}, "
                 f"{int(bad.sum())} elements beyond {tol}")
        worst[dtype] = max(worst[dtype], float(err.max()))
        n += 1
    print(f"kernels: flash_attention matches its plain version on {n} cases "
          f"({len(main_path)} at the slice's prompt lengths {sorted(prompt_lens)}); max abs err fp32 {worst['float32']:.3g} (tol {TOL['float32']}), "
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
    return dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:29",
        max_abs_err=max(worst.values()), max_abs_err_fp32=worst["float32"],
        max_abs_err_bf16=worst["bfloat16"], cases=n,
        ms=kernel_ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=bound_s * 1e3, bound_by=bound_by, library_ms=library_ms,
        shape=PREFILL,
    )


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
    before = fa.launches
    via_kernel, _ = api.prefill(params, tokens, 1008)
    if fa.launches - before != cfg4.num_layers:
        fail(f"4-layer prefill launched the kernel {fa.launches - before} times, "
             f"not {cfg4.num_layers}")
    kernel_attention = ops.attention
    ops.attention = lambda q, k, v, *, causal=True, window=0, softcap=0.0: (
        fa.flash_attention_plain(q, k, v, causal=causal, window=window))
    before = fa.launches
    try:
        via_plain, _ = api.prefill(params, tokens, 1008)
    finally:
        ops.attention = kernel_attention
    if fa.launches != before:
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
    fa.launches = 0
    rep = ContinuousScheduler(eng).run(reqs)
    launches = fa.launches
    stats = eng.stats
    want = {r["id"]: r["max_new"] for r in trace.requests}
    got = {r.rid: len(r.tokens) for r in rep.completed}
    if got != want:
        fail(f"token counts {got} != budgets {want}")
    if eng.alloc.used_pages != 0:
        fail(f"{eng.alloc.used_pages} pages leaked")
    if launches != stats.prefills * cfg.num_layers:
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
    record = phase_kernels([r["prompt_len"] for r in slice_trace(cfg.vocab_size).requests])
    phase_model(cfg)
    record["launches"], eng = phase_slice(cfg, smi)
    phase_profile(eng, cfg)
    print(f"card: {smi}")
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
