#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. device  — the card's name and power limit; TF32 off for fp32 products.
  2. build   — compile every CUDA source of ``src/repro_torch/kernels/csrc``.
  2b. plan   — the burst-parallel planner stack: ``calibrate_kinds`` on the
     card (the per-kind ratios) and one empty launch timed with CUDA
     events (``costmodel.H100.kernel_overhead``); plans of llama3-8b and
     qwen2-1.5b (``TRAIN_4K``) on ``H100`` at 8, 64 and 256 devices: the
     unconstrained burst plan never slower than data parallel, the amp
     limit held, the static verifier clean; the quickstart's 256-device
     plan and collocation simulation.
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
  3b. wkv6 — which kernels each route runs (from the profiler: bf16 the
     chunked kernels ``wkv6_chunk_*``/``wkv6_state_pass_kernel``, fp32 the
     recurrence ``wkv6_fwd_kernel``/``wkv6_bwd_*``); then the WKV-6
     forward and backward kernels against ``wkv6_plain``: first at the
     slice's shape (B=4, S=4096, 32 heads of 64, bf16, decays from the
     model's formula), then over S (the bf16 kernels' 16-step sub-chunk
     and 64-step chunk, one short of and one past each), head size, decay
     strength (down to below the 1e-6 clip), init state and dtype; o,
     final state and every gradient (tolerance fp32 5e-4, bf16 2e-2,
     absolute and relative; the largest share of it printed for each
     output); two backward calls at the slice shape must give
     bit-identical gradients; then both kernels' times at the slice shape
     beside the plain version and the card's bound (no library call
     computes WKV-6).
  4b. model  — rwkv6-1.6b at full width cut to 4 layers: loss and every
     parameter gradient of one 2 x 1024 batch through the kernels and
     through ``wkv6_plain`` agree; exact launch counts.
  5b. slice  — rwkv6-1.6b at full width and depth (24 layers, fp32 params,
     bf16 compute, AdamW, per-layer remat) trains 8 steps at 4 x 4096
     through ``train.loop.train``: finite, falling loss; 2 forward and 1
     backward kernel launch per layer and step; finite parameters.
  6b. profile — one more training step under the profiler; lists the
     WKV-6 kernels it ran and fails unless the chunked ones ran (and no
     recurrence kernel).
Slice 3, training zamba2-2.7b (3c and 3d run after 3b; 4c-6c after 6b,
once the rwkv6 state is freed):
  3c. ssd — which kernels each route runs (from the profiler: bf16 the
     chunked tensor-core kernels, fp32 the recurrence); then the SSD-scan
     forward and backward kernels against ``ssd_plain``: first at the
     slice's shape (B=4, S=4096, 80 heads of 64, state 64, bf16, dt and A
     from the model's formula at initialisation), then over S (with the
     bf16 kernels' 64-step chunk, one past it, and one short of and one
     past two chunks), P, N, decay strength, init state and dtype; y,
     final state and every gradient (tolerance fp32 5e-4, bf16 2e-2,
     absolute and relative; the largest share of it printed for each
     output); two backward calls at the slice shape must give
     bit-identical gradients; then both kernels' times at the slice shape
     beside the plain version and the card's bound (no library call
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
  6c. profile — one more training step under the profiler; lists the SSD
     kernels it ran and fails unless the chunked ones ran (and no
     recurrence kernel).
Slice 4, the quickstart and training qwen2-1.5b (the ``attn_mlp`` family;
3e after 3d, 4q-6q after 6c, 7 last):
  3e. flash at the qwen2 shape — forward and backward times at B=4,
     S=4096, 12 query heads over 2 KV heads of 128 (a group of 6),
     causal, bf16, beside the plain version, ``scaled_dot_product_attention``
     (autograd through it for the backward) and the card's bound; two
     backward calls bit-identical.  Phases 3 and 3d sweep the (12, 2)
     head layout too.
  4q. model — qwen2-1.5b at full width cut to 4 layers: loss and every
     parameter gradient of one 2 x 1024 batch through the flash kernels
     and through ``flash_attention_plain`` agree; exact launch counts.
  5q. slice — qwen2-1.5b at full width and depth (28 layers, d_model
     1536, 12 heads over 2 KV heads of 128, d_ff 8960, vocab 151936, QKV
     bias, tied embeddings; fp32 params, bf16 compute, AdamW on the cosine
     schedule, per-layer remat) trains 20 steps at 4 x 4096 through
     ``train.loop.train``: finite, falling loss; flash launches 56 forward
     and 28 backward per step; peak memory under 80 GB; median step,
     tokens/s.
  6q. profile — one more training step under the profiler; fails unless
     ``flash_fwd_sm90<128>`` and both ``flash_bwd_*_sm90`` kernels ran.
  7. quickstart — ``repro_torch.launch.quickstart.main(["--arch",
     "llama3-8b"])`` on the card: plan, gaps, collocation, then 10 steps
     of reduced llama3-8b; every loss finite, the last below the first.
Slice 5, executable gap multiplexing (after 7; phases 3 and 3d also hold
the flash kernels at the background tenants' shapes):
  8a. tenants — ``launch/train.py``'s two --bg-arch tenants (reduced
     qwen2-1.5b and minicpm-2b, 2 x 32 tokens, each on the card on a stream
     of its own of the least priority) alone, 20 steps each: finite,
     falling losses; their flash shapes among phase 3's and 3d's cases.
  8b. multiplexed training — qwen2-1.5b at full width and depth (phase
     5q's recipe) at 1 x 4096, 12 steps through ``train.loop.train``:
     isolated twice, then with both tenants round-robin under three
     settings (naive: ``use_priorities=False, max_inflight=64``;
     priorities: ``True, 64``; priorities and pacing: ``True, 2``).  Fails
     if a collocated foreground loss differs from the isolated run's by
     more than the two isolated runs differ, if ``bg_steps`` is not steps x
     ``max_inflight``, if tenant losses are not finite and falling, if a
     stream's priority is not the setting's, or if
     ``torch.cuda.synchronize`` runs during a collocated run (it is
     swapped for a function that fails).  Prints each setting's median
     foreground step and slowdown against the slower isolated run, tenant
     steps/s, the device's busy share over one profiled collocated step
     (union of kernel intervals) and the kernel time that overlapped, peak
     memory, beside the paper's A100 inflations (1.9, 1.8, 1.25).
  8c. run_executable — ``launch/multiplex_demo.py``'s ``main`` on the card
     (VGG-16's plan on 8 positions, all the card), then
     ``ClusterCoordinator.collocate(executable=True)`` on the same plan
     with feedback off: each tenant launches ``schedule_tenants()``'s steps
     every iteration, no 'fallback' event, and ``predict()`` after
     ``calibrate([res])`` gives the measured steps per iteration exactly.
  8d. admission — phase 5's trace once more through
     ``ContinuousScheduler(admission=ServingAdmission(...))`` with phase
     5's prefill and decode-step times and a TTFT SLO of 1.5x the prefill:
     every request gets its budget, no page leaks; ``admission_deferrals``.
Slice 6, the MoE family, the logit softcap, Adafactor and recurrent
serving (after 8d; weights of the served models drawn straight into bf16
on the card, ``ModelAPI.init(..., dtype=)``):
  9a. softcap — the capped flash kernels, forward and backward, both
     routes, against autograd through ``flash_attention_plain(softcap=)``:
     caps 30 and 5, S in {1, 64, 129, 1000, 2048}, causal / window 96 /
     non-causal with Sq != Skv, heads 48/8 and 32/4, every d_head, both
     dtypes (``TOL`` for the forward, ``FLASH_BWD_TOL`` for o, dq, dk, dv);
     then forward and backward times at grok-1's shape (1 x 4096, 48/8
     heads of 128, causal, cap 30) beside the same kernels without the cap,
     the plain version, the bound and the library call (``flex_attention``
     compiled with the tanh score_mod and a causal block mask); two
     backward calls bit-identical.
  9b. moe model — qwen3-moe-30b-a3b at full width cut to 4 layers: a
     1000-token prefill through the flash kernel (32 over 4 heads of 128)
     against the plain attention path (``MODEL_RTOL``, same argmax; 4
     forward launches).
  9c. moe slice — qwen3-moe-30b-a3b at full width and depth (48 layers,
     30.53 B params) serves phase 5's trace on 4 lanes of 2176 tokens and
     545 16-token pages: token counts equal budgets, no page leaks, one
     forward launch per prefill and layer, tokens in the vocabulary, peak
     memory below 79 GiB; device time by kernel over a 2048-token prefill
     and 8 decode ticks of 4 lanes; then ``ServingEngine.generate`` on 4 x
     512 prompts and 32 new tokens (finite prefill logits, token counts).
  9d. grok — grok-1-314b at full width cut to 4 layers (softcap 30): the
     9b check through the capped kernel, then ``ServingEngine.generate`` on
     2 x 256 prompts and 16 new tokens.
  9e. recurrent serving — rwkv6-1.6b and zamba2-2.7b at full width and
     depth through ``ServingEngine``: 4 x 256 prompts fed token by token,
     32 new tokens; the last prefill logits against ``forward`` (the
     chunked WKV-6 / SSD kernels and flash at d=80, which must launch).
  9f. big train — qwen3-moe-30b-a3b (AdamW) and qwen2-72b (Adafactor) at
     full width cut to 2 layers, 20 steps of 1 x 4096 through
     ``train.loop.train``: finite, falling losses, flash launches per step
     and layer; one profiled step each, which must run
     ``flash_fwd_sm90<128>`` and both ``flash_bwd_*_sm90``; ``moe_aux``
     finite (and zero for the dense model); then two Adafactor updates of
     qwen2-72b's largest leaves at full width against an fp64 plain update
     (``ADAFACTOR_TOL``).
Slice 7, the encoder-decoder family, pixtral's vision prefix and VGG-16
(after 9f; phases 3 and 3d also sweep non-causal Sq != Skv with Skv = 4 Sq
and Skv = 4096, Sq in {1, 17, 129, 1024}, every d, 16/16 heads among the
layouts, both dtypes, and hold every flash shape of 10b-10f):
  10a. flash at seamless's shapes — forward and backward times at its
     encoder shape (B=4, S=4096, 16 heads of 64, not causal) and its
     cross-attention shape (1024 queries over 4096 frames) beside the plain
     version, ``scaled_dot_product_attention`` (autograd through it for
     the backward) and the bound (no causal halving), each held against
     autograd through the plain version; two backward calls bit-identical.
  10b. seamless model — seamless-m4t-large-v2 at full width cut to 4
     encoder and 4 decoder layers: loss and every parameter gradient of 2 x
     1024 frames and 2 x 256 decoder tokens through the kernels and
     through the plain version agree; exact launch counts.
  10c. seamless training — full width and depth (24 + 24 layers, 2.04 B
     params; fp32 params, bf16 compute, AdamW on the cosine schedule,
     per-block remat) trains 20 steps of 4 x 4096 frames and 4 x 1024
     decoder tokens through ``train.loop.train``: finite, falling loss,
     144 forward and 72 backward flash launches a step, peak memory under
     80 GB, median step, frames/s and decoder tokens/s; a profiled step
     must run ``flash_fwd_sm90<64>`` and both ``flash_bwd_*_sm90`` at
     d=64 and no fp32 flash kernel.
  10d. seamless served — full depth in bf16 through
     ``ServingEngine.generate``: 4 x 256 prompts token by token against the
     zero encoder memory, 32 new tokens (token counts, vocabulary; no
     flash launch: ``decode_attention`` is plain PyTorch); then a forward
     of 1 x 4096 frames and 1024 tokens: finite logits.
  10e. pixtral — at full width cut to 4 layers, prefill logits of 1024
     patches and 1000 tokens through the kernel and the plain path
     (``MODEL_RTOL``, same argmax); at full width and depth (12.27 B params
     drawn into bf16 on the card) ``prefill(..., patch_embeds=)`` of 4 x
     (1024 patches + 1024 tokens), profiled, against ``forward``'s last
     position, then 32 ``decode_step``s, then ``ServingEngine.generate`` on
     4 x 512 text prompts; peak memory below 79 GiB.
  10f. pixtral training — full width cut to 2 layers, 20 steps of 1 x 4096
     (1024 patches, 3072 tokens) through ``train.loop.train``: finite,
     falling loss; a profiled step runs the three ``sm90`` flash kernels
     at d=128.
  10g. VGG-16 — the paper's model at its global batch of 32 (224 x 224 x
     3, fp32, TF32 off): loss and gradients at batch 4 against the same
     module in fp64 on the card (``VGG_TOL``); 10 AdamW steps on one fixed
     batch: finite, falling loss, median forward+backward time, peak
     memory, beside the planner's predicted iteration time on one ``H100``
     (not enforced).
Slice 8, multi-device (after 10g; one card, so the mesh is (1, 1): a
one-rank NCCL group; several ranks run in the CPU tests on gloo):
  11a. mesh — ``init_process_group("nccl")`` over a ``HashStore`` and
     ``make_mesh(1, 1)``; qwen2-1.5b's rules and parameter specs on it
     (equal to an abstract (1, 1) mesh's) and on the abstract (16, 16) and
     (2, 16, 16) production meshes, with the divisibility guard's drops.
  11b. sharded training, the slice's main path — qwen2-1.5b at full width
     and depth (phase 5q's recipe) trains 8 steps of 4 x 4096 through
     ``train.loop.train(..., mesh=)`` (``jit_train_step``: parameters and
     AdamW state as DTensors, each layer gathered inside its remat
     function), then 8 through the plain step: losses bit-identical; 56
     forward and 28 backward flash launches a step; median step, tokens/s
     and peak memory of both.
  11c. every other family through the sharded step against the plain step
     (rwkv6-1.6b x4 layers, zamba2-2.7b x7, qwen3-moe-30b-a3b x2,
     seamless-m4t-large-v2 x2+2, pixtral-12b x2; full width, 3 steps of 1
     x 4096): losses bit-identical; the WKV-6, SSD and flash kernels launch;
     the first step apart from the median of the two after it.
  11d. PowerSGD — qwen2-1.5b at full width cut to 2 layers, 20 steps of 1
     x 4096 through ``make_train_step(grad_transform=)`` at rank 4: losses
     finite and falling; one ``compress_decompress`` of a step's gradients
     against an fp64 replica (``POWERSGD_TOL``); its time and
     ``compression_ratio``.
  11e. disaggregated serving — llama3-8b at full width and depth through
     ``ContinuousBatchingEngine(submeshes=split_mesh_for_serving(1, [card,
     card]))``: prefill and decode on streams of their own; phase 5's trace
     gives phase 5's tokens exactly; no page leaks; the median handoff.
  A ``slice8: {...}`` line (11a-11e's numbers) comes before ``slice7``.
  12a. live loop — qwen2-1.5b at full width and depth, 11b's 8 steps of 4 x
     4096, through ``train(..., mesh=)`` with the live control plane wired
     (``live_script``: a coordinator of 8 virtual devices, four phantoms
     that beat once, two ``KVStoreTransport`` ends over a ``TCPStore`` on
     localhost, the co-hosted ``CoordinatorLoop``, applied reconfiguration
     and continuous admission), once with the lease and once without it
     and with a fault at step 6: losses bit-identical to 11b's (the
     restarted pass included), the reference's event counts
     (``LIVE_EVENTS``), no re-carve, the heartbeat topic compacted; the
     median step minus 11b's.  A ``slice9: {...}`` line comes first.
Phase 3 sweeps d_head 80 too.  Every timed kernel prints its TFLOP/s (of
the function's own operation count) and its share of the bound (bound ms /
kernel ms), and its JSON record carries both.  The last line is ``{"ok":
true, "device": {...}}``; the line before it is the kernels' JSON record
(six kernels: flash forward and backward, WKV-6 forward and backward, SSD
forward and backward; the flash records carry their times at the
qwen2-1.5b shape under ``qwen2``, at grok-1's shape with the cap under
``softcap`` (with ``capless_ms``), at seamless's encoder and cross shapes
under ``seamless``, their launches by path, the multiplexed foreground,
the background tenants, the MoE paths and slice 7's paths among them, and
under ``checked_launches`` those of the 9a sweep; every record's
``launches_by_path`` has slice 8's sharded paths too); the line before that
is ``card: ...``, before it ``planning: {...}`` (the measured launch
overhead and kind ratios), and before that ``slice7: {...}`` (phases
10c-10g's end-to-end numbers).  Imports ``torch``, ``numpy``
and ``repro_torch`` only.
"""
from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import math
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
    heads=[(32, 8), (4, 4), (8, 1), (12, 2)],  # (12, 2): qwen2-1.5b's group of 6
    d=[32, 64, 80, 128],
    S=[1, 17, 128, 129, 200, 257, 1000, 2048],  # 129, 257: one past the 128-row tiles
    window=[0, 96],
    dtype=["float32", "bfloat16"],
    causal=[True, False],
)
CROSS_LENS = [(100, 300), (300, 100), (129, 1), (1, 257), (1000, 2048)]  # (Sq, Skv)
# seamless's cross-attention regime (phase 10a): non-causal, Skv = 4 Sq and
# Skv = 4096 (ENC_MEMORY), over every d, both dtypes and its own 16/16 heads
SEAMLESS_CROSS_LENS = sorted({(sq, skv) for sq in (1, 17, 129, 1024) for skv in (4 * sq, 4096)})
PREFILL = dict(B=1, S=2048, H=32, KV=8, d=128)  # llama3-8b prefill attention
QWEN_FLASH = dict(B=4, S=4096, H=12, KV=2, d=128, window=0)  # qwen2-1.5b training
QUICK_FLASH = dict(B=4, S=64, H=4, KV=1, d=32)  # the quickstart: reduced llama3-8b, 4 x 64
# the qwen2-1.5b foreground of phase 8b: phase 5q's recipe at the batch a card
# of a 256-card data-parallel train_4k job (256 x 4096) holds
MUX_TRAIN = dict(steps=12, batch=1, seq=4096)
MUX_FLASH = dict(QWEN_FLASH, B=MUX_TRAIN["batch"], S=MUX_TRAIN["seq"])


# every flash case phases 3 and 3d held against the plain version, as
# (B, Sq, Skv, H, KV, d, dtype, causal, window): the shapes the tenants of
# phases 8a-8c run must be among them
SWEPT_FWD, SWEPT_BWD = set(), set()
BG_ARCHS = ("qwen2-1.5b", "minicpm-2b")  # phase 8b's tenants, as launch/train.py --bg-arch


def tenant_flash_cases():
    """(B, S, H, KV, d, dtype) of the flash calls the background tenants
    make: ``launch/train.py``'s (``BG_PER_DEVICE_BATCH`` sequences of
    ``BG_SEQ`` per step on the card) and ``launch/multiplex_demo.py``'s
    (``TENANT_BATCH`` sequences of ``TENANT_SEQ`` per position of each gap
    chunk the demo's carving gives its roster)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.multiplex import BgTenant, Collocator, MultiplexConfig
    from repro_torch.launch import multiplex_demo as demo
    from repro_torch.launch.train import BG_PER_DEVICE_BATCH, BG_SEQ

    def case(arch, b, s):
        c = get_config(arch).reduced()
        return (b, s, c.num_heads, c.num_kv_heads, c.d_head, c.dtype)

    out = {case(arch, BG_PER_DEVICE_BATCH, BG_SEQ) for arch in BG_ARCHS}
    split = Collocator(demo.demo_plan(), MultiplexConfig(collocate_same_device=True),
                       tenants=[BgTenant(job, prio) for job, prio, _ in demo.ROSTER],
                       devices=[torch.device("cpu")] * 8).submeshes()
    for slots in split.bg_tenants.values():
        out |= {case(demo.TENANT_ARCH, demo.TENANT_BATCH * (e[0][1] - e[0][0]), demo.TENANT_SEQ)
                for e in slots if e is not None}
    return sorted(out)


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
            if any(w in line for w in ("registers", "spill", "error", "warning")):
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
    main_path += [(x["B"], (x["H"], x["KV"]), x["d"], (x["S"], x["S"]), 0, "bfloat16", True)
                  for x in (QWEN_FLASH, MUX_FLASH, QUICK_FLASH)]
    main_path += [(b, (h, kv), dd, (s, s), 0, dt, True) for b, s, h, kv, dd, dt in tenant_flash_cases()]
    main_path += [(b, hd, dd, lens, 0, "bfloat16", c) for b, hd, dd, lens, c in slice7_flash_cases()]
    sweep = [(2, hd, dd, (S, S), w, dt, c)
             for hd, dd, S, w, dt, c in itertools.product(*SWEEP.values())]
    cross = [(2, hd, dd, lens, 0, dt, False)  # non-causal, Sq != Skv
             for hd, dd, lens, dt in itertools.product(
                 SWEEP["heads"], SWEEP["d"], CROSS_LENS, SWEEP["dtype"])]
    cross += [(2, hd, dd, lens, 0, dt, False)
              for hd, dd, lens, dt in itertools.product(
                  SEAMLESS_CROSS_HEADS, SWEEP["d"], SEAMLESS_CROSS_LENS, SWEEP["dtype"])]
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
        SWEPT_FWD.add((b, Sq, Skv, H, KV, d, dtype, causal, window))
        n += 1
    print(f"kernels: flash_attention matches its plain version on {n} cases "
          f"({len(main_path)} on main paths: the serving slice's prompt lengths "
          f"{sorted(prompt_lens)}, qwen2-1.5b training at 4 x 4096 and "
          f"multiplexed at 1 x 4096, the quickstart, the background tenants of phases 8a-8c, "
          f"seamless's and pixtral's of phases 10b-10f; "
          f"{len(cross)} non-causal with Sq != Skv, seamless's Skv = 4 Sq and 4096 among them); max abs err fp32 {worst['float32']:.3g} (tol {TOL['float32']}), "
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
    # the bf16 kernels' chunk is 64 and their sub-chunk 16
    S=[1, 16, 17, 63, 64, 65, 100, 127, 128, 129, 1000, 4096],
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


def _check_close(label, names, got, want, tol, worst, used, where, dtype, rel_to_max=False,
                 by_name=None):
    """Fail unless every pair agrees within ``tol + tol |want|`` (plus
    ``tol max|want|`` when ``rel_to_max``); track the worst error and the
    largest share of an element's tolerance (also per output name and dtype
    in ``by_name`` when given)."""
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
        if by_name is not None:
            key = (name, dtype)
            by_name[key] = max(by_name.get(key, 0.0), share)
        if share > used[dtype]:
            used[dtype], where[dtype] = share, f"{name} at {label}"


WKV_CHUNKED = ("wkv6_chunk_state_kernel", "wkv6_state_pass_kernel", "wkv6_chunk_out_kernel",
               "wkv6_chunk_dv_kernel", "wkv6_chunk_walk_kernel", "wkv6_chunk_du_kernel")
WKV_RECURRENCE = ("wkv6_fwd_kernel", "wkv6_bwd_rows_kernel", "wkv6_bwd_cols_kernel")


def _routes(prefix, fn, make_inputs, chunked, recurrence):
    """The CUDA kernels bf16 and fp32 calls of ``fn`` (forward and
    backward) launch, from the profiler: bf16 must run the chunked
    tensor-core kernels and no recurrence kernel, fp32 the reverse.  One
    call runs before the profiled window and two inside it (the profiler
    has dropped the window's first kernel, and once every kernel of a
    window: such an empty capture is taken again, up to three times)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def call(leaves):
        out, sT = fn(*leaves)
        torch.autograd.grad([out, sT], leaves, [torch.ones_like(out), torch.ones_like(sT)])

    for dtype, must, must_not in (("bfloat16", chunked, recurrence),
                                  ("float32", recurrence, chunked)):
        leaves = [t.detach().requires_grad_() for t in make_inputs(dtype)]
        call(leaves)
        torch.cuda.synchronize()
        for attempt in range(3):  # a capture that recorded no kernel at all is taken again
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call(leaves)
                call(leaves)
                torch.cuda.synchronize()
            ran = sorted({_kernel_name(e.key) for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and prefix in e.key})
            if ran:
                break
            print(f"{prefix} {dtype} route: the profiler recorded no {prefix} kernel "
                  f"(capture {attempt + 1} of 3)", flush=True)
        missing = [k for k in must if k not in ran]
        wrong = [k for k in must_not if k in ran]
        if missing or wrong:
            fail(f"{prefix} {dtype} route: kernels missing {missing}, unexpected {wrong}; "
                 f"ran {ran}")
        print(f"{prefix.rstrip('_')} {dtype} route runs: {', '.join(ran)}", flush=True)


def phase_wkv6(sweep=WKV_SWEEP):
    """Phase 3b: which kernels each route runs, then both WKV-6 kernels
    against ``wkv6_plain``, then their times at the slice shape."""
    import torch

    from repro_torch.kernels import wkv6 as wk

    _routes("wkv6_", wk.wkv6, lambda dt: _wkv_inputs(2, 200, 4, 64, dt, 0.0, True, seed=7),
            WKV_CHUNKED, WKV_RECURRENCE)
    names = ["o", "final_state", "dr", "dk", "dv", "dw", "du", "d_init_state"]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    used = {"float32": 0.0, "bfloat16": 0.0}  # largest share of an element's tolerance
    where = {"float32": "", "bfloat16": ""}
    by_name = {}
    n = 0
    sl = WKV_SLICE
    main_path = [(sl["B"], sl["S"], sl["H"], sl["N"], None, False, "bfloat16")]
    cases = [(2, S, 4, N, dec, init, dtype)
             for S, N, dec, init, dtype in itertools.product(*sweep.values())]
    for B, S, H, N, dec, init, dtype in main_path + cases:
        ins = _wkv_inputs(B, S, H, N, dtype, dec, init, seed=100 + n)
        g = torch.Generator(device="cuda").manual_seed(n)
        do = torch.randn(ins[2].shape, generator=g, device="cuda").to(ins[0].dtype)
        dsT = None if dec is None else torch.randn((B, H, N, N), generator=g, device="cuda")
        got = _scan_grads(wk.wkv6, ins, do, dsT)
        want = _scan_grads(wk.wkv6_plain, ins, do, dsT)
        torch.cuda.synchronize()
        _check_close(f"wkv6 B={B} S={S} H={H} N={N} dec={dec} init={init} {dtype}", names,
                     got, want, WKV_TOL[dtype], worst, used, where, dtype, by_name=by_name)
        n += 1
    print(f"kernels: wkv6 forward and backward match wkv6_plain on {n} cases "
          f"(o, final state, dr, dk, dv, dw, du, d init_state; 1 at the slice shape); "
          f"max abs err fp32 {worst['float32']:.3g}, bf16 {worst['bfloat16']:.3g}; largest "
          f"share of an element's tolerance (tol + tol |plain|, tol fp32 {WKV_TOL['float32']}, "
          f"bf16 {WKV_TOL['bfloat16']}): fp32 {used['float32']:.3g} ({where['float32']}), "
          f"bf16 {used['bfloat16']:.3g} ({where['bfloat16']})",
          flush=True)
    shares = {dtype: {name: by_name[(name, dtype)] for name in names if (name, dtype) in by_name}
              for dtype in ("float32", "bfloat16")}
    for dtype, per in shares.items():
        print(f"  largest share of the tolerance by output, {dtype}: "
              + ", ".join(f"{k} {v:.3g}" for k, v in per.items()), flush=True)

    B, S, H, N = (sl[x] for x in ("B", "S", "H", "N"))
    r, k, v, w, u, _ = _wkv_inputs(B, S, H, N, "bfloat16", None, False, seed=7)
    do = torch.randn(v.shape, device="cuda").to(v.dtype)
    with torch.no_grad():
        fwd_ms = _time_ms(lambda: wk.wkv6(r, k, v, w, u))
        plain_fwd_ms = _time_ms(lambda: wk.wkv6_plain(r, k, v, w, u), reps=5)
    leaves = [x.detach().requires_grad_() for x in (r, k, v, w, u)]
    o, _ = wk.wkv6(*leaves)
    bwd_ms = _time_ms(lambda: torch.autograd.grad(o, leaves, do, retain_graph=True))
    first = torch.autograd.grad(o, leaves, do, retain_graph=True)
    second = torch.autograd.grad(o, leaves, do, retain_graph=True)
    same = [torch.equal(a, b) for a, b in zip(first, second)]
    print(f"wkv6 backward at the slice shape, two calls bit-identical: "
          + ", ".join(f"{k} {v}" for k, v in zip(("dr", "dk", "dv", "dw", "du"), same)),
          flush=True)
    if not all(same):
        fail("wkv6 backward is not deterministic at the slice shape")
    del o, first, second
    o, _ = wk.wkv6_plain(*leaves)
    plain_bwd_ms = _time_ms(lambda: torch.autograd.grad(o, leaves, do, retain_graph=True),
                            reps=5)
    del o, leaves
    torch.cuda.empty_cache()
    L = wk.KCHUNK
    blocks = B * H * (S // L)  # (chunk, head, b) blocks of the chunked form
    elem = 2 * B * S * H * N  # bytes of one bf16 (B, S, H, N) tensor
    fwd_bytes = 5 * elem + 4 * H * N + 4 * B * H * N * N  # r k v w in, o out; u; final state
    bwd_bytes = 9 * elem + 2 * 4 * H * N  # r k v w do in, dr dk dv dw out; u, du
    # the chunked form: forward own state, A, A v, rdec S_in; backward D,
    # A, A^T do, kdec G_out and the walk's dr, dk, dw products (x 2 L N^2 each)
    fwd_ops = blocks * (4 * L * N * N + 2 * L * L * N)
    bwd_ops = blocks * (10 * L * N * N + 2 * L * L * N)
    steps = B * S * H  # (b, t, h) steps of the fp32 route's recurrence
    rec_ops = {"wkv6_fwd": steps * (5 * N * N + 4 * N), "wkv6_bwd": steps * 14 * N * N}
    records = []
    for name, ms, plain_ms, nbytes, ops in (
            ("wkv6_fwd", fwd_ms, plain_fwd_ms, fwd_bytes, fwd_ops),
            ("wkv6_bwd", bwd_ms, plain_bwd_ms, bwd_bytes, bwd_ops)):
        t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_FLOPS["bfloat16"]
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        rec_ms = max(t_bytes, rec_ops[name] / FP32_PEAK) * 1e3
        print(f"{name} B={B} S={S} H={H} N={N} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library none, bound {max(t_bytes, t_ops) * 1e3:.4f} ms ({bound_by}; "
              f"{ops / 1e9:.2f} GFLOP of the chunked form at 989 TFLOP/s = "
              f"{t_ops * 1e3:.4f} ms, {nbytes / 1e6:.1f} MB at 3.35 TB/s = "
              f"{t_bytes * 1e3:.4f} ms; the fp32 recurrence's bound {rec_ms:.4f} ms, "
              f"{rec_ops[name] / 1e9:.2f} GFLOP at {FP32_PEAK / 1e12:.0f} TFLOP/s)", flush=True)
        records.append(dict(
            name=name, route="cuda", source="src/repro_torch/kernels/csrc/wkv6.cu",
            replaces="src/repro/kernels/wkv6.py:24", max_abs_err=max(worst.values()),
            max_abs_err_fp32=worst["float32"], max_abs_err_bf16=worst["bfloat16"],
            tol_share_fp32=used["float32"], tol_share_bf16=used["bfloat16"],
            tol_share_by_output=shares, deterministic=all(same),
            cases=n, ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by=bound_by, library_ms=None, shape=WKV_SLICE,
            **_rate(name, ops, ms, max(t_bytes, t_ops) * 1e3),
        ))
    return records


SSD_TOL = {"float32": 5e-4, "bfloat16": 2e-2}
SSD_SLICE = dict(B=4, S=4096, H=80, P=64, N=64)  # zamba2-2.7b training: 4 x 4096 tokens
SSD_SWEEP = dict(
    S=[1, 63, 64, 65, 127, 128, 129, 1000, 4096],  # the bf16 kernels' chunk is 64
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


def _kernel_name(key):
    """The kernel's own name in a profiler key (a demangled signature)."""
    import re

    found = re.findall(r"(\w+_kernel)\b", key)
    return found[-1] if found else key[:60]


SSD_CHUNKED = ("ssd_chunk_state_kernel", "ssd_state_pass_kernel", "ssd_chunk_out_kernel",
               "ssd_chunk_dstate_kernel", "ssd_chunk_bwd_kernel")
SSD_RECURRENCE = ("ssd_fwd_kernel", "ssd_bwd_kernel")


def phase_ssd(sweep=SSD_SWEEP):
    """Phase 3c: both SSD kernels against ``ssd_plain``, then their times at
    the slice shape."""
    import torch

    from repro_torch.kernels import ssd_scan as ss

    _routes("ssd_", ss.ssd, lambda dt: _ssd_inputs(2, 200, 4, 64, 64, dt, 0.0, True, seed=7),
            SSD_CHUNKED, SSD_RECURRENCE)
    names = ["y", "final_state", "dx", "ddt", "dA", "dBm", "dCm", "d_init_state"]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    used = {"float32": 0.0, "bfloat16": 0.0}
    where = {"float32": "", "bfloat16": ""}
    by_name = {}
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
                     names, got, want, SSD_TOL[dtype], worst, used, where, dtype,
                     by_name=by_name)
        n += 1
    print(f"kernels: ssd forward and backward match ssd_plain on {n} cases "
          f"(y, final state, dx, ddt, dA, dBm, dCm, d init_state; 1 at the slice shape); "
          f"max abs err fp32 {worst['float32']:.3g}, bf16 {worst['bfloat16']:.3g}; largest "
          f"share of an element's tolerance (tol + tol |plain|, tol fp32 {SSD_TOL['float32']}, "
          f"bf16 {SSD_TOL['bfloat16']}): fp32 {used['float32']:.3g} ({where['float32']}), "
          f"bf16 {used['bfloat16']:.3g} ({where['bfloat16']})", flush=True)
    shares = {dtype: {name: by_name[(name, dtype)] for name in names if (name, dtype) in by_name}
              for dtype in ("float32", "bfloat16")}
    for dtype, per in shares.items():
        print(f"  largest share of the tolerance by output, {dtype}: "
              + ", ".join(f"{k} {v:.3g}" for k, v in per.items()), flush=True)

    B, S, H, P, N = (sl[x] for x in ("B", "S", "H", "P", "N"))
    x, dt, A, Bm, Cm, _ = _ssd_inputs(B, S, H, P, N, "bfloat16", None, False, seed=8)
    dy = torch.randn(x.shape, device="cuda").to(x.dtype)
    with torch.no_grad():
        fwd_ms = _time_ms(lambda: ss.ssd(x, dt, A, Bm, Cm))
        plain_fwd_ms = _time_ms(lambda: ss.ssd_plain(x, dt, A, Bm, Cm), reps=5)
    leaves = [t.detach().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    y, _ = ss.ssd(*leaves)
    bwd_ms = _time_ms(lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True))
    first = torch.autograd.grad(y, leaves, dy, retain_graph=True)
    second = torch.autograd.grad(y, leaves, dy, retain_graph=True)
    same = [torch.equal(a, b) for a, b in zip(first, second)]
    print(f"ssd backward at the slice shape, two calls bit-identical: "
          + ", ".join(f"{k} {v}" for k, v in zip(("dx", "ddt", "dA", "dBm", "dCm"), same)),
          flush=True)
    if not all(same):
        fail("ssd backward is not deterministic at the slice shape")
    del y, first, second
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
            tol_share_by_output=shares, deterministic=all(same),
            cases=n, ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by=bound_by, library_ms=None, shape=SSD_SLICE,
            **_rate(name, ops, ms, max(t_bytes, t_ops) * 1e3),
        ))
    return records


FLASH_BWD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
FLASH_SLICE = dict(B=4, S=4096, H=32, KV=32, d=80, window=4096)  # zamba2 shared attention
FLASH_BWD_SWEEP = dict(
    heads=[(4, 4), (8, 2), (8, 1), (12, 2)],  # (12, 2): qwen2-1.5b's group of 6
    d=[32, 64, 80, 128],
    mask=[(True, 0), (True, 96), (False, 0)],
    S=[1, 17, 129, 200, 257, 1000],  # 129, 257: one past the 64- and 128-row tiles
    dtype=["float32", "bfloat16"],
)


# the backward sweep's head layouts (without the forward sweep's 32/8, as
# there) and seamless's own 16/16: phase 3 sweeps the same cross cases
SEAMLESS_CROSS_HEADS = FLASH_BWD_SWEEP["heads"] + [(16, 16)]
# non-causal Sq != Skv (seamless's cross-attention), swept beside FLASH_BWD_SWEEP
FLASH_BWD_CROSS = dict(heads=SEAMLESS_CROSS_HEADS, d=FLASH_BWD_SWEEP["d"],
                       lens=SEAMLESS_CROSS_LENS, dtype=FLASH_BWD_SWEEP["dtype"])


def slice7_flash_cases(grad=False):
    """(B, (H, KV), d, (Sq, Skv), causal) of the flash calls slice 7's
    paths make: seamless's encoder (non-causal), decoder (causal) and
    cross-attention (non-causal, Skv = the frames) in phases 10b-10d, and
    pixtral's prefills and training in 10e-10f.  ``grad``: only those
    whose backward runs too (training), less the two that phase 10a times
    and holds against the plain version itself."""
    from repro_torch.configs import get_config

    sm, px = get_config("seamless-m4t-large-v2"), get_config("pixtral-12b")
    out = []  # (case, backward runs)
    for b, frames, trains in ((SEAMLESS_CHECK["batch"], SEAMLESS_CHECK["frames"], True),
                              (SEAMLESS_TRAIN["batch"], SEAMLESS_TRAIN["seq"], True),
                              (1, SEAMLESS_SERVE["frames"], False)):
        hd, dec = (sm.num_heads, sm.num_kv_heads), frames // 4
        out += [((b, hd, sm.d_head, (frames, frames), False), trains),
                ((b, hd, sm.d_head, (dec, dec), True), trains),
                ((b, hd, sm.d_head, (dec, frames), False), trains)]
    hd = (px.num_heads, px.num_kv_heads)
    for b, s in ((1, PIXTRAL["patches"] + 1000), (PIXTRAL["batch"], 2 * PIXTRAL["patches"]),
                 (PIXTRAL["batch"], 512)):
        out.append(((b, hd, px.d_head, (s, s), True), False))
    out.append(((1, hd, px.d_head, (PIXTRAL_TRAIN["seq"],) * 2, True), True))
    if not grad:
        return [c for c, _ in out]
    timed = {(x["B"], (x["H"], x["KV"]), x["d"], (x["S"], x["Skv"]), x["causal"])
             for x in (SEAMLESS_ENC_FLASH, SEAMLESS_CROSS_FLASH)}
    return [c for c, trains in out if trains and c not in timed]


def _attn_grads(fn, q, k, v, do, causal, window):
    import torch

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o = fn(*leaves, causal=causal, window=window)
    return [o.detach(), *torch.autograd.grad(o, leaves, do)]


def _flex_softcap(S, softcap):
    """PyTorch's own capped causal attention: ``flex_attention`` compiled
    with the ``softcap * tanh(score / softcap)`` score_mod on the scaled
    scores and a causal block mask, GQA by ``enable_gqa``; (B, heads, S, d)
    in and out.  Timed beside the capped kernels as their library call;
    the port never calls it.  Inductor and Triton cache under ``build/``."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(ROOT, "build", sub))

    def score_mod(score, b, h, q_idx, kv_idx):
        return softcap * torch.tanh(score / softcap)

    mask = create_block_mask(lambda b, h, q_idx, kv_idx: q_idx >= kv_idx, None, None, S, S,
                             device="cuda")
    flex = torch.compile(flex_attention, dynamic=False)
    return lambda q, k, v: flex(q, k, v, score_mod=score_mod, block_mask=mask, enable_gqa=True)


def _flash_times(sl, seed, softcap=0.0):
    """Forward and backward times of the flash kernels at shape ``sl``
    (bf16; causal unless ``sl["causal"]`` is False; ``sl["Skv"]`` keys, S
    unless given; window ``sl["window"]``, logit cap ``softcap``) beside
    the plain version, the library call (``scaled_dot_product_attention``;
    with a cap, ``flex_attention`` with the tanh score_mod, and the same
    kernels without the cap too; autograd through it for the backward) and
    the card's bound; fails unless two backward calls give bit-identical
    dq, dk, dv and the output and gradients agree with autograd through
    ``flash_attention_plain`` (``FLASH_BWD_TOL``).  Returns ((fwd record,
    bwd record), the determinism flags, the backward's max abs err against
    the library's)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    B, S, H, KV, d, W = (sl[x] for x in ("B", "S", "H", "KV", "d", "window"))
    Skv, causal = sl.get("Skv", S), sl.get("causal", True)
    q, k, v = _inputs(B, S, Skv, H, KV, d, "bfloat16", seed=seed)
    do = torch.randn(q.shape, device="cuda").to(q.dtype)
    cap = dict(softcap=softcap)
    if softcap:
        if W:
            fail("the capped library call is causal only, without a window")
        library, lib_call = "flex_attention", _flex_softcap(S, softcap)
    else:
        gqa = dict(enable_gqa=True) if H != KV else {}
        library = "sdpa"

        def lib_call(q, k, v):
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal, **gqa)
    with torch.no_grad():
        fwd_ms = _time_ms(lambda: fa.flash_attention(q, k, v, causal=causal, window=W, **cap))
        plain_fwd_ms = _time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=causal,
                                                                 window=W, **cap), reps=3)
        if softcap:
            capless_fwd_ms = _time_ms(lambda: fa.flash_attention(q, k, v, causal=causal, window=W))
        lib_fwd_ms = _time_ms(lambda: lib_call(q.transpose(1, 2), k.transpose(1, 2),
                                               v.transpose(1, 2)))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o = fa.flash_attention(*leaves, causal=causal, window=W, **cap)
    bwd_ms = _time_ms(lambda: torch.autograd.grad(o, leaves, do, retain_graph=True))
    again = torch.autograd.grad(o, leaves, do, retain_graph=True)
    got = [o.detach(), *torch.autograd.grad(o, leaves, do)]
    same = [torch.equal(a, b) for a, b in zip(again, got[1:])]
    print(f"flash backward determinism at B={B} S={S} H={H} KV={KV} d={d} softcap={softcap}: "
          f"two calls give bit-identical dq, dk, dv: {same}", flush=True)
    if not all(same):
        fail("flash backward is not deterministic: two calls differ")
    del o, again
    if softcap:
        o = fa.flash_attention(*leaves, causal=causal, window=W)
        capless_bwd_ms = _time_ms(lambda: torch.autograd.grad(o, leaves, do, retain_graph=True))
        del o
    lt = [t.transpose(1, 2) for t in leaves]  # (B, heads, S, d) views
    o = lib_call(*lt)
    dot = do.transpose(1, 2)
    lib_bwd_ms = _time_ms(lambda: torch.autograd.grad(o, leaves, dot, retain_graph=True))
    lib = [o.detach().transpose(1, 2), *torch.autograd.grad(o, leaves, dot)]
    lib_fwd_err = float((got[0].float() - lib[0].float()).abs().max())
    lib_err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got[1:], lib[1:]))
    del o, lib, lt
    torch.cuda.empty_cache()
    o = fa.flash_attention_plain(*leaves, causal=causal, window=W, **cap)
    plain_bwd_ms = _time_ms(lambda: torch.autograd.grad(o, leaves, do, retain_graph=True),
                            reps=3, warmup=1)
    want = [o.detach(), *torch.autograd.grad(o, leaves, do)]
    del o, leaves
    # the timed kernels against the plain version on the same inputs, as the
    # sweep of phase 3d holds them
    worst, used = {"bfloat16": 0.0}, {"bfloat16": 0.0}
    _check_close(f"timed shape B={B} S={S} H={H} KV={KV} d={d} window={W} softcap={softcap} "
                 "bfloat16",
                 ["o", "dq", "dk", "dv"], got, want, FLASH_BWD_TOL["bfloat16"], worst, used,
                 {"bfloat16": ""}, "bfloat16", rel_to_max=True)
    print(f"flash forward and backward at B={B} S={S} H={H} KV={KV} d={d} softcap={softcap} "
          "match autograd "
          f"through flash_attention_plain: max abs err {worst['bfloat16']:.3g}, largest "
          f"share of an element's tolerance {used['bfloat16']:.3g} (bf16 tol (max|plain| + "
          f"|plain|), tol {FLASH_BWD_TOL['bfloat16']})", flush=True)
    del got, want
    torch.cuda.empty_cache()
    # live (query, key) pairs: all of them without the causal mask, else
    # those of causal attention, cut by the window
    pairs = (S * Skv if not causal else
             sum(min(i + 1, W) if W else i + 1 for i in range(S)))
    fwd_ops = 4 * B * H * d * pairs
    bwd_ops = 10 * B * H * d * pairs  # 5 products: S, dP, dV, dK, dQ (2.5x the forward)
    t_bytes = 2 * (q.numel() + k.numel() + v.numel())
    fwd_bytes = t_bytes + 2 * q.numel() + 4 * B * H * S  # o, lse out
    bwd_bytes = 2 * t_bytes + 4 * q.numel() + 4 * B * H * S  # q k v o dO in, dq dk dv out, lse
    records = []
    for name, ms, plain_ms, lib_ms, nbytes, ops in (
            ("flash_attention_fwd", fwd_ms, plain_fwd_ms, lib_fwd_ms, fwd_bytes, fwd_ops),
            ("flash_attention_bwd", bwd_ms, plain_bwd_ms, lib_bwd_ms, bwd_bytes, bwd_ops)):
        t_b, t_o = nbytes / PEAK_BYTES, ops / PEAK_FLOPS["bfloat16"]
        bound_by = "operations" if t_o >= t_b else "bytes"
        rec = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, library=library,
                   timed_shape_max_abs_err=worst["bfloat16"],
                   timed_shape_tol_share=used["bfloat16"],
                   bound_ms=max(t_b, t_o) * 1e3, bound_by=bound_by, shape=dict(sl))
        beside = f"{library} {lib_ms:.4f} ms"
        if softcap:  # the capless kernel beside it too, same bound
            rec.update(softcap=softcap,
                       capless_ms=capless_fwd_ms if name.endswith("fwd") else capless_bwd_ms)
            beside += f", same kernel without the cap {rec['capless_ms']:.4f} ms"
        print(f"{name} B={B} Sq={S} Skv={Skv} H={H} KV={KV} d={d} bf16 causal={causal} "
              f"softcap={softcap}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, {beside}, bound "
              f"{max(t_b, t_o) * 1e3:.4f} ms ({bound_by}; {ops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB); {ops / (ms * 1e-3) / 1e12:.1f} TFLOP/s", flush=True)
        records.append(dict(**rec, **_rate(f"{name} (B={B} Sq={S} Skv={Skv} H={H} KV={KV} "
                                           f"d={d} causal={causal} softcap={softcap})", ops, ms,
                                           max(t_b, t_o) * 1e3)))
    print(f"flash vs {library} at B={B} S={S} H={H} KV={KV} d={d} softcap={softcap}: forward "
          f"max abs err {lib_fwd_err:.3g}, backward {lib_err:.3g}", flush=True)
    return records, same, lib_err


def _fresh_thread_flash():
    """The bf16 flash kernels encode their TMA tensor maps with
    ``cuTensorMapEncodeTiled``, which needs a context current on the
    calling thread; a thread that has made no CUDA call yet (autograd's
    backward worker can be one) lacks it unless the kernels bind it.  Calls the forward from a new
    host thread and compares it with the plain version."""
    import threading

    import torch

    from repro_torch.kernels import flash_attention as fa

    q, k, v = _inputs(1, 130, 130, 12, 2, 128, "bfloat16", seed=5)
    out = {}

    def run():
        try:
            out["o"] = fa.flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()
        except Exception as e:  # reported below, on the main thread
            out["err"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "err" in out:
        fail(f"flash forward from a fresh host thread: {out['err']}")
    err = float((out["o"].float() - fa.flash_attention_plain(q, k, v).float()).abs().max())
    print(f"flash forward from a fresh host thread: max abs err {err:.3g}", flush=True)
    if not err <= TOL["bfloat16"]:
        fail("flash forward from a fresh host thread disagrees with the plain version")


def phase_flash_bwd(sweep=FLASH_BWD_SWEEP, cross=FLASH_BWD_CROSS):
    """Phase 3d: the d=80 forward and its LSE at the slice shape, the
    backward kernels against autograd through ``flash_attention_plain``
    (``sweep`` with Sq = Skv, then ``cross``: non-causal, Sq != Skv), then
    times at the slice shape."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    _fresh_thread_flash()
    sl = FLASH_SLICE
    B, S, H, KV, d, W = (sl[x] for x in ("B", "S", "H", "KV", "d", "window"))
    q, k, v = _inputs(B, S, S, H, KV, d, "bfloat16", seed=77)
    with torch.no_grad():
        o, lse = fa._forward(q, k, v, True, W, 0.0, want_lse=True)
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
    qs, mx = QUICK_FLASH, MUX_FLASH
    main_path = [(B, (H, KV), d, (True, W), S, "bfloat16"),
                 (mx["B"], (mx["H"], mx["KV"]), mx["d"], (True, 0), mx["S"], "bfloat16"),
                 (qs["B"], (qs["H"], qs["KV"]), qs["d"], (True, 0), qs["S"], "bfloat16")]
    main_path += [(b, (h, kv), dd, (True, 0), s, dt) for b, s, h, kv, dd, dt in tenant_flash_cases()]
    main_path += [(b, hd, dd, (c, 0), lens, "bfloat16")
                  for b, hd, dd, lens, c in slice7_flash_cases(grad=True)]
    cases = [(2, *c) for c in itertools.product(*sweep.values())]
    cases += [(2, hd, dd, (False, 0), lens, dt)
              for hd, dd, lens, dt in itertools.product(*cross.values())]
    for b, (h, kv), dd, (causal, window), s, dtype in main_path + cases:
        sq, skv = s if isinstance(s, tuple) else (s, s)
        q, k, v = _inputs(b, sq, skv, h, kv, dd, dtype, seed=500 + n)
        do = torch.randn(q.shape, device="cuda").to(q.dtype)
        got = _attn_grads(fa.flash_attention, q, k, v, do, causal, window)
        want = _attn_grads(fa.flash_attention_plain, q, k, v, do, causal, window)
        torch.cuda.synchronize()
        _check_close(f"B={b} H={h} KV={kv} d={dd} Sq={sq} Skv={skv} causal={causal} "
                     f"window={window} {dtype}", names, got, want, FLASH_BWD_TOL[dtype], worst,
                     used, where, dtype, rel_to_max=dtype == "bfloat16")
        del got, want
        SWEPT_BWD.add((b, sq, skv, h, kv, dd, dtype, causal, window))
        n += 1
    torch.cuda.empty_cache()
    print(f"kernels: flash backward matches autograd through flash_attention_plain on {n} "
          f"cases (o, dq, dk, dv; {len(main_path)} on main paths: zamba2's slice shape, "
          f"qwen2-1.5b multiplexed at 1 x 4096, the quickstart, the background tenants of "
          f"phases 8a-8c, the cut models of 10b and 10e; qwen2-1.5b's at 4 x 4096 in phase "
          f"3e, seamless's training shapes in 10a); "
          f"max abs err fp32 "
          f"{worst['float32']:.3g}, bf16 {worst['bfloat16']:.3g}; largest share of an "
          f"element's tolerance (fp32 tol + tol |plain|, tol {FLASH_BWD_TOL['float32']}; "
          f"bf16 tol (max|plain| + |plain|), tol {FLASH_BWD_TOL['bfloat16']}): fp32 "
          f"{used['float32']:.3g} ({where['float32']}), bf16 {used['bfloat16']:.3g} "
          f"({where['bfloat16']})", flush=True)

    (d80, bwd), same, lib_err = _flash_times(sl, seed=78)
    bwd.update(name="flash_attention_bwd", route="cuda",
               source="src/repro_torch/kernels/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention.py:29 (no TPU backward)",
               max_abs_err=max(worst.values()), max_abs_err_fp32=worst["float32"],
               max_abs_err_bf16=worst["bfloat16"], tol_share_fp32=used["float32"],
               tol_share_bf16=used["bfloat16"], cases=n, vs_sdpa_max_abs_err=lib_err,
               deterministic=all(same))
    d80.update(max_abs_err=fwd_err, lse_max_abs_err=lse_err)
    return d80, bwd


def phase_flash_qwen2():
    """Phase 3e: the flash forward and backward at the qwen2-1.5b training
    shape (B=4, S=4096, 12 query heads over 2 KV heads of 128, causal),
    timed and held against autograd through the plain version."""
    (fwd, bwd), same, lib_err = _flash_times(QWEN_FLASH, seed=79)
    bwd.update(deterministic=all(same), vs_sdpa_max_abs_err=lib_err)
    return fwd, bwd


PLAN_ARCHS = ("llama3-8b", "qwen2-1.5b")
PLAN_DEVICES = (8, 64, 256)


def phase_plan(smi):
    """Phase 2b: the burst-parallel planner stack on the card's own
    numbers: ``calibrate_kinds`` and one empty launch timed on the card,
    then plans of llama3-8b and qwen2-1.5b (``TRAIN_4K``) on ``H100`` at
    8, 64 and 256 devices, held to the invariants of
    ``tests/test_plan_regression.py`` (the unconstrained burst plan never
    loses to data parallelism; the amp limit holds, per layer within the
    planner's 10% soft bound) and to the static verifier, and the
    collocation simulation of the quickstart."""
    from repro_torch.analysis.verify import verify_plan
    from repro_torch.configs import TRAIN_4K, get_config
    from repro_torch.configs.vgg16 import CONFIG as VGG
    from repro_torch.core.coordinator import ClusterCoordinator, Job
    from repro_torch.core.costmodel import H100
    from repro_torch.core.multiplex import MultiplexConfig
    from repro_torch.core.planner import plan, plan_data_parallel
    from repro_torch.core.profiler import calibrate_kinds, measure_kernel_overhead
    from repro_torch.models.graph import build_lm_graph, build_vgg_graph

    probe = build_lm_graph(get_config("llama3-8b"), TRAIN_4K) + build_vgg_graph(VGG, 32)
    ratios = calibrate_kinds(probe, repeats=20, device="cuda")
    if min(ratios.values()) != 1.0 or not all(np.isfinite(list(ratios.values()))):
        fail(f"calibrate_kinds ratios {ratios}")
    overhead = measure_kernel_overhead("cuda")
    print(f"plan: calibrate_kinds on the card: "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(ratios.items()))
          + f"; one empty launch {overhead * 1e6:.3f} us (CUDA events, median of 200; "
          f"costmodel.H100.kernel_overhead {H100.kernel_overhead * 1e6:.3f} us) on {smi}",
          flush=True)
    t0 = time.perf_counter()
    for arch in PLAN_ARCHS:
        g = build_lm_graph(get_config(arch), TRAIN_4K)
        for G in PLAN_DEVICES:
            bp = plan(g, G, amp_limit=2.0, hw=H100)
            free = plan(g, G, amp_limit=1e9, hw=H100)
            dp = plan_data_parallel(g, G, hw=H100)
            bad = verify_plan(bp, pool_size=G)
            print(f"plan {arch} G={G}: {bp.summary().splitlines()[0]}; data parallel "
                  f"{dp.total_time * 1e3:.3f} ms, unconstrained {free.total_time * 1e3:.3f} ms",
                  flush=True)
            if not free.total_time <= dp.total_time * (1 + 1e-9):
                fail(f"{arch} G={G}: unconstrained burst plan slower than data parallel")
            if not (bp.amplification <= 2.0 + 1e-9
                    and all(l.amp <= 2.0 * 1.1 + 1e-9 for l in bp.layers)):
                fail(f"{arch} G={G}: amp limit broken ({bp.amplification})")
            if bad:
                fail(f"{arch} G={G}: plan fails verification: {[str(v) for v in bad]}")
    coord = ClusterCoordinator(256, H100)
    bp = coord.submit_foreground(
        Job("llama3-8b", "foreground", build_lm_graph(get_config("llama3-8b"), TRAIN_4K),
            amp_limit=2.0))
    res = coord.simulate_collocation(MultiplexConfig())
    print(f"plan: llama3-8b on 256 x H100\n{bp.summary()}\ncollocation: {res.row()}; "
          f"planning took {time.perf_counter() - t0:.2f} s on the host", flush=True)
    if not (np.isfinite(res.fg_slowdown) and res.fg_slowdown >= 1.0):
        fail(f"collocation simulation: {res.row()}")
    return dict(kernel_overhead_s=overhead, calibrate_kinds=ratios)


def phase_quickstart():
    """Phase 7: ``python -m repro_torch.launch.quickstart --arch llama3-8b``
    on the card: the plan and collocation lines, then 10 training steps
    of reduced llama3-8b; every loss finite and the last below the first."""
    from repro_torch.launch import quickstart

    _reset_counts()
    _, _, rep = quickstart.main(["--arch", "llama3-8b"])
    counts = _counts()["flash"]
    losses = rep.losses
    print(f"quickstart on the card: losses {[round(x, 4) for x in losses]}; flash launches "
          f"{counts}", flush=True)
    if not (rep.steps_done == 10 and np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"quickstart losses not finite and falling: {losses}")
    if not (counts["fwd"] and counts["bwd"]):
        fail(f"the quickstart's training steps did not run the flash kernels: {counts}")
    return counts


# -- slice 5: executable gap multiplexing (phases 8a-8d) ----------------------

MUX_SETTINGS = (  # (name, use_priorities, max_inflight): three existing MultiplexConfigs
    ("naive", False, 64),
    ("priorities", True, 64),
    ("priorities+pacing", True, 2),
)


class _FlashShapes:
    """Records the shape of every flash forward launch while active, as
    ``SWEPT_FWD``'s keys (every tenant forward has its backward)."""

    def __init__(self):
        self.seen = set()

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa

        self.fa, self.orig = fa, fa._forward

        def recording(q, k, v, causal, window, softcap, want_lse):
            self.seen.add((q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
                           q.shape[3], str(q.dtype).split(".")[-1], bool(causal), int(window)))
            return self.orig(q, k, v, causal, window, softcap, want_lse)

        fa._forward = recording
        return self

    def __exit__(self, *exc):
        self.fa._forward = self.orig

    def check_swept(self, label):
        missing_f = sorted(self.seen - SWEPT_FWD)
        missing_b = sorted(self.seen - SWEPT_BWD)
        print(f"{label}: flash shapes {sorted(self.seen)} (B, Sq, Skv, H, KV, d, dtype, "
              f"causal, window), all among phase 3's and 3d's cases: "
              f"{not missing_f and not missing_b}", flush=True)
        if not self.seen or missing_f or missing_b:
            fail(f"{label}: flash shapes not swept: forward {missing_f}, backward {missing_b}")


class _NoDeviceSync:
    """While active, ``torch.cuda.synchronize()`` and the port's
    ``_device.sync()`` fail: either waits for every stream, so a collocated
    run that called one would time the background into the foreground."""

    def __enter__(self):
        import torch

        from repro_torch import _device

        self.torch, self.orig_sync, self.orig_port = torch, torch.cuda.synchronize, _device.sync
        self.patched = [m for m in list(sys.modules.values())
                        if getattr(m, "__name__", "").startswith("repro_torch")
                        and getattr(m, "sync", None) is _device.sync]

        def refuse(*a, **k):
            raise AssertionError("torch.cuda.synchronize() called inside a collocated run")

        torch.cuda.synchronize = refuse
        for m in self.patched:
            m.sync = refuse
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize = self.orig_sync
        for m in self.patched:
            m.sync = self.orig_port


def _distinct_streams(label, streams):
    """Fails unless every live slice's stream is a stream of its own: none
    on the default stream, no CUDA stream handle shared by two."""
    import torch

    handles = [s.cuda_stream for s in streams]
    default = torch.cuda.default_stream().cuda_stream
    if len(set(handles)) != len(handles) or default in handles:
        fail(f"{label}: live slices share a stream or use the default one: handles "
             f"{handles} (default {default})")


class _IssuedStreams:
    """While active, records the stream on which ``run_executable`` issues
    every foreground stage call and tenant step (``core.multiplex._issue``);
    ``stage(make)`` wraps a stage factory so its stage fns are known as the
    foreground's."""

    def __init__(self):
        self.issued, self.fg = [], []  # (fn, stream); fg stage fns (held: ids stay unique)

    def stage(self, make):
        def wrapped(stage, mesh):
            fn = make(stage, mesh)
            self.fg.append(fn)
            return fn

        return wrapped

    def __enter__(self):
        from repro_torch.core import multiplex

        self.mod, self.orig = multiplex, multiplex._issue

        def recording(fn, stream):
            self.issued.append((fn, stream))
            return self.orig(fn, stream)

        multiplex._issue = recording
        return self

    def __exit__(self, *exc):
        self.mod._issue = self.orig

    def check(self, label, use_priorities):
        """One stream for every stage, one of its own for each tenant slice
        (a built step), none shared or default, priorities as the setting's."""
        import torch

        least, greatest = torch.cuda.Stream.priority_range()
        fg_ids = {id(f) for f in self.fg}
        fg = {s.cuda_stream: s for f, s in self.issued if id(f) in fg_ids}
        bg = {}
        for f, s in self.issued:
            if id(f) not in fg_ids:
                bg.setdefault(id(f), {})[s.cuda_stream] = s
        if len(fg) != 1 or any(len(v) != 1 for v in bg.values()):
            fail(f"{label}: {len(fg)} foreground streams, tenant slices on "
                 f"{sorted(len(v) for v in bg.values())} streams each (want 1 each)")
        fg_s = next(iter(fg.values()))
        bg_s = [next(iter(v.values())) for v in bg.values()]
        _distinct_streams(label, [fg_s] + bg_s)
        want_fg = greatest if use_priorities else least
        prios = sorted({s.priority for s in bg_s})
        print(f"{label}: {len(self.issued)} issues, the stages on one stream of priority "
              f"{fg_s.priority}, {len(bg_s)} tenant slices each on a stream of its own "
              f"(priorities {prios}; least {least}, greatest {greatest})", flush=True)
        if fg_s.priority != want_fg or prios != [least]:
            fail(f"{label}: stream priorities fg {fg_s.priority} (want {want_fg}), tenants "
                 f"{prios} (want {least})")


def _tenants():
    """``launch/train.py``'s two --bg-arch tenants (same-device: each on the
    card, on a stream of its own of the least priority), each wrapped to
    keep its losses and count its flash launches.  Returns (wrapped fns,
    their raw steps, loss lists, launch counter)."""
    from repro_torch.core.coordinator import ClusterCoordinator
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as cli

    import torch

    dev = torch.device("cuda", torch.cuda.current_device())
    raw = cli._register_bg_jobs(ClusterCoordinator(256), list(BG_ARCHS),
                                [None] * len(BG_ARCHS), dev)
    losses = [[] for _ in raw]
    launched = {"fwd": 0, "bwd": 0}

    def wrap(i, fn):
        def step():
            before = dict(fa.launches)
            loss = fn()
            for k in launched:
                launched[k] += fa.launches[k] - before[k]
            losses[i].append(loss)
            return loss

        return step

    return [wrap(i, fn) for i, fn in enumerate(raw)], raw, losses, launched


def _check_falling(label, losses):
    """Each tenant's losses (device scalars, read after the run) finite and
    falling; returns them as floats."""
    out = [[float(x) for x in ls] for ls in losses]
    for arch, ls in zip(BG_ARCHS, out):
        if not (ls and np.isfinite(ls).all() and ls[-1] < ls[0]):
            fail(f"{label}: tenant {arch} losses not finite and falling: {ls}")
    return out


def phase_bg_tenants():
    """Phase 8a: both tenants alone, 20 steps each on their own streams of
    the least priority: finite, falling losses, and flash shapes among the
    cases phases 3 and 3d held against the plain version."""
    import torch

    _reset_counts()
    with _FlashShapes() as shapes:
        fns, raw, losses, launched = _tenants()
        for _ in range(20):
            for fn in fns:
                fn()
        torch.cuda.synchronize()
    counts = _counts()["flash"]
    prio = [fn.mesh.stream.priority for fn in raw]
    least, greatest = torch.cuda.Stream.priority_range()
    out = _check_falling("8a", losses)
    print(f"8a tenants alone: " + "; ".join(
        f"{a} loss {ls[0]:.4f} -> {ls[-1]:.4f} over {len(ls)} steps" for a, ls in zip(BG_ARCHS, out))
        + f"; stream priorities {prio} (range least {least}, greatest {greatest}); flash "
        f"launches {counts}", flush=True)
    if any(p != least for p in prio):
        fail(f"8a: tenant streams have priorities {prio}, not the least ({least})")
    _distinct_streams("8a", [fn.mesh.stream for fn in raw])
    shapes.check_swept("8a")
    return counts


def _busy_union(prof):
    """(union of the device intervals of every kernel, their sum) in
    seconds: where streams overlap the sum exceeds the union."""
    import torch

    ivs = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.time_range.end > e.time_range.start)
    union, total, cur_s, cur_e = 0.0, 0.0, None, None
    for s_, e_ in ivs:
        total += e_ - s_
        if cur_e is None or s_ > cur_e:
            if cur_e is not None:
                union += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    if cur_e is not None:
        union += cur_e - cur_s
    return union * 1e-6, total * 1e-6


def _profile_collocated_step(cfg, state, tc, bg_fn=None):
    """One more foreground step with its background steps (none without
    ``bg_fn``), as the train loop issues them, under the profiler: wall
    time, the device's busy time (union of kernel intervals) and the
    kernel time summed over streams."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch._device import priority_stream
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.api import get_model
    from repro_torch.optim.optimizer import make_optimizer
    from repro_torch.train.step import make_train_step

    n = MUX_TRAIN
    step = make_train_step(get_model(cfg), make_optimizer(cfg, total_steps=n["steps"]))
    fg = priority_stream(torch.device("cuda", torch.cuda.current_device()),
                         urgent=tc.multiplex.use_priorities)
    fg.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(fg):
        data = SyntheticLMData(cfg, n["batch"], n["seq"], seed=0, start_step=n["steps"],
                               device="cuda")
        batch = next(data)
        data.close()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.cuda.stream(fg):
            _, metrics = step(state, batch)
            for _ in range(tc.multiplex.max_inflight if bg_fn else 0):
                bg_fn()
            float(metrics["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, total = _busy_union(prof)
    if busy <= 0.0:
        fail("the profiled collocated step recorded no device time")
    return wall, busy, total


def phase_multiplex_train(smi):
    """Phase 8b: qwen2-1.5b at full width and depth (phase 5q's recipe) at
    1 x 4096, 12 steps through ``train()``: isolated twice, then with both
    tenants round-robin (as ``launch/train.py --bg-arch``) under three
    settings.  Fails if a collocated foreground loss moves by more than the
    two isolated runs differ, if ``bg_steps`` is not steps x
    ``max_inflight``, if tenant losses are not finite and falling, if a
    stream's priority is not the setting's, or if anything calls
    ``torch.cuda.synchronize()`` while a collocated run is timed."""
    import torch

    from repro_torch.configs import TRAIN_4K, get_config
    from repro_torch.core.multiplex import InterferenceModel, MultiplexConfig
    from repro_torch.launch.train import round_robin
    from repro_torch.train.loop import TrainConfig, train

    cfg = get_config("qwen2-1.5b")
    n = MUX_TRAIN
    shape = dataclasses.replace(TRAIN_4K, seq_len=n["seq"], global_batch=n["batch"],
                                name="mux")
    L, steps = cfg.num_layers, n["steps"]
    fg_want = {"fwd": steps * 2 * L, "bwd": steps * L}
    least, greatest = torch.cuda.Stream.priority_range()
    shapes = _FlashShapes()  # the foreground's and the tenants' flash shapes
    iso = []
    for run in range(2):
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        with shapes:
            rep = train(cfg, shape, TrainConfig(steps=steps, seed=0, max_failures=0),
                        device="cuda")
        counts = _counts()["flash"]
        peak = torch.cuda.max_memory_allocated()
        iso.append(rep)
        print(f"8b isolated run {run + 1} on {smi}: {cfg.name} {n['batch']} x {n['seq']}, "
              f"median step {np.median(rep.step_times) * 1e3:.2f} ms; losses "
              f"{[round(x, 4) for x in rep.losses]}; peak {peak / 2**30:.2f} GiB; flash "
              f"launches {counts}", flush=True)
        if counts != fg_want or not np.isfinite(rep.losses).all():
            fail(f"8b isolated: flash launches {counts} != {fg_want} or losses not finite")
        if run:
            wall, busy, _ = _profile_collocated_step(cfg, rep.state, TrainConfig(steps=steps))
            print(f"8b isolated: one profiled step: wall {wall * 1e3:.2f} ms, device busy "
                  f"{busy * 1e3:.2f} ms ({100 * busy / wall:.1f}%)", flush=True)
        rep.state = None
        torch.cuda.empty_cache()
    spread = max(abs(a - b) for a, b in zip(iso[0].losses, iso[1].losses))
    iso_ms = max(float(np.median(r.step_times)) for r in iso) * 1e3
    im = InterferenceModel()
    rows, fg_total, bg_total = [], {"fwd": 0, "bwd": 0}, {"fwd": 0, "bwd": 0}
    for name, prio, inflight in MUX_SETTINGS:
        fns, raw, losses, launched = _tenants()
        rr = round_robin(fns)
        seen_fg, t_first, issue = [], [], [0.0]

        def bg_fn():
            t0 = time.perf_counter()
            if not seen_fg:
                seen_fg.append(torch.cuda.current_stream())  # the loop's foreground stream
                t_first.append(t0)
            out = rr()
            issue[0] += time.perf_counter() - t0
            return out

        tc = TrainConfig(steps=steps, seed=0, max_failures=0, bg_step_fn=bg_fn,
                         multiplex=MultiplexConfig(use_priorities=prio, max_inflight=inflight))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        with shapes, _NoDeviceSync():
            rep = train(cfg, shape, tc, device="cuda")
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        counts = _counts()["flash"]
        peak = torch.cuda.max_memory_allocated()
        bg_counts = dict(launched)
        fg_counts = {k: counts[k] - bg_counts[k] for k in counts}
        tenant_losses = _check_falling(f"8b {name}", losses)
        fg_stream, prios = seen_fg[0], [fn.mesh.stream.priority for fn in raw]
        want_fg = greatest if prio else least
        diff = max(abs(a - b) for a, b in zip(rep.losses, iso[0].losses))
        med_ms = float(np.median(rep.step_times)) * 1e3
        bg_rate = rep.bg_steps / (t_end - t_first[0])
        issue_ms = issue[0] / steps * 1e3  # host time issuing tenant steps, per fg step
        wall, busy, total = _profile_collocated_step(cfg, rep.state, tc, bg_fn)
        rep.state = None
        torch.cuda.empty_cache()
        paper = {"naive": im.naive_inflation, "priorities": im.priority_inflation,
                 "priorities+pacing": im.paced_inflation}[name]
        rows.append(dict(setting=name, use_priorities=prio, max_inflight=inflight,
                         fg_median_ms=med_ms, fg_slowdown=med_ms / iso_ms,
                         tenant_steps_per_s=bg_rate, bg_steps=rep.bg_steps,
                         tenant_issue_ms_per_fg_step=issue_ms,
                         busy_share=busy / wall, overlap_ms=(total - busy) * 1e3,
                         profiled_wall_ms=wall * 1e3, peak_gib=peak / 2**30,
                         paper_a100_inflation=paper, fg_loss_max_diff=diff,
                         stream_priorities={"fg": fg_stream.priority, "tenants": prios}))
        print(f"8b {name} (use_priorities={prio}, max_inflight={inflight}) on {smi}: fg median "
              f"step {med_ms:.2f} ms, slowdown {med_ms / iso_ms:.4f} against the slower "
              f"isolated run ({iso_ms:.2f} ms) [the paper's A100 figure for this setting: "
              f"{paper:.2f}x]; tenant steps {rep.bg_steps} at {bg_rate:.1f} steps/s, their "
              f"host issue {issue_ms:.2f} ms per fg step; one "
              f"profiled collocated step: wall {wall * 1e3:.2f} ms, device busy "
              f"{busy * 1e3:.2f} ms ({100 * busy / wall:.1f}%), kernel time overlapping "
              f"another stream's {(total - busy) * 1e3:.2f} ms; peak {peak / 2**30:.2f} GiB; "
              f"stream priorities fg {fg_stream.priority}, tenants {prios} (least {least}, "
              f"greatest {greatest}); fg losses max |diff| from isolated {diff:.3g} (isolated "
              f"runs differ by {spread:.3g}); tenant losses " + "; ".join(
                  f"{a} {ls[0]:.4f} -> {ls[-1]:.4f}" for a, ls in zip(BG_ARCHS, tenant_losses))
              + f"; flash launches fg {fg_counts}, tenants {bg_counts}", flush=True)
        if diff > spread:
            fail(f"8b {name}: foreground losses differ from the isolated run's by {diff:.3g}, "
                 f"more than the two isolated runs do ({spread:.3g}): a race between streams")
        if rep.bg_steps != steps * inflight:
            fail(f"8b {name}: bg_steps {rep.bg_steps} != {steps} x {inflight}")
        if fg_stream.priority != want_fg or fg_stream == torch.cuda.default_stream() \
                or any(p != least for p in prios):
            fail(f"8b {name}: stream priorities fg {fg_stream.priority} (want {want_fg}), "
                 f"tenants {prios} (want {least})")
        _distinct_streams(f"8b {name}", [fg_stream] + [fn.mesh.stream for fn in raw])
        if fg_counts != fg_want:
            fail(f"8b {name}: foreground flash launches {fg_counts} != {fg_want}")
        for k in fg_total:
            fg_total[k] += fg_counts[k]
            bg_total[k] += bg_counts[k]
    shapes.check_swept("8b")
    print(f"8b summary: {json.dumps(rows)}", flush=True)
    return fg_total, bg_total, rows


def phase_run_executable():
    """Phase 8c: ``launch/multiplex_demo.py`` on the card (GPU mode: the
    8 positions of VGG-16's plan all on the card), then
    ``ClusterCoordinator.collocate(executable=True)`` on the same plan with
    feedback off: each tenant launches its scheduled steps every iteration,
    no 'fallback' event, and the calibrated ``predict()`` gives the
    measured steps per iteration exactly."""
    import torch

    from repro_torch.configs.vgg16 import CONFIG as VCFG
    from repro_torch.core.coordinator import ClusterCoordinator, Job
    from repro_torch.core.costmodel import A100
    from repro_torch.core.multiplex import BgTenant, Collocator, MultiplexConfig
    from repro_torch.launch import multiplex_demo
    from repro_torch.models.graph import build_vgg_graph
    from repro_torch.train.step import bg_step_factory

    _reset_counts()
    stage = multiplex_demo.stand_in_stage
    with _FlashShapes() as shapes, _IssuedStreams() as issued, _NoDeviceSync():
        multiplex_demo.stand_in_stage = issued.stage(stage)
        try:
            col, res, pred, losses = multiplex_demo.main([])
        finally:
            multiplex_demo.stand_in_stage = stage
    torch.cuda.synchronize()
    issued.check("8c demo", col.cfg.use_priorities)
    ls = [float(x) for x in losses]
    if not (res.iterations > 0 and res.bg_steps_per_iter > 0 and ls and np.isfinite(ls).all()):
        fail(f"8c demo: {res.row()}; {len(ls)} tenant losses, finite {np.isfinite(ls).all()}")
    print(f"8c demo: {res.row()}; {len(ls)} tenant steps, losses finite", flush=True)

    coord = ClusterCoordinator(8, A100)
    coord.submit_foreground(Job("vgg16", "foreground", build_vgg_graph(VCFG, 32),
                                amp_limit=1.5))
    jobs = multiplex_demo.ROSTER
    for job, prio, seed in jobs:
        coord.submit_background(Job(job, "background", [], priority=prio,
                                    step_fn_factory=bg_step_factory(
                                        multiplex_demo.TENANT_ARCH, seq=multiplex_demo.TENANT_SEQ,
                                        seed=seed, per_device_batch=multiplex_demo.TENANT_BATCH)))
    mcfg = MultiplexConfig(max_inflight=2, collocate_same_device=True, use_feedback=False)
    with shapes, _IssuedStreams() as issued, _NoDeviceSync():
        res = coord.collocate(mcfg, executable=True, iterations=5,
                              make_fg_stage_fn=issued.stage(multiplex_demo.stand_in_stage))
    torch.cuda.synchronize()
    issued.check("8c coordinator", mcfg.use_priorities)
    counts = _counts()["flash"]
    plan = coord.foreground().plan
    model = Collocator(plan, mcfg, tenants=[BgTenant(j, p) for j, p, _ in jobs])
    sched = model.schedule_tenants()
    want = [sum(n for _, slot, n in sched if slot == i) for i in range(len(jobs))]
    got = [t.bg_steps_per_iter for t in res.tenants]
    fallback = [e.detail for e in coord.events if e.kind == "fallback"]
    model.calibrate([res])
    p = model.predict()
    print(f"8c coordinator: {res.row()}", flush=True)
    for t in res.tenants:
        print(f"  {t.row()} (weight {t.weight:g}, deficit {t.deficit:.1f}, "
              f"{t.bg_throughput:.1f} steps/s)")
    print(f"  iterations {res.iterations}, steps per iteration {[n for _, n in res.iter_details]} "
          f"(schedule {want}); fg iter {res.fg_iter_time * 1e3:.3f} ms (isolated "
          f"{res.fg_iter_time_isolated * 1e3:.3f} ms); gap_inflation "
          f"{model.interference.gap_inflation:.4f}, per stage "
          f"{dict(model.interference.gap_inflation_stages)}; predicted slowdown "
          f"{p.fg_slowdown:.4f} against measured {res.fg_slowdown:.4f}; predicted steps per "
          f"iteration {p.bg_steps_per_iter} against measured {res.bg_steps_per_iter}; flash "
          f"launches {counts}", flush=True)
    if got != want or any(n != sum(want) for _, n in res.iter_details):
        fail(f"8c: tenants launched {got} steps per iteration, the schedule says {want}")
    if fallback:
        fail(f"8c: the coordinator fell back: {fallback}")
    if p.bg_steps_per_iter != res.bg_steps_per_iter or \
            [t.bg_steps_per_iter for t in p.tenants] != got:
        fail(f"8c: predict() gives {p.bg_steps_per_iter} steps per iteration, measured "
             f"{res.bg_steps_per_iter}")
    shapes.check_swept("8c")
    return counts, res


def phase_admission(cfg, smi, stats5, ttft5):
    """Phase 8d: phase 5's trace once more, through
    ``ContinuousScheduler(admission=ServingAdmission(...))`` with the
    prefill and decode-step times phase 5 measured and a TTFT SLO of 1.5x
    the prefill: every request gets its budget and no page leaks."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.api import get_model
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.serve.scheduler import ContinuousScheduler, ServingAdmission
    from repro_torch.serve.trace import materialize_requests

    dev = torch.device("cuda")
    params = get_model(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
    eng = ContinuousBatchingEngine(cfg, params, lanes=4, n_pages=545, page_tokens=16,
                                   lane_capacity=2176, device=dev)
    del params
    torch.cuda.empty_cache()
    prefill = stats5.prefill_s / stats5.prefills
    decode = stats5.decode_s / stats5.decode_steps
    # one position for the prefill, one per decode lane: every position is the card
    adm = ServingAdmission(1 + eng.lanes, 1, prefill_time=prefill, decode_step_time=decode,
                           ttft_slo=1.5 * prefill)
    trace = slice_trace(cfg.vocab_size)
    sched = ContinuousScheduler(eng, admission=adm)
    fa.launches.update(fwd=0, bwd=0)
    rep = sched.run(materialize_requests(trace))
    launches = fa.launches["fwd"]
    want = {r["id"]: r["max_new"] for r in trace.requests}
    got = {r.rid: len(r.tokens) for r in rep.completed}
    print(f"8d admission on {smi}: prefill {prefill * 1e3:.2f} ms, decode step "
          f"{decode * 1e3:.2f} ms (phase 5), TTFT SLO {1.5 * prefill * 1e3:.2f} ms (bound "
          f"{adm.bound:.2f}x); admission_deferrals {rep.admission_deferrals} (phase 5 without "
          f"admission: 0), page deferrals {rep.page_deferrals}; TTFT p50 "
          f"{rep.ttft_percentile(50) * 1e3:.2f} ms p99 {rep.ttft_percentile(99) * 1e3:.2f} ms "
          f"(phase 5: {ttft5[0] * 1e3:.2f} / {ttft5[1] * 1e3:.2f}); makespan "
          f"{rep.makespan:.3f} s; last decision: "
          f"{sched.last_decision.row() if sched.last_decision else None}; flash launches "
          f"{launches}", flush=True)
    if got != want:
        fail(f"8d: token counts {got} != budgets {want}")
    if eng.alloc.used_pages != 0:
        fail(f"8d: {eng.alloc.used_pages} pages leaked")
    if fa.launches["bwd"] or launches != eng.stats.prefills * cfg.num_layers:
        fail(f"8d: kernel launches {launches} != prefills {eng.stats.prefills} x "
             f"{cfg.num_layers} layers")
    del eng
    torch.cuda.empty_cache()
    return launches


# 20 steps, as zamba2: the cosine schedule then warms up for 2 steps
QWEN_TRAIN = dict(steps=20, batch=4, seq=4096)


def phase_qwen_model():
    """Phase 4q: qwen2-1.5b at full width cut to 4 layers, one 2 x 1024
    batch: loss and every parameter gradient through the flash kernels and
    through ``flash_attention_plain`` agree; per-layer remat runs the
    forward twice per layer."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=4)
    api = get_model(cfg)
    dev = torch.device("cuda")
    params = api.init(torch.Generator(device=dev).manual_seed(1), dev)
    toks = np.random.default_rng(14).integers(0, cfg.vocab_size, (2, 1024))
    batch = {"tokens": torch.as_tensor(toks, device=dev),
             "labels": torch.as_tensor(np.roll(toks, -1, axis=1), device=dev)}
    _kernel_vs_plain_grads(f"qwen2-1.5b x{cfg.num_layers} layers (12 heads over 2 KV heads "
                           "of 128), 2 x 1024 tokens, bf16", cfg, api, params, batch,
                           {"fwd": 2 * cfg.num_layers, "bwd": cfg.num_layers})
    del params
    _free_card()


def phase_qwen_train(smi):
    """Phases 5q and 6q: qwen2-1.5b at full width and depth (28 layers,
    fp32 params, bf16 compute, AdamW on the cosine schedule, per-layer
    remat) trains 20 steps at 4 x 4096 through ``train.loop.train``; then
    one more step under the profiler, which must run the ``wgmma`` flash
    forward at d=128 and both backward kernels (and no fp32 FMA flash
    kernel)."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen2-1.5b")
    n = QWEN_TRAIN
    tokens = n["batch"] * n["seq"]
    counts, _, _, _ = _train_and_profile(
        cfg, n, f"{cfg.name} {cfg.num_layers} layers d_model {cfg.d_model} {cfg.num_heads} "
        f"heads over {cfg.num_kv_heads} KV heads of {cfg.d_head}", smi, 128,
        lambda step_s: f"{tokens / step_s:.0f} tokens/s")
    L, steps = cfg.num_layers, n["steps"]
    want = {"fwd": steps * 2 * L, "bwd": steps * L}
    if counts["flash"] != want or any(counts["ssd"].values()):
        fail(f"launches {counts} != flash {want}")
    return counts["flash"]


FLASH_SM90 = ("flash_fwd_sm90", "flash_bwd_dq_sm90", "flash_bwd_dkdv_sm90")


def _prefill_kernel_vs_plain(cfg4, api, params, label, n_patches=0):
    """A 1000-token prefill (after ``n_patches`` seeded patch embeddings,
    for a vision model) through the flash kernel and through
    ``flash_attention_plain`` (with the config's softcap) on the same
    weights: logits within ``MODEL_RTOL`` of the largest, the same argmax,
    one forward launch per layer and none for the plain path.  Returns the
    kernel prefill's forward launches."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    tokens = torch.as_tensor(rng.integers(0, cfg4.vocab_size, (1, 1000)), device=dev)
    kw = {}
    if n_patches:
        kw["patch_embeds"] = torch.as_tensor(
            rng.standard_normal((1, n_patches, cfg4.d_model), dtype=np.float32), device=dev)
    cap = n_patches + 1008
    fa.launches.update(fwd=0, bwd=0)
    via_kernel, _ = api.prefill(params, tokens, cap, **kw)
    launches = fa.launches["fwd"]
    if fa.launches != {"fwd": cfg4.num_layers, "bwd": 0}:
        fail(f"{label}: 4-layer prefill launched the kernel {fa.launches} times, "
             f"not {cfg4.num_layers} forward")
    kernel_attention = ops.attention
    ops.attention = lambda q, k, v, *, causal=True, window=0, softcap=0.0: (
        fa.flash_attention_plain(q, k, v, causal=causal, window=window, softcap=softcap))
    fa.launches.update(fwd=0, bwd=0)
    try:
        via_plain, _ = api.prefill(params, tokens, cap, **kw)
    finally:
        ops.attention = kernel_attention
    if fa.launches != {"fwd": 0, "bwd": 0}:
        fail(f"{label}: the plain-attention prefill launched the kernel")
    a, b = via_kernel.float(), via_plain.float()
    diff, scale = float((a - b).abs().max()), float(b.abs().max())
    same = int(a.argmax()) == int(b.argmax())
    print(f"model: {label}, {n_patches} + 1000-position prefill logits kernel vs plain: "
          f"max abs diff {diff:.4g} (bound {MODEL_RTOL} x max|logit| = "
          f"{MODEL_RTOL * scale:.4g}); argmax {int(a.argmax())} vs {int(b.argmax())}",
          flush=True)
    if not (torch.isfinite(a).all() and diff <= MODEL_RTOL * scale and same):
        fail(f"{label}: in-model kernel and plain prefill disagree")
    return launches


def phase_model(cfg):
    import torch

    from repro_torch.models.api import get_model
    from repro_torch.serve.engine import serving_params

    cfg4 = dataclasses.replace(cfg, num_layers=4)
    api = get_model(cfg4)
    dev = torch.device("cuda")
    params = serving_params(api, api.init(torch.Generator(device=dev).manual_seed(1), dev), dev)
    _prefill_kernel_vs_plain(cfg4, api, params, "llama3-8b x4 layers")
    del params
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
    # drawn straight into the serving dtype: no fp32 copy of the model
    params = api.init(torch.Generator(device=dev).manual_seed(0), dev, dtype=cfg.dtype)
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
    if peak >= PEAK_LIMIT:
        fail(f"peak memory {peak / 2**30:.2f} GiB is not below {PEAK_LIMIT / 2**30:.0f} GiB")
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
    return launches, eng, rep


PEAK_LIMIT = 79 * 2**30  # serving: weights, KV pool and activations below 79 GiB
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
    rows = _profile(f"train step {n['batch']} x {n['seq']}", lambda: step(state, batch), top=12)
    _step_ran_chunked("rwkv6", rows, "wkv6_", WKV_CHUNKED, WKV_RECURRENCE)


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
    rows = _profile(f"zamba2 train step {n['batch']} x {n['seq']}",
                    lambda: step(state, batch), top=14)
    _step_ran_chunked("zamba2", rows, "ssd_", SSD_CHUNKED, SSD_RECURRENCE)


def _step_ran_chunked(model, rows, prefix, chunked, recurrence):
    """Lists the kernels of one family in a profiled step and fails unless
    every chunked kernel ran and no recurrence kernel did."""
    ran = {k: v for k, v in rows.items() if prefix in k}
    print(f"  {prefix.rstrip('_')} kernels in the step: " + "; ".join(
        f"{_kernel_name(k)} x{c} {ms:.2f} ms"
        for k, (c, ms) in sorted(ran.items(), key=lambda x: -x[1][1])))
    for need in chunked:
        if not any(need in k for k in ran):
            fail(f"profile of the {model} step shows no {need}")
    if any(_kernel_name(k) in recurrence for k in ran):
        fail(f"the {model} step ran the fp32 recurrence {prefix} kernels")


KERNEL_FAMILIES = {  # kernel-name substrings -> family, for the profiles' summary line
    "wkv6 kernels": ("wkv6_",),
    "ssd kernels": ("ssd_",),
    "flash kernels": ("flash_fwd", "flash_bwd"),
    "GEMM (cuBLAS)": ("nvjet", "gemm", "Gemm", "gemv"),
}


def _profile(label, fn, top=8):
    """Device time by kernel over ``fn()`` (torch.profiler/CUPTI), and the
    share of the wall time the device was busy; returns ``{kernel: (count,
    device ms)}``."""
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
    return {e.key: (e.count, dev(e) * 1e-3) for e in rows}


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


# ---------------------------------------------------------------------------
# Slice 6: the MoE family, softcap, Adafactor, recurrent serving (9a-9f)
# ---------------------------------------------------------------------------

SOFTCAP_SWEEP = dict(
    cap=[30.0, 5.0],  # grok-1's 30; 5 saturates tanh on the larger scores
    S=[1, 64, 129, 1000, 2048],
    # (causal, window, Skv - Sq): causal, a window, non-causal with Sq != Skv
    mask=[(True, 0, 0), (True, 96, 0), (False, 0, 63)],
    heads=[(48, 8), (32, 4)],  # grok-1's 48/8 and qwen3-moe's 32/4
    d=[32, 64, 80, 128],
    dtype=["float32", "bfloat16"],
)
GROK_FLASH = dict(B=1, S=4096, H=48, KV=8, d=128, window=0)  # grok-1 at 1 x 4096


def phase_softcap(sweep=SOFTCAP_SWEEP):
    """Phase 9a: the capped flash kernels, forward and backward, both
    routes, against autograd through ``flash_attention_plain`` with the
    same cap (``FLASH_BWD_TOL``; the forward also at ``TOL``), then their
    times at grok-1's attention shape beside the capless kernels, the plain
    version, ``flex_attention`` with the cap and the bound (the capless
    operation count)."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    names = ["o", "dq", "dk", "dv"]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    used = {"float32": 0.0, "bfloat16": 0.0}
    where = {"float32": "", "bfloat16": ""}
    fwd_worst = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    _reset_counts()
    for cap, S, (causal, window, extra), (h, kv), d, dtype in itertools.product(*sweep.values()):
        q, k, v = _inputs(1, S, S + extra, h, kv, d, dtype, seed=900 + n)
        do = torch.randn(q.shape, device="cuda").to(q.dtype)
        got, want = ([t.detach().requires_grad_() for t in (q, k, v)] for _ in range(2))
        o = fa.flash_attention(*got, causal=causal, window=window, softcap=cap)
        ow = fa.flash_attention_plain(*want, causal=causal, window=window, softcap=cap)
        got = [o.detach(), *torch.autograd.grad(o, got, do)]
        want = [ow.detach(), *torch.autograd.grad(ow, want, do)]
        torch.cuda.synchronize()
        case = (f"softcap={cap} B=1 H={h} KV={kv} d={d} Sq={S} Skv={S + extra} causal={causal} "
                f"window={window} {dtype}")
        err = (got[0].float() - want[0].float()).abs()
        tol = TOL[dtype]
        if not bool((err <= tol + tol * want[0].float().abs()).all()):
            fail(f"capped flash forward != plain at {case}: max abs err {float(err.max()):.3g}")
        fwd_worst[dtype] = max(fwd_worst[dtype], float(err.max()))
        _check_close(case, names, got, want, FLASH_BWD_TOL[dtype], worst, used, where, dtype,
                     rel_to_max=dtype == "bfloat16")
        n += 1
    launched = _counts()["flash"]
    if launched != {"fwd": n, "bwd": n}:
        fail(f"the softcap sweep launched the kernels {launched} times, not {n} each way")
    print(f"kernels: capped flash forward and backward match autograd through "
          f"flash_attention_plain(softcap=...) on {n} cases (caps {sweep['cap']}, S "
          f"{sweep['S']}, causal / window 96 / non-causal Sq != Skv, heads {sweep['heads']}, "
          f"d {sweep['d']}, both routes); forward max abs err fp32 {fwd_worst['float32']:.3g} "
          f"bf16 {fwd_worst['bfloat16']:.3g} (tol {TOL}); o, dq, dk, dv max abs err fp32 "
          f"{worst['float32']:.3g} bf16 {worst['bfloat16']:.3g}; largest share of an "
          f"element's tolerance fp32 {used['float32']:.3g} ({where['float32']}), bf16 "
          f"{used['bfloat16']:.3g} ({where['bfloat16']})", flush=True)
    torch.cuda.empty_cache()
    (fwd, bwd), same, lib_err = _flash_times(GROK_FLASH, seed=91, softcap=30.0)
    fwd.update(max_abs_err_fp32=fwd_worst["float32"], max_abs_err_bf16=fwd_worst["bfloat16"],
               cases=n)
    bwd.update(max_abs_err_fp32=worst["float32"], max_abs_err_bf16=worst["bfloat16"],
               tol_share_fp32=used["float32"], tol_share_bf16=used["bfloat16"], cases=n,
               deterministic=all(same), vs_flex_attention_max_abs_err=lib_err)
    return fwd, bwd, n


def _direct_params(cfg, seed):
    """A model's parameters drawn straight into its serving dtype on the
    card (norm scales and the MoE router fp32): no fp32 copy exists."""
    import torch

    from repro_torch.models.api import get_model

    api = get_model(cfg)
    dev = torch.device("cuda")
    return api, api.init(torch.Generator(device=dev).manual_seed(seed), dev, dtype=cfg.dtype)


def phase_moe_model():
    """Phase 9b: qwen3-moe-30b-a3b at full width cut to 4 layers: a
    1000-token prefill through the flash kernel (32 query heads over 4 KV
    heads of 128) against the plain attention path."""
    import torch

    from repro_torch.configs import get_config

    cfg4 = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), num_layers=4)
    api, params = _direct_params(cfg4, seed=1)
    _prefill_kernel_vs_plain(cfg4, api, params, "qwen3-moe-30b-a3b x4 layers (128 experts, "
                             "top 8)")
    del params
    torch.cuda.empty_cache()


def _generate_check(cfg, params, batch, prompt_len, new_tokens, label, smi):
    """``ServingEngine.generate`` on ``batch`` seeded prompts: token counts
    right and in the vocabulary, and the prefill's logits finite.  Returns
    the flash forward launches of the generate call."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serve.engine import ServingEngine

    prompts = np.random.default_rng(21).integers(0, cfg.vocab_size, (batch, prompt_len))
    eng = ServingEngine(cfg, params, batch=batch, capacity=prompt_len + new_tokens,
                        device="cuda")
    fa.launches.update(fwd=0, bwd=0)
    out = eng.generate(prompts, new_tokens)
    launches = fa.launches["fwd"]
    st = eng.stats
    eng.reset()
    logits = eng.prefill(prompts)
    ok = bool(torch.isfinite(logits).all())
    print(f"{label} ServingEngine.generate on {smi}: {batch} x {prompt_len} prompts, "
          f"{new_tokens} new tokens -> {out.shape}; prefill {st.prefill_s * 1e3:.2f} ms "
          f"({st.prefill_s / batch * 1e3:.2f} ms/request); decode {st.tokens_per_s:.2f} "
          f"tokens/s ({st.decode_steps} steps in {st.decode_s:.3f} s); prefill logits finite: "
          f"{ok}; flash launches {launches}", flush=True)
    if out.shape != (batch, new_tokens) or not ((0 <= out) & (out < cfg.vocab_size)).all():
        fail(f"{label}: generate gave {out.shape} tokens or tokens outside the vocabulary")
    if not ok:
        fail(f"{label}: non-finite prefill logits")
    return launches


def phase_moe_slice(smi):
    """Phase 9c: qwen3-moe-30b-a3b at full width and depth (48 layers,
    30.53 B params, bf16 drawn on the card) serves phase 5's trace through
    ``ContinuousBatchingEngine`` + ``ContinuousScheduler``, profiles a
    2048-token prefill and 8 decode ticks of 4 lanes, then
    ``ServingEngine.generate`` on 4 x 512 prompts and 32 new tokens."""
    import torch

    from repro_torch.configs import get_config

    cfg = get_config("qwen3-moe-30b-a3b")
    launches, eng, rep = phase_slice(cfg, smi)
    phase_profile(eng, cfg)  # where a prefill's and a decode tick's time goes
    params = eng.params
    del eng, rep
    torch.cuda.empty_cache()
    launches += _generate_check(cfg, params, 4, 512, 32, "qwen3-moe-30b-a3b", smi)
    peak = torch.cuda.max_memory_allocated()
    print(f"qwen3-moe-30b-a3b serving peak memory {peak / 2**30:.2f} GiB", flush=True)
    if peak >= PEAK_LIMIT:
        fail(f"qwen3-moe peak memory {peak / 2**30:.2f} GiB is not below 79 GiB")
    del params
    torch.cuda.empty_cache()
    return launches


def phase_grok(smi):
    """Phase 9d: grok-1-314b at full width cut to 4 layers (8 experts of
    d_ff 32768, top 2; 48 query heads over 8 KV heads of 128, logit softcap
    30): a 1000-token prefill through the capped flash kernel against the
    plain path, then ``ServingEngine.generate`` on 2 x 256 prompts and 16
    new tokens."""
    import torch

    from repro_torch.configs import get_config

    cfg4 = dataclasses.replace(get_config("grok-1-314b"), num_layers=4)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    api, params = _direct_params(cfg4, seed=2)
    torch.cuda.synchronize()
    print(f"grok-1-314b x4 layers: {cfg4.n_params() / 1e9:.2f} B params in {cfg4.dtype}, "
          f"drawn in {time.perf_counter() - t0:.1f} s; softcap {cfg4.attn_logit_softcap}",
          flush=True)
    _prefill_kernel_vs_plain(cfg4, api, params, "grok-1-314b x4 layers (softcap 30)")
    launches = _generate_check(cfg4, params, 2, 256, 16, "grok-1-314b x4 layers", smi)
    print(f"grok-1-314b x4 layers peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB", flush=True)
    del params
    torch.cuda.empty_cache()
    return launches


def phase_recurrent_serving(smi):
    """Phase 9e: rwkv6-1.6b and zamba2-2.7b at full width and depth through
    ``ServingEngine``: 4 x 256 prompts fed token by token through
    ``decode_step``, then 32 new tokens; the token-by-token prefill's last
    logits against ``forward`` (the chunked WKV-6 / SSD kernels and flash
    at d=80) on the same prompts."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.serve.engine import ServingEngine

    out = {}
    for arch in ("rwkv6-1.6b", "zamba2-2.7b"):
        cfg = get_config(arch)
        api, params = _direct_params(cfg, seed=3)
        prompts = np.random.default_rng(22).integers(0, cfg.vocab_size, (4, 256))
        eng = ServingEngine(cfg, params, batch=4, capacity=256 + 32, device="cuda")
        prefill, seen = eng.prefill, {}
        eng.prefill = lambda p: seen.setdefault("last", prefill(p))  # generate's own prefill
        toks = eng.generate(prompts, 32)
        del eng.prefill  # the wrapper refers to the engine: no cycle to outlive the phase
        st = eng.stats
        last = seen["last"].float()
        _reset_counts()
        with torch.no_grad():
            want = api.forward(params, torch.as_tensor(prompts, device="cuda"))[:, -1].float()
        counts = {"wkv6": _wkv_counts(), **_counts()}
        diff, scale = float((last - want).abs().max()), float(want.abs().max())
        same = bool((last.argmax(-1) == want.argmax(-1)).all())
        print(f"{arch} served on {smi}: 4 x 256 prompts token by token, 32 new tokens -> "
              f"{toks.shape}; prefill {st.prefill_s / 4 * 1e3:.2f} ms/request "
              f"({st.prefill_s:.3f} s for the batch); decode {st.tokens_per_s:.2f} tokens/s; "
              f"last prefill logits vs forward: max abs diff {diff:.4g} (bound {MODEL_RTOL} x "
              f"max|logit| = {MODEL_RTOL * scale:.4g}), argmax same {same}; forward launches "
              f"{counts}", flush=True)
        if toks.shape != (4, 32) or not (bool(torch.isfinite(last).all())
                                         and diff <= MODEL_RTOL * scale and same):
            fail(f"{arch}: token-by-token prefill disagrees with forward")
        ran = (counts["wkv6"]["fwd"] == cfg.num_layers if arch.startswith("rwkv6") else
               counts["ssd"]["fwd"] == cfg.num_layers and counts["flash"]["fwd"] > 0)
        if not ran:
            fail(f"{arch}: forward launched {counts}, not its kernels")
        out[arch] = dict(prefill_ms_per_request=st.prefill_s / 4 * 1e3,
                         decode_tokens_per_s=st.tokens_per_s)
        del api, params, eng
        torch.cuda.empty_cache()
    return out


# 20 steps, as phases 5c and 5q: the cosine schedule then warms up for 2
# steps (at 6 it has none, and qwen2-72b's Adafactor losses rose and fell
# back, 12.44 -> 15.67 -> 12.92, without ending below the first)
BIG_TRAIN = dict(steps=20, batch=1, seq=4096, layers=2)


def phase_big_train(smi):
    """Phase 9f: qwen3-moe-30b-a3b (AdamW) and qwen2-72b (Adafactor) at full
    width cut to 2 layers train 20 steps at 1 x 4096 through
    ``train.loop.train``: every loss finite, the last below the first; then
    one profiled step each, which must run ``flash_fwd_sm90<128>`` and both
    ``flash_bwd_*_sm90``, and whose ``moe_aux`` is finite; then
    ``_adafactor_full_width`` at qwen2-72b's widths."""
    from repro_torch.configs import get_config

    n = BIG_TRAIN
    launches = {}
    for arch in ("qwen3-moe-30b-a3b", "qwen2-72b"):
        cfg = dataclasses.replace(get_config(arch), num_layers=n["layers"])
        counts, _, _, metrics = _train_and_profile(
            cfg, n, f"{arch} x{cfg.num_layers} layers", smi, 128,
            lambda step_s: f"{n['batch'] * n['seq'] / step_s:.0f} tokens/s")
        counts = counts["flash"]
        if counts != {"fwd": 2 * n["steps"] * cfg.num_layers, "bwd": n["steps"] * cfg.num_layers}:
            fail(f"{arch}: flash launches {counts}")
        launches[arch] = counts
        aux = float(metrics["moe_aux"])
        print(f"  {arch} moe_aux {aux:.6g}", flush=True)
        if not np.isfinite(aux) or (cfg.block_type == "moe") != (aux > 0):
            fail(f"{arch}: moe_aux {aux}")
    _adafactor_full_width(cfg, smi)
    return launches


ADAFACTOR_LEAVES = ("embed", "layers/attn/wq", "layers/mlp/wu", "final_norm")
ADAFACTOR_TOL = 1e-5  # fp32 update against fp64, relative (see _adafactor_full_width)


def _adafactor_plain64(grads, stats, params, count, lr, decay=0.8, eps=1e-30, clip=1.0,
                       max_norm=1.0):
    """The reference's Adafactor update (``src/repro/optim/optimizer.py``
    ``adafactor``: global-norm clipping, ``beta = 1 - count^-decay``,
    factored ``vr``/``vc`` over the last two dims, per-leaf RMS clipping)
    written out in fp64 on dicts of tensors; updates ``stats`` and
    ``params`` in place and returns each leaf's largest |step|."""
    import torch

    norm = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values())))
    scale = min(1.0, max_norm / (norm + 1e-9))
    beta = 1.0 - count ** (-decay)
    steps = {}
    for k, g in grads.items():
        g = g.double().mul_(scale)
        g2 = g * g + eps
        st = stats[k]
        if "vr" in st:
            st["vr"] = beta * st["vr"] + (1 - beta) * g2.mean(-1)
            st["vc"] = beta * st["vc"] + (1 - beta) * g2.mean(-2)
            del g2
            rfac = st["vr"] / st["vr"].mean(-1, keepdim=True).clamp(min=eps)
            u = g.div_(rfac.sqrt()[..., None] * st["vc"].sqrt()[..., None, :] + eps)
        else:
            st["v"] = beta * st["v"] + (1 - beta) * g2
            del g2
            u = g.div_(st["v"].sqrt() + eps)
        rms = math.sqrt(float(torch.linalg.vector_norm(u)) ** 2 / u.numel() + eps)
        u.mul_(lr / max(1.0, rms / clip))
        steps[k] = float(u.abs().max())
        params[k].sub_(u)
        del u, g
    return steps


def _adafactor_full_width(cfg, smi):
    """One check of the port's ``adafactor`` at full width: two updates
    (count 1, where ``beta`` is 0, then count 2 with gradients three times
    larger, so the per-leaf RMS clip acts) of ``cfg``'s largest factored
    leaves (the embedding, ``wq`` factored over heads x d_head, ``w_up``)
    and an unfactored norm, at their shapes, held against
    ``_adafactor_plain64`` on the same gradients (a seeded normal with
    per-row and per-column scales, so the factored statistics differ from
    row to row; global-norm clipping active).  Fails unless after each
    update every ``vr``/``vc``/``v`` is within ``ADAFACTOR_TOL`` of the fp64
    value, relative to that value, and every parameter within
    ``ADAFACTOR_TOL`` of the leaf's largest fp64 step."""
    import torch

    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.models.api import get_model
    from repro_torch.optim.optimizer import adafactor, constant_schedule

    lr = 1e-2  # a step comparable to the weights, so the check sees it above fp32 rounding
    specs = flatten(get_model(cfg).schema)
    gen = torch.Generator(device="cuda").manual_seed(7)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device="cuda").mul_(std)

    def grad(shape, mult):
        g = normal(shape, 1e-3 * mult)
        if len(shape) >= 2:
            g.mul_(normal(shape[:-1], 0.5).exp_()[..., None]).mul_(normal(shape[-1:], 0.5).exp_())
        return g

    params = {k: normal(specs[k].shape, 0.02) for k in ADAFACTOR_LEAVES}
    opt = adafactor(constant_schedule(lr))
    state = opt.init(params)
    p64 = {k: p.double() for k, p in params.items()}
    s64 = {k: {n: t.double() for n, t in st.items()} for k, st in state["stats"].items()}
    worst = {"param": 0.0, "stats": 0.0}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for count, mult in ((1, 1.0), (2, 3.0)):
        grads = {k: grad(specs[k].shape, mult) for k in ADAFACTOR_LEAVES}
        params, state = opt.update(grads, state, params)
        steps = _adafactor_plain64(grads, s64, p64, count, lr)
        del grads
        for k in ADAFACTOR_LEAVES:
            err = float((params[k].double() - p64[k]).abs().max()) / steps[k]
            st = max(float(((state["stats"][k][n].double() - t).abs() / t).max())
                     for n, t in s64[k].items())
            worst["param"], worst["stats"] = max(worst["param"], err), max(worst["stats"], st)
            if not (err <= ADAFACTOR_TOL and st <= ADAFACTOR_TOL):
                fail(f"adafactor update {count} of {k} {tuple(specs[k].shape)}: parameter err "
                     f"{err:.3g} of the largest step, statistics rel err {st:.3g} against "
                     f"fp64 (tol {ADAFACTOR_TOL})")
    torch.cuda.synchronize()
    print(f"adafactor at full width ({cfg.name}) on {smi}: two updates of "
          f"{', '.join(f'{k} {tuple(specs[k].shape)}' for k in ADAFACTOR_LEAVES)} match an fp64 "
          f"plain update: parameters within {worst['param']:.3g} of the largest step, "
          f"vr/vc/v within {worst['stats']:.3g} relative (tol {ADAFACTOR_TOL}); "
          f"{time.perf_counter() - t0:.1f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del params, state, p64, s64
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Slice 7: the encoder-decoder family, the vision prefix and VGG-16 (10a-10g)
# ---------------------------------------------------------------------------

# seamless-m4t-large-v2 training at 4 x 4096 frames: its encoder self-attention
# and its decoder's cross-attention over the frames, 16 heads of 64, not causal
SEAMLESS_ENC_FLASH = dict(B=4, S=4096, Skv=4096, H=16, KV=16, d=64, window=0, causal=False)
SEAMLESS_CROSS_FLASH = dict(SEAMLESS_ENC_FLASH, S=1024)
SEAMLESS_CHECK = dict(batch=2, frames=1024, layers=4)  # 10b: 4 encoder + 4 decoder layers
SEAMLESS_TRAIN = dict(steps=20, batch=4, seq=4096)     # 10c: 4 x 4096 frames, 4 x 1024 tokens
SEAMLESS_SERVE = dict(batch=4, prompt=256, new=32, frames=4096)  # 10d
PIXTRAL = dict(batch=4, patches=1024, new=32, check_layers=4)    # 10e
PIXTRAL_TRAIN = dict(steps=20, batch=1, seq=4096, layers=2)      # 10f: 1024 patches + 3072 text
VGG_RUN = dict(batch=32, check_batch=4, steps=10, lr=1e-4)       # 10g
# 10g: fp32 (TF32 off) against the same module in fp64 on the card, relative
# L2 errors: the loss and the logits hold to 1e-5; each gradient leaf to
# 2e-2, because cuDNN's fp32 convolution gradients stand about 1e-2 from
# fp64 on an H100 while the dense layers' stand near 2e-6 (phase 10g prints
# both, and beside them the same gradients without cuDNN and with TF32 on,
# which this bound refuses)
VGG_TOL = dict(loss=1e-5, logits=1e-5, grad=2e-2)


def phase_flash_seamless():
    """Phase 10a: the flash forward and backward at seamless's encoder
    shape (4 x 4096, 16 heads of 64, not causal) and cross-attention shape
    (1024 queries over 4096 frames), timed beside the plain version,
    ``scaled_dot_product_attention`` (autograd through it for the
    backward) and the bound (no causal halving), each held against autograd
    through the plain version; two backward calls at each shape
    bit-identical.  (The sweeps of phases 3 and 3d hold the non-causal
    Sq != Skv cases of this regime.)"""
    out = {}
    for name, sl, seed in (("encoder", SEAMLESS_ENC_FLASH, 81),
                           ("cross", SEAMLESS_CROSS_FLASH, 82)):
        (fwd, bwd), same, lib_err = _flash_times(sl, seed=seed)
        bwd.update(deterministic=all(same), vs_sdpa_max_abs_err=lib_err)
        out[name] = (fwd, bwd)
        _free_card()
    return ({k: v[0] for k, v in out.items()}, {k: v[1] for k, v in out.items()})


def _free_card():
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _seamless_batch(cfg, B, frames, seed):
    """Seeded fp32 frames (B, frames, D) and skewed tokens (B, frames // 4)
    with next-token labels, on the card."""
    import torch

    rng = np.random.default_rng(seed)
    toks = np.minimum(rng.random((B, frames // 4)) ** 3 * cfg.vocab_size,
                      cfg.vocab_size - 1).astype(np.int64)
    return {"frames": torch.as_tensor(rng.standard_normal((B, frames, cfg.d_model),
                                                          dtype=np.float32), device="cuda"),
            "tokens": torch.as_tensor(toks, device="cuda"),
            "labels": torch.as_tensor(np.roll(toks, -1, axis=1), device="cuda")}


def _kernel_vs_plain_grads(label, cfg, api, params, batch, want):
    """Loss and every parameter gradient of one batch through the flash
    kernels, then through ``flash_attention_plain`` (``ops.attention``
    swapped), within ``TRAIN_MODEL_TOL``; the kernels' launches must be
    ``want`` exactly and the plain run's none."""
    import torch

    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.layers import tree_leaves

    leaves = [p.requires_grad_() for p in tree_leaves(params)]

    def loss_and_grads():
        loss, _ = api.loss(params, batch)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    _reset_counts()
    loss_k, grads_k = loss_and_grads()
    torch.cuda.synchronize()
    counts = _counts()["flash"]
    if counts != want:
        fail(f"{label}: the train step launched the flash kernels {counts} times, not {want}")
    kernel_attention = ops.attention
    ops.attention = lambda q, k, v, *, causal=True, window=0, softcap=0.0: (
        fa.flash_attention_plain(q, k, v, causal=causal, window=window, softcap=softcap))
    try:
        loss_p, grads_p = loss_and_grads()
    finally:
        ops.attention = kernel_attention
    if _counts()["flash"] != want:
        fail(f"{label}: the plain-attention train step launched a flash kernel")
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    diffs = [float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))
             for a, b in zip(grads_k, grads_p)]
    worst = max(diffs)
    worst_leaf = list(flatten(params))[diffs.index(worst)]
    gnorm = float(torch.sqrt(sum(g.float().square().sum() for g in grads_k)))
    print(f"model: {label}: loss kernel {float(loss_k):.6f} vs plain {float(loss_p):.6f} "
          f"(rel diff {rel:.3g}, bound {TRAIN_MODEL_TOL['loss']}); worst gradient leaf diff "
          f"{worst:.3g} of its max |g| ({worst_leaf}; bound {TRAIN_MODEL_TOL['grad']}) over "
          f"{len(leaves)} leaves; grad norm {gnorm:.4g}; flash launches {counts}", flush=True)
    if not (rel <= TRAIN_MODEL_TOL["loss"] and worst <= TRAIN_MODEL_TOL["grad"]
            and np.isfinite(gnorm)):
        fail(f"{label}: flash kernels and plain train step disagree")
    return counts


def _encdec_flash_per_pass(cfg):
    """Flash calls of one encoder-decoder forward: one per encoder layer,
    two (self and cross) per decoder layer."""
    return cfg.num_encoder_layers + 2 * cfg.num_layers


def phase_seamless_model():
    """Phase 10b: seamless-m4t-large-v2 at full width cut to 4 encoder and
    4 decoder layers, one batch of 2 x 1024 frames and 2 x 256 decoder
    tokens: loss and every parameter gradient through the flash kernels
    (non-causal encoder and cross-attention, causal decoder, d=64) and
    through the plain version agree; per-block remat runs each forward
    twice."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model

    n = SEAMLESS_CHECK
    cfg = dataclasses.replace(get_config("seamless-m4t-large-v2"), num_layers=n["layers"],
                              num_encoder_layers=n["layers"])
    api = get_model(cfg)
    dev = torch.device("cuda")
    params = api.init(torch.Generator(device=dev).manual_seed(1), dev)
    per = _encdec_flash_per_pass(cfg)
    counts = _kernel_vs_plain_grads(
        f"seamless-m4t-large-v2 x{n['layers']}+{n['layers']} layers (16 heads of 64), "
        f"{n['batch']} x {n['frames']} frames, {n['frames'] // 4} decoder tokens, bf16",
        cfg, api, params, _seamless_batch(cfg, n["batch"], n["frames"], seed=15),
        {"fwd": 2 * per, "bwd": per})
    del params
    _free_card()
    return counts


def _train_and_profile(cfg, n, label, smi, d, tokens_note):
    """``n["steps"]`` steps of ``n["batch"] x n["seq"]`` through
    ``train.loop.train`` (the config's optimizer on the cosine schedule,
    ``SyntheticLMData`` seed 0): every loss finite, the last below the
    first, finite parameters, peak memory under 80 GB; then one more step
    under the profiler, which must run the ``sm90`` flash kernels at head
    dim ``d``.  Returns (``_counts()`` over the ``n["steps"]`` steps, median
    step s, peak bytes, the profiled step's metrics)."""
    import torch

    from repro_torch.configs import TRAIN_4K
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.api import get_model
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim.optimizer import make_optimizer
    from repro_torch.train.loop import TrainConfig, train
    from repro_torch.train.step import make_train_step

    shape = dataclasses.replace(TRAIN_4K, seq_len=n["seq"], global_batch=n["batch"],
                                name="smoke")
    _free_card()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    rep = train(cfg, shape, TrainConfig(steps=n["steps"], seed=0, max_failures=0),
                device="cuda")
    wall = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    losses = rep.losses
    step_s = float(np.median(rep.step_times))
    print(f"train {label} on {smi}: {cfg.param_dtype} params, {cfg.dtype} compute, "
          f"{cfg.optimizer}, remat {cfg.remat_policy}, {cfg.n_params() / 1e9:.3f} B params; "
          f"{n['steps']} steps of {n['batch']} x {n['seq']} ({tokens_note(step_s)}); losses "
          f"{[round(x, 4) for x in losses]}; median step {step_s * 1e3:.1f} ms; step times "
          f"{[round(t * 1e3, 1) for t in rep.step_times]} ms; {wall:.1f} s in train() with "
          f"set-up; peak memory {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB); launches "
          f"{counts}", flush=True)
    if rep.steps_done != n["steps"] or rep.restarts:
        fail(f"{label}: {rep.steps_done} steps done, {rep.restarts} restarts")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"{label}: losses not finite and falling: {losses}")
    if peak >= 80e9:
        fail(f"{label}: peak memory {peak / 1e9:.2f} GB does not fit an 80 GB card")
    bad = [i for i, p in enumerate(tree_leaves(rep.state["params"]))
           if not bool(torch.isfinite(p).all())]
    if bad:
        fail(f"{label}: non-finite parameters after the last step: leaves {bad}")
    step = make_train_step(get_model(cfg), make_optimizer(cfg, total_steps=n["steps"]))
    data = SyntheticLMData(cfg, n["batch"], n["seq"], seed=0, start_step=n["steps"],
                           device="cuda")
    batch = next(data)
    data.close()
    res = {}
    rows = _profile(f"{label} train step {n['batch']} x {n['seq']}",
                    lambda: res.update(m=step(rep.state, batch)[1]), top=12)
    _require_flash_sm90(label, rows, d=d)
    del rep, step, batch
    _free_card()
    return counts, step_s, peak, res["m"]


def phase_seamless_train(smi):
    """Phase 10c: seamless-m4t-large-v2 at full width and depth (24
    encoder and 24 decoder layers, d_model 1024, 16 heads of 64, d_ff 8192,
    vocab 256206; fp32 params, bf16 compute, AdamW on the cosine schedule,
    per-block remat) trains 20 steps of 4 x 4096 frames and 4 x 1024
    decoder tokens; flash launches per step 2 x (24 + 2 x 24) forward
    (remat runs each block's forward twice) and 24 + 2 x 24 backward; the
    profiled step must run ``flash_fwd_sm90<64>`` and both backward
    kernels at d=64."""
    from repro_torch.configs import get_config

    cfg = get_config("seamless-m4t-large-v2")
    n = SEAMLESS_TRAIN
    frames, dec = n["batch"] * n["seq"], n["batch"] * n["seq"] // 4

    def note(step_s):
        return (f"{frames} frames and {dec} decoder tokens a step: {frames / step_s:.0f} "
                f"frames/s, {dec / step_s:.0f} decoder tokens/s")

    counts, step_s, peak, _ = _train_and_profile(
        cfg, n, f"{cfg.name} {cfg.num_encoder_layers}+{cfg.num_layers} layers", smi, 64, note)
    counts = counts["flash"]
    per = _encdec_flash_per_pass(cfg)
    want = {"fwd": n["steps"] * 2 * per, "bwd": n["steps"] * per}
    if counts != want:
        fail(f"seamless training launched the flash kernels {counts} times, not {want}")
    return counts, dict(median_step_ms=step_s * 1e3, frames_per_s=frames / step_s,
                        decoder_tokens_per_s=dec / step_s, peak_gib=peak / 2**30)


def phase_seamless_serve(smi):
    """Phase 10d: seamless-m4t-large-v2 at full width and depth in bf16
    (weights drawn straight into bf16 on the card) through
    ``ServingEngine.generate``: 4 x 256 prompts fed token by token through
    ``decode_step`` against the zero encoder memory ``init_cache`` makes
    (as the reference serves it), 32 new tokens; token counts and the
    vocabulary.  The decoder's self- and cross-attention at decode run
    ``decode_attention``, plain PyTorch on every device (the reference has
    no decode kernel), so generate launches no flash kernel.  Then a
    full-depth ``forward`` of 1 x 4096 frames and 1024 tokens: finite
    logits, one flash launch per encoder layer and two per decoder layer."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serve.engine import ServingEngine

    cfg = get_config("seamless-m4t-large-v2")
    n = SEAMLESS_SERVE
    _free_card()
    torch.cuda.reset_peak_memory_stats()
    api, params = _direct_params(cfg, seed=6)
    prompts = np.random.default_rng(23).integers(0, cfg.vocab_size, (n["batch"], n["prompt"]))
    eng = ServingEngine(cfg, params, batch=n["batch"], capacity=n["prompt"] + n["new"],
                        device="cuda")
    _reset_counts()
    out = eng.generate(prompts, n["new"])
    gen_launches = dict(fa.launches)
    st = eng.stats
    ok = out.shape == (n["batch"], n["new"]) and bool(((0 <= out) & (out < cfg.vocab_size)).all())
    print(f"seamless-m4t-large-v2 ServingEngine.generate on {smi}: {n['batch']} x "
          f"{n['prompt']} prompts token by token, {n['new']} new tokens -> {out.shape}; prefill "
          f"{st.prefill_s * 1e3:.1f} ms ({st.prefill_s / n['prompt'] * 1e3:.2f} ms a token "
          f"step); decode {st.tokens_per_s:.2f} tokens/s ({st.decode_steps} steps in "
          f"{st.decode_s:.3f} s); tokens in the vocabulary: {ok}; flash launches "
          f"{gen_launches} (decode_attention is plain PyTorch)", flush=True)
    if not ok:
        fail("seamless: generate gave the wrong token count or tokens outside the vocabulary")
    if gen_launches != {"fwd": 0, "bwd": 0}:
        fail(f"seamless: token-by-token serving launched flash kernels {gen_launches}")
    eng.reset()
    del eng
    _free_card()
    batch = _seamless_batch(cfg, 1, n["frames"], seed=24)
    _reset_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        logits = api.forward(params, batch["frames"], batch["tokens"])
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    launches = dict(fa.launches)
    finite = bool(torch.isfinite(logits).all())
    peak = torch.cuda.max_memory_allocated()
    print(f"seamless-m4t-large-v2 forward 1 x {n['frames']} frames, "
          f"{n['frames'] // 4} tokens, bf16: logits {tuple(logits.shape)} finite {finite}; "
          f"{fwd_s * 1e3:.1f} ms (first call); flash launches {launches}; peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    want = {"fwd": _encdec_flash_per_pass(cfg), "bwd": 0}
    if not finite or launches != want:
        fail(f"seamless forward: finite {finite}, launches {launches} != {want}")
    del params, logits, api
    _free_card()
    return launches["fwd"], dict(prefill_ms_per_token_step=st.prefill_s / n["prompt"] * 1e3,
                                 decode_tokens_per_s=st.tokens_per_s)


def phase_pixtral(smi):
    """Phase 10e: pixtral-12b.  At full width cut to 4 layers: prefill
    logits of 1024 patch positions and 1000 text tokens through the flash
    kernel and through the plain path (``MODEL_RTOL``, same argmax).  At
    full width and depth (12.27 B params drawn straight into bf16 on the
    card): ``prefill(..., patch_embeds=)`` of 4 requests of 1024 patches
    and 1024 tokens, profiled; its last logits against
    ``forward(..., patch_embeds=)``'s last position; 32 greedy
    ``decode_step``s; then ``ServingEngine.generate`` on 4 x 512 text
    prompts (the reference's engine passes no patches); peak memory."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa

    n = PIXTRAL
    full = get_config("pixtral-12b")
    cfg4 = dataclasses.replace(full, num_layers=n["check_layers"])
    api, params = _direct_params(cfg4, seed=7)
    check = _prefill_kernel_vs_plain(cfg4, api, params, "pixtral-12b x4 layers (1024 patches)",
                                     n_patches=n["patches"])
    del api, params
    _free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    api, params = _direct_params(full, seed=8)
    torch.cuda.synchronize()
    print(f"pixtral-12b: {full.num_layers} layers d_model {full.d_model}, {full.num_heads} "
          f"heads over {full.num_kv_heads} KV heads of {full.d_head}, {full.n_params() / 1e9:.2f} "
          f"B params in {full.dtype}, drawn in {time.perf_counter() - t0:.1f} s", flush=True)
    B, P = n["batch"], n["patches"]
    rng = np.random.default_rng(25)
    tokens = torch.as_tensor(rng.integers(0, full.vocab_size, (B, P)), device="cuda")
    patches = torch.as_tensor(rng.standard_normal((B, P, full.d_model), dtype=np.float32),
                              device="cuda")
    cap = 2 * P + n["new"]
    _reset_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        last, cache = api.prefill(params, tokens, cap, patch_embeds=patches)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        del last, cache
        _profile(f"pixtral-12b prefill {B} x ({P} patches + {P} tokens)",
                 lambda: api.prefill(params, tokens, cap, patch_embeds=patches), top=10)
        t0 = time.perf_counter()
        last, cache = api.prefill(params, tokens, cap, patch_embeds=patches)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        want = api.forward(params, tokens, patch_embeds=patches)[:, -1].float()
        a = last.float()
        diff, scale = float((a - want).abs().max()), float(want.abs().max())
        same = bool((a.argmax(-1) == want.argmax(-1)).all())
        del want
        tok = a.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n["new"]):
            logits, cache = api.decode_step(params, tok, cache, 2 * P + i)
            tok = logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    launches = dict(fa.launches)
    print(f"pixtral-12b prefill with patches on {smi}: {B} x ({P} patches + {P} tokens), "
          f"cache of {cap} positions: {first_ms:.1f} ms (first call), {prefill_ms:.1f} ms "
          f"(third); last logits vs forward's last position: max abs diff {diff:.4g} (bound "
          f"{MODEL_RTOL} x max|logit| = {MODEL_RTOL * scale:.4g}), argmax same {same}; "
          f"{n['new']} decode steps {decode_s * 1e3:.1f} ms ({B * n['new'] / decode_s:.2f} "
          f"tokens/s, {n['new'] / decode_s:.2f} steps/s); flash launches {launches} (3 "
          f"prefills and 1 forward of {full.num_layers} layers)", flush=True)
    if not (bool(torch.isfinite(a).all()) and diff <= MODEL_RTOL * scale and same):
        fail("pixtral-12b: prefill with patches disagrees with forward")
    if launches != {"fwd": 4 * full.num_layers, "bwd": 0}:
        fail(f"pixtral-12b: flash launches {launches} != 4 x {full.num_layers} forward")
    del cache, last, a, logits, tok
    _free_card()
    total = launches["fwd"] + _generate_check(full, params, B, 512, n["new"], "pixtral-12b", smi)
    peak = torch.cuda.max_memory_allocated()
    print(f"pixtral-12b serving peak memory {peak / 2**30:.2f} GiB", flush=True)
    if peak >= PEAK_LIMIT:
        fail(f"pixtral-12b peak memory {peak / 2**30:.2f} GiB is not below 79 GiB")
    del params, api
    _free_card()
    return total, check, dict(prefill_ms=prefill_ms, decode_tokens_per_s=B * n["new"] / decode_s,
                              peak_gib=peak / 2**30)


def phase_pixtral_train(smi):
    """Phase 10f: pixtral-12b at full width cut to 2 layers trains 20 steps
    of 1 x 4096 positions (1024 patches, 3072 text tokens, the pipeline's
    vision batches) through ``train.loop.train``; the profiled step must
    run the ``sm90`` flash kernels at d=128."""
    from repro_torch.configs import get_config

    n = PIXTRAL_TRAIN
    cfg = dataclasses.replace(get_config("pixtral-12b"), num_layers=n["layers"])
    text = n["seq"] - max(n["seq"] // 4, 4)

    def note(step_s):
        return f"{n['batch'] * text / step_s:.0f} text tokens/s"

    counts, step_s, peak, _ = _train_and_profile(
        cfg, n, f"pixtral-12b x{n['layers']} layers (vision batches)", smi, 128, note)
    counts = counts["flash"]
    want = {"fwd": n["steps"] * 2 * cfg.num_layers, "bwd": n["steps"] * cfg.num_layers}
    if counts != want:
        fail(f"pixtral training launched the flash kernels {counts} times, not {want}")
    return counts, dict(median_step_ms=step_s * 1e3, peak_gib=peak / 2**30)


def phase_vgg(smi):
    """Phase 10g: VGG-16 (the paper's model) at its Fig 9a global batch of
    32, 224 x 224 x 3 images, fp32 with TF32 off (phase 1).  Loss and every
    gradient at batch 4 against the same module run in fp64 on the card
    (``VGG_TOL``); then 10 steps of the port's ``adamw`` on one fixed
    seeded batch of 32: finite, falling loss, the median forward+backward
    time and peak memory, beside the iteration time the port's planner
    predicts for ``build_vgg_graph(VCFG, 32)`` on one ``H100`` (printed,
    not enforced)."""
    import torch

    from repro_torch.configs.vgg16 import CONFIG as VCFG
    from repro_torch.core.costmodel import H100
    from repro_torch.core.planner import plan
    from repro_torch.models import vgg
    from repro_torch.models.graph import build_vgg_graph
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.optim.optimizer import adamw, constant_schedule

    n = VGG_RUN
    dev = torch.device("cuda")
    _free_card()
    torch.cuda.reset_peak_memory_stats()
    params = vgg.init(torch.Generator(device=dev).manual_seed(9), VCFG, dev)
    rng = np.random.default_rng(32)
    images = torch.as_tensor(rng.standard_normal((n["batch"], VCFG.image_size,
                                                  VCFG.image_size, 3), dtype=np.float32),
                             device=dev)
    labels = torch.as_tensor(rng.integers(0, VCFG.num_classes, (n["batch"],)), device=dev)

    def loss_and_grads(p, batch):
        leaves = [x.requires_grad_() for x in tree_leaves(p)]
        loss, _ = vgg.loss_fn(p, batch, VCFG)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    b = n["check_batch"]
    small = {"images": images[:b], "labels": labels[:b]}
    loss32, g32 = loss_and_grads(params, small)
    p64 = tree_map(lambda x: x.detach().double(), params)
    small64 = {"images": small["images"].double(), "labels": small["labels"]}
    loss64, g64 = loss_and_grads(p64, small64)
    with torch.no_grad():
        z32, z64 = vgg.forward(params, small["images"], VCFG), vgg.forward(p64, small64["images"],
                                                                            VCFG)
    rel = abs(float(loss32) - float(loss64)) / abs(float(loss64))
    logits_rel = float((z32.double() - z64).norm() / z64.norm())
    diffs = [float((a.double() - w).norm() / w.norm()) for a, w in zip(g32, g64)]
    names = [f"{k}/{leaf}" for k in sorted(params) for leaf in sorted(params[k])]
    worst = max(diffs)
    print(f"vgg16 at batch {b}, fp32 (TF32 off) vs fp64 on the card: loss {float(loss32):.8f} "
          f"vs {float(loss64):.8f} (rel diff {rel:.3g}, bound {VGG_TOL['loss']}); logits rel L2 "
          f"{logits_rel:.3g} (bound {VGG_TOL['logits']}); gradients rel L2, worst "
          f"{worst:.3g} ({names[diffs.index(worst)]}; bound {VGG_TOL['grad']}) over "
          f"{len(diffs)} leaves: " + ", ".join(f"{k} {d:.3g}" for k, d in zip(names, diffs)
                                               if k.endswith("/w")), flush=True)
    if not (rel <= VGG_TOL["loss"] and logits_rel <= VGG_TOL["logits"]
            and worst <= VGG_TOL["grad"]):
        fail("vgg16: fp32 loss, logits or gradients disagree with fp64")
    # where cuDNN's fp32 gradients stand: the same module through PyTorch's
    # own convolutions (cuDNN off), in fp32 and in fp64, and with TF32 on
    others = {}
    flags = torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32
    for label, p, batch, enabled, tf32 in (
            ("fp32 without cuDNN", params, small, False, False),
            ("fp64 without cuDNN", p64, small64, False, False),
            ("fp32 cuDNN with TF32", params, small, True, True)):
        torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32 = enabled, tf32
        try:
            g = loss_and_grads(p, batch)[1]
        finally:
            torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32 = flags
        others[label] = max(float((a.double() - w).norm() / w.norm()) for a, w in zip(g, g64))
        del g
    print("  worst gradient rel L2 against fp64 with cuDNN: " + ", ".join(
        f"{k} {v:.3g}" for k, v in others.items()), flush=True)
    del p64, g64, g32, z32, z64
    _free_card()
    opt = adamw(constant_schedule(n["lr"]))
    state = opt.init(params)
    batch = {"images": images, "labels": labels}
    ordered = {k: {leaf: params[k][leaf] for leaf in sorted(params[k])} for k in sorted(params)}
    losses, fb_ms = [], []
    for _ in range(n["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(params, batch)
        torch.cuda.synchronize()
        fb_ms.append((time.perf_counter() - t0) * 1e3)
        it = iter(grads)  # tree_leaves' order: sorted keys
        params, state = opt.update(tree_map(lambda _: next(it), ordered), state, params)
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    graph = build_vgg_graph(VCFG, n["batch"])
    predicted_ms = plan(graph, 1, amp_limit=2.0, hw=H100).total_time * 1e3
    flops = 3 * sum(x.flops for x in graph)  # forward + backward, the graph's count
    fb = float(np.median(fb_ms))
    print(f"vgg16 on {smi}: {n['steps']} AdamW steps (lr {n['lr']}) on one batch of "
          f"{n['batch']} x {VCFG.image_size} x {VCFG.image_size} x 3, fp32: losses "
          f"{[round(x, 4) for x in losses]}; forward+backward median {fb:.2f} ms (times "
          f"{[round(t, 2) for t in fb_ms]} ms; {flops / (fb * 1e-3) / 1e12:.1f} TFLOP/s of the "
          f"graph's {flops / 1e12:.3f} TFLOP); peak memory {peak / 2**30:.2f} GiB; the port's "
          f"planner predicts {predicted_ms:.2f} ms an iteration on one H100 (not enforced)",
          flush=True)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"vgg16: losses not finite and falling: {losses}")
    del params, state, grads, images
    _free_card()
    return dict(fwd_bwd_ms=fb, predicted_ms=predicted_ms, peak_gib=peak / 2**30,
                fp64_loss_rel=rel, fp64_logits_rel_l2=logits_rel, fp64_grad_worst_rel_l2=worst,
                **{f"fp64_grad_worst_rel_l2 ({k})": v for k, v in others.items()})


# ---------------------------------------------------------------------------
# Slice 8: multi-device (the sharded steps on a (1, 1) mesh of the one card)
# ---------------------------------------------------------------------------

SHARDED_TRAIN = dict(steps=8, batch=4, seq=4096)  # 11b: phase 5q's recipe, 8 steps
FAMILY_TRAIN = dict(steps=3, batch=1, seq=4096)   # 11c: a warm-up step, then 2
FAMILIES = (  # (arch, overrides: full width, depth cut), 11c
    ("rwkv6-1.6b", dict(num_layers=4)),
    ("zamba2-2.7b", dict(num_layers=7)),  # the shared block runs at layers 0 and 6
    ("qwen3-moe-30b-a3b", dict(num_layers=2)),
    ("seamless-m4t-large-v2", dict(num_layers=2, num_encoder_layers=2)),
    ("pixtral-12b", dict(num_layers=2)),
)
POWERSGD = dict(steps=20, batch=1, seq=4096, layers=2, rank=4)  # 11d
POWERSGD_TOL = 1e-4  # fp32 approximation vs fp64, of each leaf's largest magnitude


def phase_mesh():
    """Phase 11a: a one-rank NCCL group (a ``HashStore``, no port) and the
    (1, 1) ``(data, model)`` mesh over the card; qwen2-1.5b's rules and
    parameter specs on it (equal to those of an abstract (1, 1) mesh), then
    on the abstract (16, 16) and (2, 16, 16) production meshes, train and
    decode layouts, with the divisibility guard's drops."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import DECODE_32K, TRAIN_4K, get_config
    from repro_torch.dist.sharding import RuleReport, param_pspecs, sharding_rules
    from repro_torch.launch.mesh import AbstractMesh, make_mesh, make_production_mesh
    from repro_torch.models.api import get_model
    from repro_torch.models.layers import tree_leaves

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=dev)
    mesh = make_mesh(1, 1)
    cfg = get_config("qwen2-1.5b")
    api = get_model(cfg)
    abstract = AbstractMesh((1, 1), ("data", "model"))
    if sharding_rules(cfg, mesh, TRAIN_4K) != sharding_rules(cfg, abstract, TRAIN_4K):
        fail("mesh: the card's (1, 1) DeviceMesh gives other rules than an abstract one")
    out = {}
    for label, m in (("1x1 (the card)", mesh), ("16x16", make_production_mesh()),
                     ("2x16x16", make_production_mesh(multi_pod=True))):
        for shape in (TRAIN_4K, DECODE_32K):
            rep = RuleReport()
            rules = sharding_rules(cfg, m, shape)
            specs = tree_leaves(param_pspecs(api.schema, rules, m, rep))
            split = sum(1 for sp in specs if any(e is not None for e in sp))
            out[f"{label} {shape.name}"] = dict(split_leaves=split, leaves=len(specs),
                                                dropped=len(rep.dropped))
            print(f"mesh {label} ({type(m).__name__}) {shape.name}: "
                  f"{ {k: v for k, v in rules.items() if v} }; {split} of {len(specs)} "
                  f"parameter leaves split; {len(rep.dropped)} rules dropped "
                  f"{sorted(set(rep.dropped))}", flush=True)
    return mesh, out


def _train_pair(cfg, n, mesh, label):
    """``n["steps"]`` steps of ``train.loop.train`` through the sharded step
    on ``mesh`` (launch counts reset just before and read just after), then
    the same through the plain step; fails unless every loss is bit-identical
    (world size 1: the same kernels on the same shards).  Returns (launch
    counts of the sharded run, its median step s and peak bytes, the plain
    run's median and peak, the step times (s) of each, the sharded run's
    losses)."""
    import torch

    from repro_torch.configs import TRAIN_4K
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.train.loop import TrainConfig, train

    shape = dataclasses.replace(TRAIN_4K, seq_len=n["seq"], global_batch=n["batch"],
                                name="smoke")
    tc = TrainConfig(steps=n["steps"], seed=0, max_failures=0)
    runs = {}
    for kind in ("sharded", "plain"):
        _free_card()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        rep = train(cfg, shape, tc, device="cuda", mesh=mesh if kind == "sharded" else None)
        counts = dict(_counts(), wkv=dict(wk.launches))
        runs[kind] = (rep.losses, float(np.median(rep.step_times)),
                      torch.cuda.max_memory_allocated(), counts, rep.step_times)
        if rep.steps_done != n["steps"] or not np.isfinite(rep.losses).all():
            fail(f"{label} ({kind}): {rep.steps_done} steps, losses {rep.losses}")
        del rep
    _free_card()
    (ls, ss, ps, cs, ts), (lp, sp, pp, _, tp) = runs["sharded"], runs["plain"]
    print(f"  {label}: sharded losses {[round(x, 5) for x in ls]}; plain "
          f"{[round(x, 5) for x in lp]}; median step sharded {ss * 1e3:.1f} ms, plain "
          f"{sp * 1e3:.1f} ms (steps sharded {[round(t * 1e3, 1) for t in ts]}, plain "
          f"{[round(t * 1e3, 1) for t in tp]} ms); peak sharded {ps / 2**30:.2f} GiB, plain "
          f"{pp / 2**30:.2f} GiB; launches {cs}", flush=True)
    if ls != lp:
        fail(f"{label}: the sharded step's losses {ls} are not the plain step's {lp}")
    return cs, ss, ps, sp, pp, ts, tp, ls


def phase_sharded_train(mesh, smi):
    """Phase 11b, the slice's main path: qwen2-1.5b at full width and depth
    (phase 5q's recipe: 4 x 4096, fp32 params, bf16 compute, AdamW, per-layer
    remat) trains 8 steps through ``train.loop.train(..., mesh=)`` and
    ``jit_train_step`` on the (1, 1) mesh, parameters and AdamW state as
    DTensors, each layer gathered inside its remat function; then 8 steps
    through the plain step.  Losses bit-identical; flash launches 56
    forward and 28 backward a step on the sharded run."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen2-1.5b")
    n = SHARDED_TRAIN
    counts, ss, ps, sp, pp, _, _, losses = _train_pair(cfg, n, mesh,
                                                       f"train {cfg.name} sharded (11b)")
    want = {"fwd": n["steps"] * 2 * cfg.num_layers, "bwd": n["steps"] * cfg.num_layers}
    if counts["flash"] != want or any(counts["ssd"].values()):
        fail(f"11b: launches {counts} != flash {want}")
    tokens = n["batch"] * n["seq"]
    print(f"sharded train on {smi}: {cfg.name} {n['steps']} steps of {n['batch']} x "
          f"{n['seq']}: median step {ss * 1e3:.1f} ms ({tokens / ss:.0f} tokens/s), peak "
          f"{ps / 2**30:.2f} GiB; the plain step {sp * 1e3:.1f} ms ({tokens / sp:.0f} "
          f"tokens/s), peak {pp / 2**30:.2f} GiB", flush=True)
    return counts["flash"], dict(median_step_ms=ss * 1e3, tokens_per_s=tokens / ss,
                                 peak_gib=ps / 2**30, plain_median_step_ms=sp * 1e3,
                                 plain_tokens_per_s=tokens / sp,
                                 plain_peak_gib=pp / 2**30), losses


def phase_sharded_families(mesh, smi):
    """Phase 11c: every other family through the sharded step against the
    plain step, at full width cut in depth (``FAMILIES``), 3 steps of 1 x
    4096 each: losses bit-identical; the WKV-6 (rwkv6), SSD (zamba2) and
    flash kernels launch in the sharded run.  The first step (the warm-up:
    DTensor's sharding propagation, caching allocator growth) is reported
    apart from the median of the steps after it."""
    from repro_torch.configs import get_config

    out, launches = {}, {}
    for arch, cut in FAMILIES:
        cfg = dataclasses.replace(get_config(arch), **cut)
        label = f"{arch} x{cfg.num_layers}" + (f"+{cfg.num_encoder_layers}"
                                               if cfg.num_encoder_layers else "")
        counts, _, ps, _, pp, ts, tp, _ = _train_pair(cfg, FAMILY_TRAIN, mesh,
                                                      f"11c {label}")
        need = {"rwkv6-1.6b": ["wkv"], "zamba2-2.7b": ["ssd", "flash"]}.get(arch, ["flash"])
        if any(counts[k]["fwd"] == 0 or counts[k]["bwd"] == 0 for k in need):
            fail(f"11c {label}: the sharded step launched {counts}, none of {need}")
        launches[label] = counts
        out[label] = dict(steady_median_step_ms=float(np.median(ts[1:])) * 1e3,
                          plain_steady_median_step_ms=float(np.median(tp[1:])) * 1e3,
                          first_step_ms=ts[0] * 1e3, plain_first_step_ms=tp[0] * 1e3,
                          peak_gib=ps / 2**30, plain_peak_gib=pp / 2**30)
    print(f"sharded families on {smi}: {json.dumps(out)}", flush=True)
    return launches, out


def _powersgd_plain64(grads, state, rank):
    """One PowerSGD round of ``compress_decompress`` in fp64 on the card
    (no group): the reference's formulas, for phase 11d."""
    import torch

    out = {}
    for k, g in grads.items():
        gf = g.double() + state[k]["err"].double()
        m2 = gf.reshape(1, -1) if gf.dim() == 1 else gf.reshape(-1, gf.shape[-1])
        if min(m2.shape) <= rank:
            out[k] = gf
            continue
        p, _ = torch.linalg.qr(m2 @ state[k]["q"].double())
        out[k] = (p @ (m2.T @ p).T).reshape(gf.shape)
    return out


def phase_powersgd(smi):
    """Phase 11d: qwen2-1.5b at full width cut to 2 layers trains 20 steps
    of 1 x 4096 through ``make_train_step(grad_transform=)`` with PowerSGD
    rank 4 and error feedback: losses finite and falling.  Then one round of
    ``compress_decompress`` on one step's gradients against an fp64 replica
    (``POWERSGD_TOL``), its time per step (CUDA events) and
    ``compression_ratio``."""
    import torch

    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.api import get_model
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim import grad_compression as gc
    from repro_torch.optim.optimizer import make_optimizer
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_train_step

    n = POWERSGD
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=n["layers"])
    api, opt = get_model(cfg), make_optimizer(cfg, total_steps=n["steps"])
    dev = torch.device("cuda")
    _free_card()
    state = init_state(api, opt, torch.Generator(device=dev).manual_seed(0), dev)
    holder = {"st": gc.init_state(state["params"], rank=n["rank"])}

    def transform(grads):
        approx, holder["st"] = gc.compress_decompress(grads, holder["st"], rank=n["rank"])
        return approx

    step = make_train_step(api, opt, grad_transform=transform)
    data = SyntheticLMData(cfg, n["batch"], n["seq"], seed=0, device=dev)
    losses = []
    t0 = time.perf_counter()
    for _ in range(n["steps"]):
        state, m = step(state, next(data))
        losses.append(float(m["loss"]))
    wall = time.perf_counter() - t0
    data.close()
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"11d: PowerSGD losses not finite and falling: {losses}")
    params = state["params"]
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    data = SyntheticLMData(cfg, n["batch"], n["seq"], seed=1, device=dev)
    batch = next(data)
    data.close()
    loss, _ = api.loss(params, batch)
    grads = dict(zip(flatten(params), torch.autograd.grad(loss, leaves)))
    st = {k: v for k, v in flatten(holder["st"]).items()}
    st = {k: {"q": st[k + "/q"], "err": st[k + "/err"]} for k in grads}
    got, _ = gc.compress_decompress(grads, st, rank=n["rank"])
    want = _powersgd_plain64(grads, st, n["rank"])
    worst = max(float((got[k].double() - want[k]).abs().max() / want[k].abs().max())
                for k in grads)
    ms = _time_ms(lambda: gc.compress_decompress(grads, st, rank=n["rank"]), reps=10)
    ratio = gc.compression_ratio(params, rank=n["rank"])
    print(f"powersgd on {smi}: {cfg.name} x{cfg.num_layers} layers, rank {n['rank']}, "
          f"{n['steps']} steps of {n['batch']} x {n['seq']}: losses "
          f"{[round(x, 4) for x in losses]} ({wall:.1f} s); compress_decompress "
          f"{ms:.3f} ms a step over {len(grads)} leaves; compression ratio {ratio:.5f}; "
          f"vs fp64 worst {worst:.3g} of the leaf's largest (tol {POWERSGD_TOL})", flush=True)
    if not worst <= POWERSGD_TOL:
        fail(f"11d: compress_decompress differs from fp64 by {worst:.3g}")
    del state, params, grads, st, got, want, holder
    _free_card()
    return dict(compress_ms=ms, compression_ratio=ratio, fp64_worst=worst,
                first_loss=losses[0], last_loss=losses[-1])


def phase_disaggregated(cfg, smi, tokens5, stats5):
    """Phase 11e: llama3-8b at full width and depth (phase 5's weights,
    drawn anew from the same seed) serves phase 5's trace through
    ``ContinuousBatchingEngine(submeshes=split_mesh_for_serving(1, [card,
    card]))`` + ``ContinuousScheduler``: prefill on one slice's stream,
    decode on the other's, the pages handed off at each admit.  Every
    request's tokens equal phase 5's; no page leaks; one flash launch per
    prefill and layer; the median handoff per admit."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import split_mesh_for_serving
    from repro_torch.models.api import get_model
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.serve.scheduler import ContinuousScheduler
    from repro_torch.serve.trace import materialize_requests

    dev = torch.device("cuda", torch.cuda.current_device())
    _free_card()
    api = get_model(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0), dev, dtype=cfg.dtype)
    sm = split_mesh_for_serving(1, devices=[dev, dev])
    eng = ContinuousBatchingEngine(cfg, params, lanes=4, n_pages=545, page_tokens=16,
                                   lane_capacity=2176, submeshes=sm)
    del params
    _free_card()
    if eng.prefill_stream == eng.decode_stream or eng.params_prefill is not eng.params:
        fail("11e: the slices share a stream, or the card holds two copies of the weights")
    reqs = materialize_requests(slice_trace(cfg.vocab_size))
    fa.launches.update(fwd=0, bwd=0)
    rep = ContinuousScheduler(eng).run(reqs)
    launches = fa.launches["fwd"]
    got = {r.rid: tuple(r.tokens) for r in rep.completed}
    if got != tokens5:
        diff = sorted(k for k in tokens5 if got.get(k) != tokens5[k])
        fail(f"11e: disaggregated tokens differ from phase 5's for requests {diff}")
    if eng.alloc.used_pages != 0:
        fail(f"11e: {eng.alloc.used_pages} pages leaked")
    if fa.launches["bwd"] or launches != eng.stats.prefills * cfg.num_layers:
        fail(f"11e: flash launches {fa.launches} != {eng.stats.prefills} x {cfg.num_layers}")
    st = eng.stats
    handoff = float(np.median(eng.handoff_s)) * 1e3
    out = dict(requests=len(rep.completed), prefill_ms=st.prefill_s / st.prefills * 1e3,
               decode_tokens_per_s=st.tokens_per_s, handoff_ms_median=handoff,
               handoffs=len(eng.handoff_s), ttft_p50_ms=rep.ttft_percentile(50) * 1e3,
               phase5_prefill_ms=stats5.prefill_s / stats5.prefills * 1e3,
               phase5_decode_tokens_per_s=stats5.tokens_per_s)
    print(f"disaggregated serve on {smi}: {json.dumps(out)}; tokens equal phase 5's; "
          f"launches {launches}", flush=True)
    del eng
    _free_card()
    return launches, out


# ---------------------------------------------------------------------------
# Slice 9: the live control plane (phase 12a)
# ---------------------------------------------------------------------------

LIVE_STEPS = 8  # 12a: 11b's run, through the live loop
LIVE_PHANTOMS = (4, 5, 6, 7)  # virtual workers that beat once, then fall silent
# 12a's two runs: every control-plane field with the lease; then the same
# without the lease, and a RuntimeError at step 6 (no checkpoint: the loop
# restarts fresh).  The reference cannot take the fault with the lease: the
# bootstrap joins every healthy id, ids 1-7 are detected in one pump, the
# pool becomes [0], and the fail-stop report of worker 0 empties it (its
# planner raises IndexError on 0 devices); before the detection, the
# re-plans that follow it drop id 0 and the one-rank re-carve raises
LIVE_RUNS = {"lease": dict(lease=True, fault_step=None),
             "fail-stop": dict(lease=False, fault_step=6)}
# the event counts the reference's loop gives on each run's script
# (tests/test_torch_live_script.py holds the reference to them on the CPU)
LIVE_EVENTS = {
    "lease": {"join": 0, "straggler_worker": 7, "failure_detected": 7, "replan": 7,
              "reconfig": 7, "failure": 0, "coordinator_failover": 1},
    "fail-stop": {"join": 4, "straggler_worker": 4, "failure_detected": 4, "replan": 5,
                  "reconfig": 4, "failure": 1, "coordinator_failover": 0},
}


def live_script(m, cfg, client, run):
    """Phase 12a's control plane for one run of ``LIVE_RUNS``, built from
    the modules in ``m`` (a namespace of the port's classes; the CPU test
    passes the reference's): ``ClusterCoordinator(8, virtual_devices=True)``
    on a scripted clock with ``cfg``'s ``TRAIN_4K`` graph as the
    foreground, ``HeartbeatMonitor(1, timeout=5)``, worker and coordinator
    ends that are two ``KVStoreTransport``s over ``client``,
    ``CoordinatorLoop(gc_every=2)``, the lease when the run has one,
    ``apply_reconfig`` and ``admit_every=4``; the phantoms beat once.  The
    clock advances one unit per call of the injector, the failed call
    included, so it never goes back when the loop restarts.  Returns
    (TrainConfig, injector, coordinator end)."""
    spec = LIVE_RUNS[run]
    clk = {"t": 0.0}

    def clock():
        return clk["t"]

    worker_end = m.KVStoreTransport(f"live-{run}", client=client, uid="worker")
    coord_end = m.KVStoreTransport(f"live-{run}", client=client, uid="coordinator")
    coord = m.ClusterCoordinator(8, clock=clock, virtual_devices=True)
    coord.submit_foreground(m.Job(cfg.name, "foreground", m.build_lm_graph(cfg, m.TRAIN_4K)))
    mon = m.HeartbeatMonitor(1, timeout=5.0, clock=clock)
    loop = m.CoordinatorLoop(coord_end, mon, coordinator=coord, gc_every=2)
    lease = m.CoordinatorLease(coord_end, 0, timeout=5.0, clock=clock) if spec["lease"] else None
    for w in LIVE_PHANTOMS:
        m.WorkerClient(worker_end, w).beat(0)
    fired = []

    def injector(step):
        clk["t"] += 1.0
        if step == spec["fault_step"] and not fired:
            fired.append(step)
            raise RuntimeError(f"injected fault at step {step}")

    tc = m.TrainConfig(steps=LIVE_STEPS, seed=0, max_failures=1, coordinator=coord,
                       heartbeat=mon, transport=worker_end, control_loop=loop, lease=lease,
                       apply_reconfig=True, admit_every=4)
    return tc, injector, coord_end


def live_counts(report) -> dict:
    return {k: report.mitigations.count(k) for k in LIVE_EVENTS["lease"]}


def phase_live_loop(mesh, smi, losses11b, median11b_ms):
    """Phase 12a: qwen2-1.5b at full width and depth, 11b's 8 steps of 4 x
    4096 with 11b's seed, through ``train(..., mesh=)`` on the (1, 1) mesh
    with the live control plane wired (``live_script``), the two
    ``KVStoreTransport`` ends over one ``TCPStore`` on localhost (the
    multi-host transport).  Each run: every loss bit-identical to 11b's at
    the same step (the fail-stop run's restarted pass included: the control
    plane touches no arithmetic), the event counts equal to the
    reference's, no re-carve (the pool maps onto the one rank), the
    heartbeat topic compacted, 56 forward and 28 backward flash launches a
    step.  The control plane runs on the host after each step's loss is
    read, outside the step time the loop records, while the card waits:
    its cost is the host time of its calls (the beat, the lease tick, the
    pump, the reconfiguration poll, admission), timed here by wrapping
    them, per step; beside it the median step period (from one injector
    call to the next) minus the median step, and the median step minus
    11b's."""
    import datetime
    import types

    import torch
    import torch.distributed as dist

    from repro_torch.configs import TRAIN_4K, get_config
    from repro_torch.core.coordinator import ClusterCoordinator, Job
    from repro_torch.dist.faults import HeartbeatMonitor
    from repro_torch.dist.transport import (
        HEARTBEAT_TOPIC,
        CoordinatorLease,
        CoordinatorLoop,
        KVStoreTransport,
        WorkerClient,
    )
    from repro_torch.models.graph import build_lm_graph
    from repro_torch.train.loop import TrainConfig, train

    m = types.SimpleNamespace(
        KVStoreTransport=KVStoreTransport, ClusterCoordinator=ClusterCoordinator, Job=Job,
        build_lm_graph=build_lm_graph, TRAIN_4K=TRAIN_4K, HeartbeatMonitor=HeartbeatMonitor,
        CoordinatorLoop=CoordinatorLoop, CoordinatorLease=CoordinatorLease,
        WorkerClient=WorkerClient, TrainConfig=TrainConfig)
    cfg = get_config("qwen2-1.5b")
    n = SHARDED_TRAIN
    shape = dataclasses.replace(TRAIN_4K, seq_len=n["seq"], global_batch=n["batch"],
                                name="smoke")
    store = dist.TCPStore("localhost", 0, 1, True, timeout=datetime.timedelta(seconds=30))
    out, launches = {}, {"fwd": 0, "bwd": 0}
    for run, spec in LIVE_RUNS.items():
        tc, injector, coord_end = live_script(m, cfg, store, run)
        spent, calls = [], []  # control-plane seconds; injector call times
        for obj, name in ((tc.transport, "publish"), (tc.transport, "poll"),
                          (tc.control_loop, "pump"), (tc.control_loop, "bootstrap_from_log"),
                          (tc.coordinator, "readmit"), (tc.lease, "tick")):
            if obj is not None:
                setattr(obj, name, _timed(getattr(obj, name), spent))

        def timed_injector(step, inner=injector):
            calls.append(time.perf_counter())
            inner(step)

        _free_card()
        _reset_counts()
        rep = train(cfg, shape, tc, fault_injector=timed_injector, device="cuda", mesh=mesh)
        counts = _counts()
        want = (losses11b if spec["fault_step"] is None
                else losses11b[:spec["fault_step"]] + losses11b)
        got = live_counts(rep)
        lw = coord_end.low_water(HEARTBEAT_TOPIC)
        backlog = len(coord_end.poll(HEARTBEAT_TOPIC, lw))
        med = float(np.median(rep.step_times)) * 1e3
        period = float(np.median(np.diff(calls))) * 1e3
        plane = 1e3 * sum(d for _, d in spent) / len(rep.losses)
        # each call's time, by the step period (injector call to injector
        # call) it fell in: the control plane's median and largest share
        by_step = np.zeros(len(calls))
        for t, d in spent:
            by_step[max(0, int(np.searchsorted(calls, t)) - 1)] += d
        plane_med, plane_max = 1e3 * float(np.median(by_step)), 1e3 * float(by_step.max())
        print(f"  12a {run}: losses {[round(x, 5) for x in rep.losses]}; events {got}, the "
              f"reference's {LIVE_EVENTS[run]}; remeshes {rep.remeshes}; heartbeat low-water "
              f"{lw}, backlog {backlog}; median step {med:.1f} ms (steps "
              f"{[round(t * 1e3, 1) for t in rep.step_times]}), median period {period:.1f} ms; "
              f"control plane {plane:.3f} ms a step (median {plane_med:.3f}, largest "
              f"{plane_max:.3f}; {len(spent)} calls); launches {counts['flash']}", flush=True)
        if rep.losses != want:
            fail(f"12a {run}: losses {rep.losses} are not 11b's {want}")
        if got != LIVE_EVENTS[run]:
            fail(f"12a {run}: events {got} != the reference's {LIVE_EVENTS[run]}")
        if rep.remeshes != 0 or rep.left_mesh:
            fail(f"12a {run}: re-carved {rep.remeshes} times on a pool of one rank")
        if lw == 0 or backlog > 4:
            fail(f"12a {run}: heartbeat topic not compacted (low-water {lw}, backlog {backlog})")
        steps = len(rep.losses)
        if counts["flash"] != {"fwd": steps * 2 * cfg.num_layers, "bwd": steps * cfg.num_layers}:
            fail(f"12a {run}: {steps} steps launched {counts['flash']}")
        for k in launches:
            launches[k] += counts["flash"][k]
        out[run] = dict(events=got, median_step_ms=med, step_minus_11b_ms=med - median11b_ms,
                        median_period_ms=period, period_minus_step_ms=period - med,
                        control_plane_ms_per_step=plane, control_plane_median_ms=plane_med,
                        control_plane_max_ms=plane_max, control_plane_calls=len(spent),
                        heartbeat_low_water=lw, heartbeat_backlog=backlog, steps=steps)
        del rep
    del store
    _free_card()
    print(f"live loop on {smi}: qwen2-1.5b, 4 x 4096; control plane a step (mean), median period "
          f"minus median step, median step minus 11b's ({median11b_ms:.1f} ms): " + "; ".join(
              f"{k} {v['control_plane_ms_per_step']:.3f} ms (median "
              f"{v['control_plane_median_ms']:.3f}), {v['period_minus_step_ms']:+.1f} "
              f"ms, {v['step_minus_11b_ms']:+.1f} ms" for k, v in out.items()), flush=True)
    return launches, out


def _timed(fn, spent):
    """``fn``, adding (start, host seconds) of each call to ``spent``."""
    def call(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            spent.append((t0, time.perf_counter() - t0))

    return call


def _require_flash_sm90(label, rows, d=128):
    """Fails unless a profiled step ran the ``wgmma`` flash forward and
    both backward kernels at head dim ``d`` (and no fp32 FMA flash kernel)."""
    ran = {k: v for k, v in rows.items() if "flash_" in k}
    print("  flash kernels in the step: " + "; ".join(
        f"{k[:70]} x{c} {ms:.2f} ms" for k, (c, ms) in sorted(ran.items(), key=lambda x: -x[1][1])))
    fwd = [k for k in ran if f"flash_fwd_sm90<{d}," in k]
    missing = [name for name in FLASH_SM90[1:] if not any(f"{name}<{d}," in k for k in ran)]
    if not fwd or missing:
        fail(f"the {label} step ran no flash_fwd_sm90<{d}> ({fwd}) or misses {missing} at "
             f"d={d}")
    if any("f32" in k or "flash_bwd_dq<" in k or "flash_bwd_dkdv<" in k for k in ran):
        fail(f"the {label} step ran an fp32 flash kernel: {sorted(ran)}")


def main() -> None:
    name, smi = phase_device()

    import torch

    from repro_torch.configs import get_config

    phase_build()
    planning = phase_plan(smi)
    cfg = get_config("llama3-8b")
    flash = phase_kernels([r["prompt_len"] for r in slice_trace(cfg.vocab_size).requests])
    wkv_fwd, wkv_bwd = phase_wkv6()
    ssd_fwd, ssd_bwd = phase_ssd()
    flash["d80"], flash_bwd = phase_flash_bwd()
    flash["qwen2"], flash_bwd["qwen2"] = phase_flash_qwen2()
    phase_model(cfg)
    serve_launches, eng, rep5 = phase_slice(cfg, smi)
    stats5 = dataclasses.replace(eng.stats)  # phase 6 resets the engine
    tokens5 = {r.rid: tuple(r.tokens) for r in rep5.completed}
    ttft5 = (rep5.ttft_percentile(50), rep5.ttft_percentile(99))
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
    phase_qwen_model()
    qwen = phase_qwen_train(smi)
    quick = phase_quickstart()
    alone = phase_bg_tenants()
    fg_mux, bg_mux, _ = phase_multiplex_train(smi)
    bg_exec, _ = phase_run_executable()
    serve_adm = phase_admission(cfg, smi, stats5, ttft5)
    flash["softcap"], flash_bwd["softcap"], sweep_n = phase_softcap()
    phase_moe_model()
    serve_moe = phase_moe_slice(smi)
    serve_grok = phase_grok(smi)
    phase_recurrent_serving(smi)
    big = phase_big_train(smi)
    flash["seamless"], flash_bwd["seamless"] = phase_flash_seamless()
    sm_check = phase_seamless_model()
    sm_train, sm_train_stats = phase_seamless_train(smi)
    sm_fwd, sm_serve = phase_seamless_serve(smi)
    px_serve, px_check, px_stats = phase_pixtral(smi)
    px_train, px_train_stats = phase_pixtral_train(smi)
    vgg_stats = phase_vgg(smi)
    mesh, mesh_rules = phase_mesh()
    sharded, sharded_stats, losses11b = phase_sharded_train(mesh, smi)
    fam_counts, fam_stats = phase_sharded_families(mesh, smi)
    psgd = phase_powersgd(smi)
    disagg, disagg_stats = phase_disaggregated(cfg, smi, tokens5, stats5)
    live, live_stats = phase_live_loop(mesh, smi, losses11b, sharded_stats["median_step_ms"])
    import torch.distributed as dist

    dist.destroy_process_group()
    bg = {k: alone[k] + bg_mux[k] + bg_exec[k] for k in ("fwd", "bwd")}
    flash["launches_by_path"] = {"serve llama3-8b": serve_launches,
                                 "train zamba2-2.7b": counts["flash"]["fwd"],
                                 "train qwen2-1.5b": qwen["fwd"],
                                 "quickstart llama3-8b (reduced)": quick["fwd"],
                                 "train qwen2-1.5b multiplexed (fg)": fg_mux["fwd"],
                                 "bg tenants": bg["fwd"],
                                 "serve llama3-8b with admission": serve_adm,
                                 "serve qwen3-moe-30b-a3b": serve_moe,
                                 "serve grok-1-314b (4 layers)": serve_grok,
                                 "train qwen3-moe-30b-a3b (2 layers)":
                                     big["qwen3-moe-30b-a3b"]["fwd"],
                                 "train qwen2-72b (2 layers)": big["qwen2-72b"]["fwd"],
                                 "seamless-m4t-large-v2 x4+4 layers (check)": sm_check["fwd"],
                                 "train seamless-m4t-large-v2": sm_train["fwd"],
                                 "serve seamless-m4t-large-v2 (forward)": sm_fwd,
                                 "pixtral-12b x4 layers (check)": px_check,
                                 "serve pixtral-12b": px_serve,
                                 "train pixtral-12b (2 layers)": px_train["fwd"],
                                 "train qwen2-1.5b sharded (11b)": sharded["fwd"],
                                 **{f"train {k} sharded (11c)": c["flash"]["fwd"]
                                    for k, c in fam_counts.items() if c["flash"]["fwd"]},
                                 "serve llama3-8b disaggregated (11e)": disagg,
                                 "train qwen2-1.5b live loop (12a)": live["fwd"]}
    # seamless's token-by-token serving (10d) decodes through
    # ``decode_attention``, plain PyTorch on every device as the reference has
    # no decode kernel: no flash launch, so no entry
    flash_bwd["launches_by_path"] = {"train zamba2-2.7b": counts["flash"]["bwd"],
                                     "train qwen2-1.5b": qwen["bwd"],
                                     "quickstart llama3-8b (reduced)": quick["bwd"],
                                     "train qwen2-1.5b multiplexed (fg)": fg_mux["bwd"],
                                     "bg tenants": bg["bwd"],
                                     "train qwen3-moe-30b-a3b (2 layers)":
                                         big["qwen3-moe-30b-a3b"]["bwd"],
                                     "train qwen2-72b (2 layers)": big["qwen2-72b"]["bwd"],
                                     "seamless-m4t-large-v2 x4+4 layers (check)":
                                         sm_check["bwd"],
                                     "train seamless-m4t-large-v2": sm_train["bwd"],
                                     "train pixtral-12b (2 layers)": px_train["bwd"],
                                     "train qwen2-1.5b sharded (11b)": sharded["bwd"],
                                     **{f"train {k} sharded (11c)": c["flash"]["bwd"]
                                        for k, c in fam_counts.items()
                                        if c["flash"]["bwd"]},
                                     "train qwen2-1.5b live loop (12a)": live["bwd"]}
    for rec in (flash, flash_bwd):
        rec["launches"] = sum(rec["launches_by_path"].values())
        # launches made to hold the capped kernels against the plain version
        # (phase 9a), outside every main path, so not in ``launches``
        rec["checked_launches"] = {"9a softcap sweep": sweep_n}
    for rec, fam, key, first in ((wkv_fwd, "wkv", "fwd", "train rwkv6-1.6b"),
                                 (wkv_bwd, "wkv", "bwd", "train rwkv6-1.6b"),
                                 (ssd_fwd, "ssd", "fwd", "train zamba2-2.7b"),
                                 (ssd_bwd, "ssd", "bwd", "train zamba2-2.7b")):
        rec["launches_by_path"] = {first: rec["launches"], **{
            f"train {k} sharded (11c)": c[fam][key] for k, c in fam_counts.items()
            if c[fam][key]}}
        rec["launches"] = sum(rec["launches_by_path"].values())
    slice8 = dict(mesh=mesh_rules, sharded_train=sharded_stats, families=fam_stats,
                  powersgd=psgd, disaggregated_serve=disagg_stats)
    print(f"slice9: {json.dumps(dict(live_loop=live_stats))}")
    print(f"slice8: {json.dumps(slice8)}")
    print(f"slice7: {json.dumps(dict(seamless_train=sm_train_stats, seamless_serve=sm_serve, pixtral_serve=px_stats, pixtral_train=px_train_stats, vgg16=vgg_stats))}")
    print(f"planning: {json.dumps(planning)}")
    print(f"card: {smi}")
    print(json.dumps({"kernels": [flash, flash_bwd, wkv_fwd, wkv_bwd, ssd_fwd, ssd_bwd]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
