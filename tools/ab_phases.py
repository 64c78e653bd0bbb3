#!/usr/bin/env python3
"""Host cost and times of the kernel wrappers, A/B across checkouts, on one card.

    python3 tools/ab_phases.py [--kernels-only] TREE [TREE ...]

Each TREE is the root of a checkout of this repository (its
``chip_smoke.py`` and ``src/``).  The trees run in the order given, each in
a process of its own (so list them in turns: parent, change, change,
parent), and each prints one line ``ab: {json}`` with

  - ``wrapper_us``: host microseconds per call of each kernel wrapper at a
    tiny shape (the flash forward, and the SSD and WKV-6 forwards, bf16,
    no gradient; 2000 calls issued, then one synchronisation), where the
    launch path's own cost shows;
  - ``kernel_ms``: the kernels at the shapes ``PERF.md`` section 6 times
    (the flash forward at the llama3-8b prefill, zamba2 d=80, qwen2-1.5b
    and grok-1 softcap shapes, the flash backward at the d=80 and qwen2
    shapes, the SSD and WKV-6 forwards at their slice shapes; bf16), each
    two ways: ``single``, ``chip_smoke.py``'s median of single calls
    between two CUDA events, whose window holds the wrapper's host time
    after the first event as device idle; and ``loop``, its
    ``_loop_ms``, the mean of 20 calls issued back to back between two
    events, where the host runs
    ahead of the card whenever a call's host time is shorter than its
    kernel, so the window holds the kernels alone; SDPA beside the flash
    forward, both ways;
  - ``decode_tick_ms``: ``chip_smoke.py`` phase 5's decode time per tick
    (llama3-8b at full width and depth serving its 8-request trace);
  - ``step11b_ms`` and ``plain_step_ms``: phase 11b's median sharded step
    and the plain step's (qwen2-1.5b, 8 steps of 4 x 4096 each).

``--kernels-only`` measures ``wrapper_us`` and ``kernel_ms`` alone.
Needs a CUDA card; each tree builds its own kernels into its own
``build/``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def _wrapper_us(calls=2000):
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import wkv6 as wk

    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape, dtype=bf):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    q, k = rnd(1, 16, 2, 32), rnd(1, 16, 1, 32)
    x, dt, A = rnd(1, 16, 16, 32), rnd(1, 16, 16, dtype=torch.float32).abs(), \
        -rnd(16, dtype=torch.float32).abs()
    Bm = rnd(1, 16, 16)
    r, w, u = rnd(1, 16, 2, 32), torch.rand((1, 16, 2, 32), generator=g, device="cuda").to(bf), \
        rnd(2, 32, dtype=torch.float32)
    calls_by_name = {
        "flash_fwd": lambda: fa.flash_attention(q, k, k),
        "ssd_fwd": lambda: ss.ssd(x, dt, A, Bm, Bm),
        "wkv6_fwd": lambda: wk.wkv6(r, r, r, w, u),
    }
    out = {}
    with torch.no_grad():
        for name, fn in calls_by_name.items():
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            out[name] = (time.perf_counter() - t0) / calls * 1e6
    return out


def _kernel_ms(c):
    """``kernel_ms`` of the docstring, with the tree's own ``chip_smoke``
    (``c``) giving the shapes, inputs and single-call timer."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import wkv6 as wk

    def both(fn):
        return {"single": c._time_ms(fn), "loop": c._loop_ms(fn)}

    out = {}
    flash = {"llama": (dict(c.PREFILL, window=0), 0.0), "d80": (c.FLASH_SLICE, 0.0),
             "qwen2": (c.QWEN_FLASH, 0.0), "softcap": (c.GROK_FLASH, 30.0)}
    for label, (sl, cap) in flash.items():
        B, S, H, KV, d, W = (sl[x] for x in ("B", "S", "H", "KV", "d", "window"))
        q, k, v = c._inputs(B, S, S, H, KV, d, "bfloat16", seed=1)
        with torch.no_grad():
            out[f"flash_fwd_{label}"] = both(
                lambda: fa.flash_attention(q, k, v, causal=True, window=W, softcap=cap))
            if not cap:  # d=80's window is its length: causal SDPA computes the same
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                out[f"sdpa_fwd_{label}"] = both(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=H != KV))
        if label in ("d80", "qwen2"):
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            o = fa.flash_attention(*leaves, causal=True, window=W)
            do = torch.randn_like(o)
            out[f"flash_bwd_{label}"] = both(
                lambda: torch.autograd.grad(o, leaves, do, retain_graph=True))
            del o, leaves, do
        del q, k, v
        torch.cuda.empty_cache()
    sl = c.SSD_SLICE
    x, dt, A, Bm, Cm, _ = c._ssd_inputs(*(sl[n] for n in ("B", "S", "H", "P", "N")),
                                        "bfloat16", None, False, seed=8)
    with torch.no_grad():
        out["ssd_fwd"] = both(lambda: ss.ssd(x, dt, A, Bm, Cm))
    del x, dt, A, Bm, Cm
    sl = c.WKV_SLICE
    r, k, v, w, u, _ = c._wkv_inputs(*(sl[n] for n in ("B", "S", "H", "N")), "bfloat16",
                                     None, False, seed=7)
    with torch.no_grad():
        out["wkv6_fwd"] = both(lambda: wk.wkv6(r, k, v, w, u))
    del r, k, v, w, u
    torch.cuda.empty_cache()
    return out


def run(tree: str, kernels_only: bool = False) -> None:
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import chip_smoke as c

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config

    _, smi = c.phase_device()
    c.phase_build()
    wrapper = _wrapper_us()
    kernel_ms = _kernel_ms(c)
    if kernels_only:
        print("ab: " + json.dumps(dict(tree=tree, card=smi, torch=torch.__version__,
                                       wrapper_us=wrapper, kernel_ms=kernel_ms)), flush=True)
        return
    _, eng, _ = c.phase_slice(get_config("llama3-8b"), smi)
    st = eng.stats
    tick_ms = st.decode_s / st.decode_steps * 1e3
    del eng
    c._free_card()
    mesh, _ = c.phase_mesh()
    _, stats, _ = c.phase_sharded_train(mesh, smi)
    dist.destroy_process_group()
    print("ab: " + json.dumps(dict(
        tree=tree, card=smi, torch=torch.__version__, wrapper_us=wrapper, kernel_ms=kernel_ms,
        decode_tick_ms=tick_ms, decode_steps=st.decode_steps,
        step11b_ms=stats["median_step_ms"], plain_step_ms=stats["plain_median_step_ms"])),
        flush=True)


def main(args) -> int:
    extra = ["--kernels-only"] if args[:1] == ["--kernels-only"] else []
    for tree in args[len(extra):]:
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--run", tree, *extra],
                           capture_output=True, text=True)
        lines = [x for x in r.stdout.splitlines() if x.startswith("ab: ")]
        print(lines[0] if lines else f"ab: FAILED {tree} (exit {r.returncode})\n"
              f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}", flush=True)
        if r.returncode != 0 or not lines:
            return 1
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--run"]:
        run(sys.argv[2], kernels_only=sys.argv[3:4] == ["--kernels-only"])
    else:
        raise SystemExit(main(sys.argv[1:]))
