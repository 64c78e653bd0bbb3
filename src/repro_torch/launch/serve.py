"""Serving entrypoint of the port.

  python -m repro_torch.launch.serve --arch llama3-8b [--batch 4] [--new-tokens 16]
  python -m repro_torch.launch.serve --arch llama3-8b --continuous [--qps 20]

Mirrors ``repro/launch/serve.py``: the arch's ``reduced()`` config with
random weights from a seeded ``torch.Generator``, drawn straight into the
serving dtype.  Default mode runs the fixed-batch engine: batched prefill
+ greedy decode, for every family (``attn_mlp`` and ``moe`` through their
fused prefill, pixtral-12b's without patches; ``rwkv6``, ``mamba2`` and the
encoder-decoder seamless-m4t-large-v2 feed the prompt token by token, the
latter against a zero encoder memory, as in the reference).
``--continuous`` serves a generated Poisson request trace through the
paged continuous-batching engine and reports per-request latency
percentiles; as in the reference, it takes the KV-cache families
(``attn_mlp``, ``moe``) and refuses the others.  Runs on the card;
``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse


def _setup(args):
    import torch

    from repro_torch._device import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    api = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, api.init(gen, device, dtype=cfg.dtype), device


def _run_fixed(args):
    import numpy as np

    from repro_torch.serve.engine import ServingEngine

    cfg, params, device = _setup(args)
    eng = ServingEngine(cfg, params, args.batch, args.capacity, device=device)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32
    )
    out = eng.generate(prompts, args.new_tokens)
    print(f"generated {out.shape} tokens on {device}")
    print(f"prefill {eng.stats.prefill_s*1e3:.1f} ms, "
          f"decode {eng.stats.tokens_per_s:.1f} tokens/s "
          f"({eng.stats.steps_per_s:.1f} steps/s)")


def _run_continuous(args):
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.serve.scheduler import ContinuousScheduler
    from repro_torch.serve.trace import generate_request_trace, materialize_requests

    cfg, params, device = _setup(args)
    eng = ContinuousBatchingEngine(
        cfg, params, lanes=args.batch, n_pages=args.pages,
        page_tokens=args.page_tokens, lane_capacity=args.capacity, device=device,
    )
    trace = generate_request_trace(
        args.requests, seed=7, qps=args.qps,
        vocab_size=min(512, cfg.vocab_size),
        prompt_len=(4, args.prompt_len),
        max_new=(4, args.new_tokens), name="cli",
    )
    reqs = materialize_requests(trace)
    rep = ContinuousScheduler(eng).run(reqs)
    print(f"served {len(rep.completed)} requests in {rep.makespan:.2f}s "
          f"virtual on {device} ({rep.tokens_out()} tokens, "
          f"{eng.stats.tokens_per_s:.1f} tokens/s decode)")
    print(f"latency p50 {rep.latency_percentile(50)*1e3:.1f} ms, "
          f"p99 {rep.latency_percentile(99)*1e3:.1f} ms; "
          f"deferrals: {rep.page_deferrals} page")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    ap.add_argument("--batch", type=int, default=4,
                    help="batch rows (fixed) / decode lanes (continuous)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--capacity", type=int, default=64,
                    help="KV capacity per row/lane (tokens)")
    ap.add_argument("--continuous", action="store_true",
                    help="serve a Poisson request trace with continuous batching")
    ap.add_argument("--qps", type=float, default=20.0)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--pages", type=int, default=33)
    ap.add_argument("--page-tokens", type=int, default=8)
    args = ap.parse_args(argv)
    if args.continuous:
        _run_continuous(args)
    else:
        _run_fixed(args)


if __name__ == "__main__":
    main()
