"""Batched serving demo: prefill + greedy decode with the KV cache.

  python -m repro_torch.launch.serve_lm [--arch qwen2-1.5b] [--device cuda|cpu]

Step for step ``examples/serve_lm.py`` (the JAX reference): the arch's
``reduced()`` config with random weights from a seeded ``torch.Generator``,
its cache size for the batch and capacity, then ``ServingEngine``'s
batched prefill and greedy decode of seeded random prompts.  Also shows the
O(1)-state serving path (``--arch rwkv6-1.6b``) beside the KV-cache path.
Runs on the card; ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve_lm")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch._device import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.kvcache import cache_bytes

    device = resolve_device(args.device)  # no card: raise before any work
    cfg = get_config(args.arch).reduced()
    api = get_model(cfg)
    params = api.init(torch.Generator(device=device).manual_seed(0), device)
    capacity = args.prompt_len + args.new_tokens + 8
    print(f"{cfg.name}: cache {cache_bytes(api, args.batch, capacity)/1e6:.1f} MB "
          f"for batch={args.batch} capacity={capacity}")
    eng = ServingEngine(cfg, params, args.batch, capacity, device=device)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32)
    out = np.asarray(eng.generate(prompts, args.new_tokens))
    print(f"generated {out.shape[1]} tokens x {out.shape[0]} sequences")
    print(f"prefill: {eng.stats.prefill_s*1e3:.0f} ms | "
          f"decode: {eng.stats.tokens_per_s:.1f} tokens/s")
    print("first sequence:", out[0][:12], "...")
    return out, eng


if __name__ == "__main__":
    main()
