"""End-to-end training run: a ~100M-parameter llama-style model trained
for a few hundred steps through the port's training loop (checkpointing,
straggler monitoring).

  python -m repro_torch.launch.train_lm                # ~100M, 300 steps
  python -m repro_torch.launch.train_lm --fast         # reduced llama3-8b, 50 steps

Step for step ``examples/train_lm.py`` (the JAX reference), which trains on
a (1, 1) mesh through its sharded step: here through ``train()`` on one
device, which computes the same step (``chip_smoke.py`` phase 11b shows the
sharded step on a (1, 1) mesh bit-identical to it).  Runs on the card;
``--device cpu`` runs on the CPU.  Checkpoints go to ``--ckpt-dir``.
"""
from __future__ import annotations

import argparse
import dataclasses


def config_100m():
    """The reference example's ~100M config: 12 layers, d_model 768,
    llama-style."""
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(
        name="llama-100m", family="dense", block_type="attn_mlp",
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
        d_head=64, d_ff=2048, vocab_size=32000, rope_theta=1e4,
        tie_embeddings=True, attn_tp=False, kv_tp=False,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train_lm")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default="build/train_lm")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    args = ap.parse_args(argv)

    from repro_torch._device import resolve_device
    from repro_torch.configs import TRAIN_4K, get_config
    from repro_torch.train.loop import TrainConfig, train

    device = resolve_device(args.device)  # no card: raise before any work
    if args.fast:
        cfg = get_config("llama3-8b").reduced()
        shape = dataclasses.replace(TRAIN_4K, seq_len=128, global_batch=4)
        steps = args.steps or 50
    else:
        cfg = config_100m()
        print(f"model: {cfg.n_params()/1e6:.0f}M params")
        shape = dataclasses.replace(TRAIN_4K, seq_len=256, global_batch=8)
        steps = args.steps or 300

    tc = TrainConfig(steps=steps, ckpt_dir=args.ckpt_dir, ckpt_every=50)
    report = train(cfg, shape, tc, device=device)
    n = len(report.losses)
    print(f"steps={report.steps_done} restarts={report.restarts}")
    print(f"loss: {report.losses[0]:.4f} -> {report.losses[-1]:.4f} "
          f"(mean of last 10: {sum(report.losses[-10:])/min(10,n):.4f})")
    print(f"mean step time: {1e3*sum(report.step_times)/n:.0f} ms; "
          f"straggler events: {report.mitigations.count('straggler')}")
    return report


if __name__ == "__main__":
    main()
