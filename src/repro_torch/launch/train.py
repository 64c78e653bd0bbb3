"""Training entrypoint of the port.

  python -m repro_torch.launch.train --arch rwkv6-1.6b|zamba2-2.7b [--steps N] [--batch B]
      [--seq S] [--ckpt-dir DIR] [--device cuda|cpu]

Mirrors ``repro/launch/train.py --smoke``: the arch's ``reduced()`` config
trained by ``train.loop.train`` on the skewed-unigram synthetic data, with
checkpoint/restart when ``--ckpt-dir`` is given.  Runs on the card;
``--device cpu`` runs on the CPU.  The full config is trained by calling
``train()`` directly (as ``chip_smoke.py`` does).  The burst plan,
``--bg-arch``, ``--data/--model`` and the control plane wait for their
ROADMAP items.
"""
from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    args = ap.parse_args(argv)

    from repro_torch.configs import TRAIN_4K, get_config
    from repro_torch.train.loop import TrainConfig, train

    cfg = get_config(args.arch).reduced()
    shape = dataclasses.replace(TRAIN_4K, seq_len=args.seq, global_batch=args.batch,
                                name="cli")
    report = train(cfg, shape, TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir),
                   device=args.device)
    print(f"done on {args.device}: steps={report.steps_done} loss "
          f"{report.losses[0]:.3f} -> {report.losses[-1]:.3f} "
          f"restarts={report.restarts} mitigations={len(report.mitigations)} "
          f"mean_step={1e3 * sum(report.step_times) / len(report.step_times):.1f} ms")


if __name__ == "__main__":
    main()
