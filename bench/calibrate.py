"""The readings a cell's limits are set from, in one process: the sound
program's numbers over many seeds, and over fewer seeds the control (the
reference computed in float8, put in the program's place) and the
half-batch fault (the reference over half of each batch, the mean taken
over the rest), each against the float32 reference.  A state left
unchanged reads 1 on ``grad_norm_gap`` and ``change_norm_gap`` by
definition and needs no run.

    python3 bench/calibrate.py --workload <name> --seeds 12 --faults 3 [--first-seed N]

on the card; prints one JSON line per reading and a summary: for each
number the lower reading (the largest of the program's) and the least
reading of the control and of the fault.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--faults", type=int, default=3, help="seeds the control and fault run on")
    ap.add_argument("--kinds", default="control,half_batch",
                    help="what runs on those seeds: control, half_batch, bf16 (the witness)")
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 1000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the readings here (JSON)")
    ap.add_argument("--spec", default=None, help="another BENCHMARK.json (the tests' fixtures)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from bench import check
    from bench.harness import SPEC, Files, free, half_batch, load_cell, reference, setup

    spec_path = Path(args.spec) if args.spec else SPEC
    files = Files(spec_path.parent, ROOT / "bench") if args.spec else Files()
    cell = load_cell(json.loads(spec_path.read_text()), args.workload, files)
    dev = torch.device(args.device)
    runs = {"control": {"prec": "fp8"}, "half_batch": {"fault": half_batch},
            "bf16": {"prec": "bf16"}}
    kinds = args.kinds.split(",")
    rows = {k: [] for k in ["program"] + kinds}

    def keep(kind, seed, numbers):
        rows[kind].append(numbers)
        print(json.dumps({"seed": seed, "kind": kind, **numbers}), flush=True)

    for n in range(args.seeds):
        seed = args.first_seed + 7919 * n
        t0 = time.time()
        step, state, prog = setup(cell, seed, dev)
        prog["nonfinite"] = 0
        del step, state
        free(dev)
        truth = reference(cell, seed, dev)
        keep("program", seed, check.numbers(prog, truth))
        if n < args.faults:
            for name in kinds:
                wrong = dict(reference(cell, seed, dev, **runs[name]), nonfinite=0)
                keep(name, seed, check.numbers(wrong, truth))
        print(f"seed {seed}: {time.time() - t0:.1f} s", file=sys.stderr, flush=True)
    keys = [k for k in rows["program"][0] if k != "nonfinite_losses"]
    summary = {k: {"lower": max(r[k] for r in rows["program"]),
                   **{f"{name}_least": min(r[k] for r in rows[name])
                      for name in kinds if rows[name]}} for k in keys}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": args.workload, "rows": rows,
                                              "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
