"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Exits with a code other than 0, printing no
result, when the machine has fewer CUDA devices than the cell asks for,
when the run loaded JAX or the JAX package, or when the port is missing.
"""
import time

T_START = time.time()  # set-up is timed from here: before torch is imported

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Python's compiled bytecode (torch's and the port's) at a fixed path inside
# the checkout, so only a checkout's first run compiles the modules it imports
sys.pycache_prefix = str(ROOT / "build" / "pycache")
sys.dont_write_bytecode = False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the kernels' build cache lies inside the checkout (build/), at a fixed path
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    sys.path.insert(0, str(ROOT))
    from bench.harness import run_cell

    return run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
