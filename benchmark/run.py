"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Exits non-zero, printing no result, without a CUDA device (or fewer than
the cell asks for), and when JAX or the JAX package was loaded. The last
line of standard output is the result; the compared numbers, each beside
its limit, are the last lines of standard error.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchmark import harness, spec
    cell = spec.load_cell(args.workload, ROOT)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card and runs "
              "nowhere else", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda:0"), T_START)
    banned = harness.banned_modules(sys.modules)
    if banned:
        print(f"loaded in the benchmark's process: {', '.join(banned)}; "
              "the port and the benchmark must not load JAX or the JAX "
              "package", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
