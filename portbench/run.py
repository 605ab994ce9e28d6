"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload osm.count --seed 7 --seconds 10 \
        --trace 0

run from the root of a checkout (BENCHMARK.json, portbench/, src/).  It
makes its rows and windows from the seed, fits a `repro_torch` Database
on the card, warms the cell's calls, drives `Database.query` in a closed
loop of one caller for `--seconds` (`--trace 1`: a bounded number of
calls under the profiler), checks a seeded sample of the answers against
the plain reference, and prints one JSON line: correct, attempted,
failed, metrics, device (and with --trace 1 a breakdown), and the numbers
checked with their limits under "checks".  Without a CUDA card, or
without the program beside it, it prints no result and exits non-zero.
"""
import time

T_PROCESS = time.perf_counter()          # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a whole number >= 0")
    # kernel caches at fixed directories inside the checkout: the port's
    # nvcc build is there already (build/repro_torch/); these catch the
    # Triton or torch-extension kernels a later change may add, since this
    # file cannot be edited then
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("portbench: src/repro_torch not found beside portbench/; run "
              "from a checkout of the repo", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from portbench import harness
    try:
        cell = harness.load_cell(args.workload)
    except harness.CellError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        line = harness.run_cell(args.workload, args.seed, args.seconds,
                                bool(args.trace), t_process=T_PROCESS)
    except harness.CellError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 1
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
