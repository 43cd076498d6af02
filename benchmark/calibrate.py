#!/usr/bin/env python3
"""Readings that the limit of a cell's comparison is set from, on the chip.

    python benchmark/calibrate.py --workload <name> --seconds <s> --seeds <n> [<n> ...]
                                  [--control-seeds <n> ...]

For each seed, in one process (the kernel library is loaded once): one run of
the cell as ``run.py`` makes it, then the widest gap of the program's served
tokens under the fp32 reference and, for the control seeds, the control's
reading on the same sample (the reference computed in fp8 in the program's
place), and whether the run would have passed with the control's reading in
the program's place (``control_correct``: it has to be false). One JSON line
a seed. The benchmark's own runs never run the control.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import gc

    import torch

    from benchmark.harness.cell import run_cell
    from benchmark.harness.check import control_passed
    from benchmark.harness.spec import load_cell
    from benchmark.run import _pin_caches

    _pin_caches()
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, ROOT)
    for seed in args.seeds:
        t0 = time.perf_counter()
        result, run = run_cell(cell, seed, args.seconds, False, "cuda", t0,
                               control=seed in args.control_seeds)
        line = {"workload": cell.name, "seed": seed, "correct": result["correct"],
                "checks": result["checks"], "metrics": result["metrics"],
                "attempted": result["attempted"], "card": result["device"]["power_limit"]}
        if seed in args.control_seeds:
            line["control_correct"] = control_passed(result["checks"])
        print(json.dumps(line), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
