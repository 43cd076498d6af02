#!/usr/bin/env python3
"""Find the knee of an open-loop cell once, on the chip: the highest rate at
which the queue of requests sent and not yet admitted does not grow through
the window.

    python benchmark/sweep.py --workload <name> --seconds <s> --seed <n> --rates <r> [<r> ...]

One process; for each rate a fresh engine runs the cell's traffic at that
rate (the output check is skipped). One JSON line a rate: tokens a second,
TTFT p50 and p90, the mean queue over the window's first and last thirds,
requests sent and admitted in the window.
"""

import time

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import gc

    import torch

    from benchmark.harness.cell import run_cell
    from benchmark.harness.spec import load_cell
    from benchmark.metrics.yardstick import percentile
    from benchmark.run import _pin_caches

    _pin_caches()
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA device", file=sys.stderr)
        return 2
    base = load_cell(args.workload, ROOT)
    for r in args.rates:
        cell = copy.deepcopy(base)
        cell.traffic["rate"] = r
        result, run = run_cell(cell, args.seed, args.seconds, False, "cuda",
                               time.perf_counter(), check_output=False)
        rec = run.rec
        steps = rec.window_steps()
        third = max(1, len(steps) // 3)
        sent = [q for q in rec.requests if q.in_window]
        ttft = [(q.times[0] - q.due) * 1e3 for q in sent if q.times]
        print(json.dumps({
            "workload": cell.name, "rate": r, "metrics": result["metrics"],
            "ttft_p50_ms": percentile(ttft, 50) if ttft else None,
            "queue_first_third": sum(s.waiting for s in steps[:third]) / third,
            "queue_last_third": sum(s.waiting for s in steps[-third:]) / third,
            "rows_mean": sum(len(s.decoded) for s in steps) / max(1, len(steps)),
            "sent": len(sent), "admitted_in_window": sum(len(s.admitted) for s in steps),
            "card": result["device"]["power_limit"]}), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
