#!/usr/bin/env python3
"""One run of one cell of the benchmark of grasp_tpu_torch's serving engine.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. Makes the cell's weights and traffic from ``--seed``, warms its shapes,
serves the traffic through ``ServingEngine.submit``/``step`` for ``--seconds``
seconds, then checks a sample of what was served against the plain fp32
reference. Prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones from a device trace of the
window), ``device``, with ``--trace 1`` ``breakdown``, and last ``checks``
(each number compared, with its limit). The same numbers close standard
error. Without a CUDA device, or with fewer than the cell asks for, it exits
with code 2 and prints no result; if the run loaded JAX or the JAX package,
with code 3.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "gbench_cache")


def _pin_caches() -> None:
    """Every cache that PyTorch or a kernel compiler keeps, at fixed paths
    inside the checkout (the port builds its own kernels into
    grasp_tpu_torch/build/kernels/)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("PYTORCH_KERNEL_CACHE_PATH", "kernels"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _pin_caches()
    sys.path.insert(0, ROOT)
    from benchmark.harness.spec import load_cell

    cell = load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gbench: {cell.name} needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from benchmark.harness.cell import forbidden_modules, run_cell

    result, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"gbench: the run loaded JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
