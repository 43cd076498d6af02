#!/usr/bin/env python3
"""Where the sweeps of grasp_tpu_torch's compression engine spend their time,
on one NVIDIA GPU.

    python scripts/profile_compress_torch.py [--rows 4] [--layers 21 10]
                                             [--out build/compress_profile.json]

Builds TinyLlama-1.1B at full width (bf16, random weights from a seed) and
``--rows`` synthetic calibration rows of 2047 tokens, as chip_smoke.py's
compression phase does, and profiles with torch.profiler

- the block-influence sweep (one forward per row), and
- for each layer of ``--layers``, the dense-gradient sweep of that layer's MLP
  round (forward and backward per row; the backward runs through every layer
  above it),

each after one warm-up sweep. For every window: host seconds, the device's
busy and idle share, and device time by kind of kernel (the three flash
kernels, matmuls, everything else). Prints one JSON record and writes it to
``--out``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _kind(name: str) -> str:
    # both bodies of each; dK/dV's bf16 group sum counts as K1k
    for kernel, kind in (("flash_fwd", "flash fwd (K1f)"), ("flash_dkv", "flash dK/dV (K1k)"),
                         ("flash_dq", "flash dQ (K1q)")):
        if kernel in name:
            return kind
    low = name.lower()
    if any(s in low for s in ("gemm", "gemv", "cutlass", "xmma", "cublas", "nvjet")):
        return "matmul"
    return "other"


def _profiled(torch, fn):
    """Run ``fn`` under the profiler; returns the window's record."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise SystemExit("profile_compress_torch: the profiler recorded no device time")
    by_kind = {}
    for e in kernels:
        k = _kind(e.name)
        by_kind[k] = by_kind.get(k, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_kind.values())  # one stream: kernels do not overlap
    return {"host_s": window_us / 1e6, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / window_us, "device_events": len(kernels),
            "device_s_by_kind": {k: v / 1e6 for k, v in sorted(by_kind.items())}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rows", type=int, default=4)
    p.add_argument("--layers", type=int, nargs="+", default=[21, 10])
    p.add_argument("--out", default=os.path.join(ROOT, "build", "compress_profile.json"))
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_compress_torch: needs a CUDA device")
    from chip_smoke import card_line
    from grasp_tpu_torch.cli import load_model
    from grasp_tpu_torch.core.engine import GraspEngine, module_name
    from grasp_tpu_torch.data.loader import get_calibration_batches
    from grasp_tpu_torch.models.llama import MLP_PROJS
    from grasp_tpu_torch.ops._build import load_library

    load_library()  # build the kernels before anything is timed
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    config, params, plan, tok = load_model("tinyllama-1.1b", device=dev, dtype="bfloat16", seed=42)
    batches = get_calibration_batches("synthetic", tok, num_samples=args.rows, seq_len=2048)
    engine = GraspEngine(params, config, plan, device=dev)
    engine._maybe_enable_flash_sweep(batches)
    if not engine.config.use_flash_attention:
        raise SystemExit("profile_compress_torch: the sweeps did not take the flash route")

    record = {"card": card_line(), "rows": len(batches), "tokens_per_row": 2047,
              "config": "TinyLlama-1.1B bf16, dense, flash route"}
    engine.compute_bi(2, batches[:1])  # warm-up
    record["bi_sweep"] = _profiled(torch, lambda: engine.compute_bi(2, batches))
    for layer in args.layers:
        names = [module_name(layer, proj) for proj in MLP_PROJS]
        engine.get_dense_gradients(names, batches[:1])  # warm-up
        record[f"grad_sweep_layer_{layer}_mlp"] = _profiled(
            torch, lambda: engine.get_dense_gradients(names, batches))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
