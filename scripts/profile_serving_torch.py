#!/usr/bin/env python3
"""Where a batched decode step of grasp_tpu_torch's serving engine spends its
time, on one NVIDIA GPU.

    python scripts/profile_serving_torch.py [--steps 20] [--out build/serving_profile.json]

Builds chip_smoke.py's GRASP-compressed TinyLlama-1.1B (bf16, random weights
from a seed), admits 8 requests with the smoke's prompt lengths into a
ServingEngine with the grasp-serve-torch defaults, and then

- times ``--steps`` decode steps on the host clock (each step ends with the
  sampled tokens on the host, so the clock covers the device work);
- profiles as many steps with torch.profiler: device time by kernel, kernel
  launches per step, and the device's busy and idle share of the window.

Prints one JSON record (and writes it to ``--out``, with a Chrome trace
beside it). Needs a CUDA device.
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
    if "paged_decode_kernel" in name:
        return "paged_attention (K3)"
    low = name.lower()
    if any(s in low for s in ("gemm", "gemv", "cutlass", "xmma", "cublas", "nvjet")):
        return "matmul"
    return "other"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--out", default=os.path.join(ROOT, "build", "serving_profile.json"))
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_serving_torch: needs a CUDA device")
    from chip_smoke import PROMPT_LENS, build_flagship, card_line
    from grasp_tpu_torch.ops._build import load_library
    from grasp_tpu_torch.serving.paged import ServingEngine

    load_library()  # build the kernels before anything is timed
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    config, params, plan = build_flagship(torch, dev)
    engine = ServingEngine(params, config, plan, device=dev, num_pages=256, page_size=128,
                           max_batch=8, max_pages_per_seq=16)
    rng = np.random.default_rng(0)
    max_new = 2 * args.steps + 10  # every row stays live through both windows
    for n in PROMPT_LENS:
        engine.submit(rng.integers(3, config.vocab_size, size=n), max_new)
    t0 = time.perf_counter()
    engine.step()  # admits all 8 (prefill each, first CUDA use) and decodes once
    torch.cuda.synchronize()
    admit_s = time.perf_counter() - t0
    for _ in range(3):  # warm-up
        engine.step()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        engine.step()
    step_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            engine.step()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    live = sum(r is not None for r in engine._live)

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise SystemExit("profile_serving_torch: the profiler recorded no device time")
    by_name, by_kind = {}, {}
    for e in kernels:
        dt = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + dt
        k = _kind(e.name)
        by_kind[k] = by_kind.get(k, 0.0) + dt
    busy_us = sum(by_kind.values())  # one stream: kernels do not overlap
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    record = {
        "card": card_line(),
        "config": "TinyLlama-1.1B bf16, layers 20-21 low-rank (ratio 0.9), batch 8, page 128",
        "live_rows": live,
        "first_step_s_admits_8_prompts": admit_s,
        "decode_step_ms_host": step_ms,
        "profiled_steps": args.steps,
        "profiled_window_ms": window_us / 1e3,
        "device_busy_ms_per_step": busy_us / 1e3 / args.steps,
        "device_idle_share": 1.0 - busy_us / window_us,
        "kernel_launches_per_step": len(kernels) / args.steps,
        "device_ms_per_step_by_kind": {k: v / 1e3 / args.steps for k, v in by_kind.items()},
        "top_kernels_ms_per_step": [[n[:120], v / 1e3 / args.steps] for n, v in top],
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    prof.export_chrome_trace(os.path.splitext(args.out)[0] + "_trace.json")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
