#!/usr/bin/env python3
"""What a bf16 call of the int4 matmul kernels (K5 grid, K5d dma) spends its
time on, on one NVIDIA GPU.

    python scripts/int4_breakdown_torch.py [--m 8] [--out build/int4_breakdown.json]

Compiles grasp_tpu_torch/csrc/int4_matmul.cu as it is and in four cut-down
copies, each into a library of its own under build/int4_breakdown/:

- ``empty``: returns at entry (the launch of a 4-warp cluster kernel);
- ``no_split_sum``: returns after its tiles, before the cluster's split sum;
- ``no_mma``: loads every tile but runs no expansion and no product;
- ``no_packed``: computes on whatever is in shared memory, never loading the
  packed weight (x and the scales still load).

Each is timed with CUDA events (after a 20 ms idle spin, over weight copies
that exceed the 50 MB L2, as ``chip_smoke.py`` times the kernels) at the
served shapes, with the plan that ``ops/int4_matmul.int4_plan`` gives, and the
whole kernel also with other numbers of splits. The cut-down copies compute
nothing useful; only their times are read. Prints one JSON line per shape and
writes them to ``--out``. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = ((2048, 2048), (2048, 256), (2048, 5632), (5632, 2048), (2048, 32000))
ENTRY = "  cg::cluster_group cluster = cg::this_cluster();\n"
SPLIT_SUM = "  cluster.sync();  // every split's partial is in place\n"
MMA = "    tile_mma<NT>(reinterpret_cast<const uint8_t*>(st),"
PACKED = ("tc::cp_async16(sp + swz(p, c), valid ? src + (int64_t)p * out_f + c : packed, "
          "valid);")
TENSOR = "        tensor_copy(sp, tmap, col0, k0 / 2, bar);\n"
EXPECT = "        mbar_expect_tx(bar, kTilePRows * kCols + (first ? kCols * 4 : 0));\n"


def variants(src: str) -> dict:
    for marker in (ENTRY, SPLIT_SUM, MMA, PACKED, TENSOR, EXPECT):
        if src.count(marker) != 1:
            raise SystemExit(f"int4_breakdown: csrc/int4_matmul.cu no longer holds {marker!r}")
    never = "  if (m > 0) return;  // cut here\n"
    return {
        "full": src,
        "empty": src.replace(ENTRY, ENTRY + never),
        "no_split_sum": src.replace(SPLIT_SUM, never + SPLIT_SUM),
        "no_mma": src.replace(MMA, "    if (m < 0) " + MMA.lstrip()),
        # the dma kernel then expects the scales' bytes alone
        "no_packed": src.replace(PACKED, "(void)valid;").replace(TENSOR, "").replace(
            EXPECT, "        mbar_expect_tx(bar, first ? kCols * 4 : 0);\n"),
    }


def build(names_src: dict, out_dir: str) -> dict:
    from grasp_tpu_torch.ops._build import CSRC_DIR, NVCC_FLAGS, SIGNATURES, find_nvcc

    os.makedirs(out_dir, exist_ok=True)
    jobs = []
    for name, text in names_src.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"{name}.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-shared", "-I", str(CSRC_DIR), "-o", so, cu]
        jobs.append((name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for name, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"int4_breakdown: nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(so).grasp_int4_matmul
        fn.restype, fn.argtypes = SIGNATURES["grasp_int4_matmul"]
        fns[name] = fn
    return fns


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--m", type=int, default=8)
    p.add_argument("--out", default=os.path.join(ROOT, "build", "int4_breakdown.json"))
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("int4_breakdown: needs a CUDA device")
    from chip_smoke import _event_ms, _int4_weight, card_line
    from grasp_tpu_torch.ops.int4_matmul import (
        MAX_CLUSTER, SMEM_ALIGN, int4_plan, stage_bytes)

    with open(os.path.join(ROOT, "grasp_tpu_torch", "csrc", "int4_matmul.cu")) as f:
        fns = build(variants(f.read()), os.path.join(ROOT, "build", "int4_breakdown"))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)
    card, m, lines = card_line(), args.m, []
    for in_f, out_f in SHAPES:
        copies = max(2, -(-64 * 2 ** 20 // (in_f * out_f // 2)))
        weights = [_int4_weight(torch, gen, dev, in_f, out_f) for _ in range(copies)]
        g = weights[0][1].shape[0]
        x = torch.randn(m, in_f, generator=gen, device=dev).bfloat16()
        y = torch.empty(m, out_f, dtype=torch.bfloat16, device=dev)
        plan = int4_plan(m, in_f, weights[0][0].shape[0], out_f, g, "dma", True)
        turn = {"i": 0}

        def timed(fn, variant, splits, stages):
            def run():
                turn["i"] += 1
                packed, scale = weights[turn["i"] % copies]
                rc = fn(x.data_ptr(), packed.data_ptr(), scale.data_ptr(), y.data_ptr(), None, m,
                        in_f, out_f, g, plan.gs, 1, variant, splits, 0, stages,
                        stages * stage_bytes(m) + SMEM_ALIGN,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise SystemExit(f"int4_breakdown: launch failed, cudaError {rc}")
            return min(_event_ms(torch, run, 2 * copies, run_ahead=True) for _ in range(2))

        rec = {"card": card, "m": m, "in": in_f, "out": out_f,
               "plan": {"splits": plan.splits, "stages": plan.stages}, "ms": {}, "splits_ms": {}}
        for variant, label in ((0, "grid"), (1, "dma")):
            for name, fn in fns.items():
                rec["ms"][f"{label}_{name}"] = timed(fn, variant, plan.splits, plan.stages)
        for splits in range(1, min(g, MAX_CLUSTER) + 1):
            per = -(-g // splits)
            if -(-g // per) != splits:  # the same split as a smaller count
                continue
            stages = max(2, min(4, per * plan.gs // 128 + 1))
            rec["splits_ms"][splits] = timed(fns["full"], 0, splits, stages)
        print(json.dumps(rec))
        lines.append(rec)
        del weights
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
