#!/usr/bin/env python3
"""What a bf16 call of the split paged-attention kernels (K3 decode, K4
verify chunk) spends its time on, on one NVIDIA GPU, and how the time moves
with the launch plan.

    python scripts/paged_breakdown_torch.py [--layout tinyllama|gemma7b|gemma2b]
                                            [--out build/paged_breakdown.json]

At one of chip_smoke.py's timing shapes (B = 8, pages of 128 slots, 16 a
row; ``tinyllama``: 32 query heads over 4 of 64 in 22 layer pools cycled so
that they exceed the L2 cache; ``gemma7b``: 16 MHA heads of 256 in 2 pools;
``gemma2b``: 8 over 1 of 256 in 18; K4 with a chunk of 5) it times, with CUDA
events after an idle spin long enough for the host to enqueue the whole loop:

- ``plans``: K3 and K4 through their C entry points with every plan the
  kernels accept on this table (ranges of 256, 512, 1024 and 2048 slots; a
  ring of 2 to 8 K and V tiles within the card's shared memory), the served
  lengths (48 to 1532);
- ``lengths``: K3 with the plan ``ops/paged_attention.paged_plan`` gives,
  all rows at length 0 (no live range: the launch, split 0 writes zeros),
  64 (one tile a row), 256 (one whole range) and the served lengths;
- ``cuts``: K3 compiled from grasp_tpu_torch/csrc/paged_attention.cu as it
  is and in five cut-down copies (each a library of its own under
  build/paged_breakdown/), at the same lengths and at two plans: ``empty``
  returns at the bf16 body's entry (the launch of the clusters alone),
  ``no_combine`` ends each block after its partial (no cluster barrier, no
  distributed shared memory), ``no_compute`` loads every tile but runs no
  product and no softmax. The cut-down copies compute nothing useful; only
  their times are read; ``no_load`` makes no tile copy (the products run on
  whatever the ring holds), ``no_address`` reads each K/V tile from
  consecutive pool rows instead of through the page table. K4 is timed
  beside K3 at the served lengths;
- ``host_us_per_call``: host microseconds the Python wrapper
  ``paged_attention`` takes per call, while the device is busy elsewhere.

Prints one JSON record and writes it to ``--out``. Needs a CUDA device and
nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ENTRY = "  const int capacity = pages_per_seq * page_size;\n"
COMBINE = "  combine_rows<HD>(pm, pl, pacc, out, row_off, row_live, n_rows, n_live_max, split);\n"
COMPUTE = "    const bool live = key0 < end_max;\n"
LOAD = "    unsigned char* dst = ring + (n % ring_tiles) * RT::kBytes;\n"
ADDRESS = "    slot_row[i] = pid_s[p - p_lo] * page_size + (slot - p * page_size);\n"
PROMPT_LENS = (16, 100, 257, 500, 768, 1000, 1300, 1500)
B, PS, PPS, CHUNK = 8, 128, 16, 5
# layer pools cycled, query heads, kv heads, head_dim, pages a pool (chip_smoke.py's timing shapes)
LAYOUTS = {"tinyllama": (22, 32, 4, 64, 256), "gemma7b": (2, 16, 16, 256, 129),
           "gemma2b": (18, 8, 1, 256, 129)}
LAYERS, NH, NKV, HD, PAGES = LAYOUTS["tinyllama"]


def variants(src: str) -> dict:
    for marker in (ENTRY, COMBINE, COMPUTE, LOAD, ADDRESS):
        if src.count(marker) != 1:
            raise SystemExit(f"paged_breakdown: csrc/paged_attention.cu no longer holds {marker!r}")
    keep = ("  if (threadIdx.x == 0 && split == 0)\n"
            "    out[row_off[0]] = __float2bfloat16(pacc[0] + pm[0] + pl[0]);\n")
    return {
        "full": src,
        "empty": src.replace(ENTRY, "  if (split >= 0) return;  // cut here\n" + ENTRY),
        "no_combine": src.replace(COMBINE, keep),
        "no_compute": src.replace(COMPUTE, "    const bool live = key0 < 0;  // cut here\n"),
        "no_load": src.replace(LOAD, "    if (n >= 0) return;  // cut here\n" + LOAD),
        "no_address": src.replace(ADDRESS, "    slot_row[i] = slot;  // cut here\n"),
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
            raise SystemExit(f"paged_breakdown: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        for entry in ("grasp_paged_attention_decode", "grasp_paged_attention_chunk"):
            getattr(lib, entry).restype, getattr(lib, entry).argtypes = SIGNATURES[entry]
        fns[name] = lib
    return fns


def spin(torch, calls):
    """An idle kernel long enough for the host to enqueue ``calls`` calls."""
    secs = 0.02 + 1e-4 * calls
    torch.cuda._sleep(int(secs * torch.cuda.get_device_properties(0).clock_rate * 1e3))


def event_ms(torch, fn, iters=20):
    """Mean device ms per call over ``iters`` rounds of one call a layer pool."""
    for li in range(LAYERS):
        fn(li)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    spin(torch, iters * LAYERS)
    start.record()
    for _ in range(iters):
        for li in range(LAYERS):
            fn(li)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * LAYERS)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--layout", choices=sorted(LAYOUTS), default="tinyllama")
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "paged_breakdown.json"))
    args = parser.parse_args(argv)
    global LAYERS, NH, NKV, HD, PAGES
    LAYERS, NH, NKV, HD, PAGES = LAYOUTS[args.layout]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("paged_breakdown: needs a CUDA device")
    from grasp_tpu_torch.ops._build import load_library
    from grasp_tpu_torch.ops.paged_attention import (
        MAX_RING_TILES, MAX_SHARED_BYTES, PagedPlan, mma_smem_bytes, paged_attention, paged_plan)

    lib = load_library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(99)
    shape = (LAYERS, NKV, PAGES, PS, HD)
    k = torch.randn(shape, generator=gen, device=dev).bfloat16()
    v = torch.randn(shape, generator=gen, device=dev).bfloat16()
    tables = (torch.randperm(PAGES - 1, generator=gen, device=dev)[: B * PPS] + 1).reshape(
        B, PPS).to(torch.int32).contiguous()
    q = torch.randn(B, NH, HD, generator=gen, device=dev).bfloat16()
    qc = torch.randn(B, CHUNK, NH, HD, generator=gen, device=dev).bfloat16()
    out, outc = torch.empty_like(q), torch.empty_like(qc)
    served = [n + 32 for n in PROMPT_LENS]
    stream = torch.cuda.current_stream().cuda_stream

    def k3(plan, lens, fn=lib.grasp_paged_attention_decode):
        def run(li):
            rc = fn(
                q.data_ptr(), k[li].data_ptr(), v[li].data_ptr(), lens.data_ptr(),
                tables.data_ptr(), out.data_ptr(), B, NH, NKV, PAGES, PS, PPS, HD, 1,
                plan.split_slots, plan.splits, plan.ring_tiles, plan.smem_bytes,
                ctypes.c_float(HD ** -0.5), stream)
            if rc:
                raise RuntimeError(f"K3 refused {plan}: cudaError {rc}")
        return run

    def k4(plan, lens, fn=lib.grasp_paged_attention_chunk):
        def run(li):
            rc = fn(
                qc.data_ptr(), k[li].data_ptr(), v[li].data_ptr(), lens.data_ptr(),
                tables.data_ptr(), outc.data_ptr(), B, CHUNK, NH, NKV, PAGES, PS, PPS, HD, 1,
                plan.split_slots, plan.splits, plan.ring_tiles, plan.smem_bytes,
                ctypes.c_float(HD ** -0.5), stream)
            if rc:
                raise RuntimeError(f"K4 refused {plan}: cudaError {rc}")
        return run

    def lengths(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    record = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True).stdout.strip(), "served_lengths": served}
    chosen = paged_plan(PS, PPS, HD, NH // NKV, torch.bfloat16)
    record["plan"] = vars(chosen)
    plans = []
    for split_slots in (256, 512, 1024, 2048):
        for ring_tiles in range(2, MAX_RING_TILES + 1):
            if (ring_tiles > 2 * split_slots // 64
                    or mma_smem_bytes(HD, ring_tiles, split_slots, PS) > MAX_SHARED_BYTES):
                continue
            plan = PagedPlan(split_slots, -(-PS * PPS // split_slots), 64, ring_tiles,
                             mma_smem_bytes(HD, ring_tiles, split_slots, PS))
            served_lens = lengths(served)
            row = {"split_slots": split_slots, "ring_tiles": ring_tiles,
                   "smem_bytes": plan.smem_bytes}
            # turns: K3, K4, K4, K3
            t3a = event_ms(torch, k3(plan, served_lens))
            t4a = event_ms(torch, k4(plan, served_lens))
            t4b = event_ms(torch, k4(plan, served_lens))
            t3b = event_ms(torch, k3(plan, served_lens))
            row.update(k3_ms=[t3a, t3b], k4_ms=[t4a, t4b])
            plans.append(row)
            print(json.dumps(row), flush=True)
    record["plans"] = plans
    by_length = {}
    for name, values in (("0", [0] * B), ("64", [64] * B), ("256", [256] * B),
                         ("served", served)):
        lens = lengths(values)
        by_length[name] = [event_ms(torch, k3(chosen, lens)) for _ in range(2)]
    record["lengths"] = by_length
    print(json.dumps({"lengths": by_length}), flush=True)

    with open(os.path.join(ROOT, "grasp_tpu_torch", "csrc", "paged_attention.cu")) as f:
        fns = build(variants(f.read()), os.path.join(ROOT, "build", "paged_breakdown"))
    cuts = {}
    for ring_tiles in sorted({chosen.ring_tiles, 2}):
        plan = PagedPlan(chosen.split_slots, chosen.splits, 64, ring_tiles,
                         mma_smem_bytes(HD, ring_tiles, chosen.split_slots, PS))
        for name, cut in fns.items():
            for label, values in (("0", [0] * B), ("64", [64] * B), ("256", [256] * B),
                                  ("served", served)):
                cuts[f"ring{ring_tiles}_{name}_{label}"] = event_ms(
                    torch, k3(plan, lengths(values), cut.grasp_paged_attention_decode))
            cuts[f"ring{ring_tiles}_{name}_k4served"] = event_ms(
                torch, k4(plan, lengths(served), cut.grasp_paged_attention_chunk))
    record["cuts"] = cuts
    print(json.dumps({"cuts": cuts}), flush=True)

    lens = lengths(served)
    for _ in range(3):  # warm the wrapper's caches
        paged_attention(q, k[0], v[0], lens, tables, HD ** -0.5)
    calls = 300  # well inside the launch queue, so that no call waits for the device
    torch.cuda.synchronize()
    spin(torch, 10 * calls)
    t0 = time.perf_counter()
    for i in range(calls):
        paged_attention(q, k[i % LAYERS], v[i % LAYERS], lens, tables, HD ** -0.5)
    record["host_us_per_call"] = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    print(json.dumps({"host_us_per_call": record["host_us_per_call"]}), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
