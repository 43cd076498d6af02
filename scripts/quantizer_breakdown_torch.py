#!/usr/bin/env python3
"""What a bf16 call of the stochastic int8 quantizer (K6) spends its time on,
on one NVIDIA GPU.

    python scripts/quantizer_breakdown_torch.py [--parent OLD.cu] [--out build/quantizer_breakdown.json]

Compiles grasp_tpu_torch/csrc/quantize_int8.cu as it is and in five cut-down
copies, each into a library of its own under build/quantizer_breakdown/:

- ``empty``: returns at entry (the launch of the clusters alone);
- ``absmax``: returns after the scales (w loaded, column maxima, the
  cluster's combine, the scales written; no rounding);
- ``no_load``: fills the shared tile with a constant instead of loading w
  (the maxima, the combine and the rounding, no read of w);
- ``no_philox``: rounds with a cheap stand-in for the Philox words;
- ``no_div``: multiplies by the scale where the kernel divides by it.

Each is timed with CUDA events (after the idle spin of ``chip_smoke.py``,
every call on the next of enough copies of w to exceed the 50 MB L2) at the
shapes ``chip_smoke.py``'s drive_quantizer quantizes and at a down_proj of
in 14336, with the plan of ``ops/quant.quantize_plan``; the whole kernel
also with the block sizes the plan did not choose. The cut-down copies compute nothing useful; only
their times are read. ``--parent`` names the source of an earlier version of
the kernel with the earlier C entry point (w q scale in out dtype seed
stream, no plan): it is built beside them, timed in turns parent, kernel,
kernel, parent, and its q and scales are compared with the kernel's at the
eight driven shapes. The compiler's registers, shared memory and spills
(``-Xptxas -v``) and the SASS instruction counts of each kernel instance
(``cuobjdump -sass``) are printed too. Prints one JSON line per shape and
writes everything to ``--out``. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ENTRY = "  const int cluster_size = gridDim.y, rank = blockIdx.y;\n"
SCALES = "  __syncthreads();\n\n  float s[V];\n"
DIVIDE = "fmaxf(x / s + u"
LOAD = "          tc::cp_async16(dst, src + (int64_t)r * out_f, true);\n"
PHILOX = "          const uint4 bits = philox(e0 / 4 + k, keys);\n"
PARENT_ARGS = ("w", "q", "scale", "in_f", "out_f", "dtype", "seed", "stream")


def variants(src: str) -> dict:
    for marker in (ENTRY, SCALES, LOAD, PHILOX, DIVIDE):
        if src.count(marker) != 1:
            raise SystemExit(f"quantizer_breakdown: csrc/quantize_int8.cu no longer holds "
                             f"{marker!r}")
    fill = "0x3C003C00u"  # 0.0078125 in both halves (bf16), 0.0078 as fp32: normal numbers
    return {
        "full": src,
        "empty": src.replace(ENTRY, ENTRY + "  if (in_f > 0) return;  // cut here\n"),
        "absmax": src.replace(SCALES, "  __syncthreads();\n  if (in_f > 0) return;  // cut here\n"
                              "\n  float s[V];\n"),
        "no_load": src.replace(LOAD, f"          *reinterpret_cast<uint4*>(dst) = make_uint4("
                               f"{fill}, {fill}, {fill}, {fill});\n"),
        "no_philox": src.replace(PHILOX, "          const uint4 bits = make_uint4(e0 + k, e0 * 3u "
                                 "+ k, e0 * 5u + k, e0 * 7u + k);\n"),
        "no_div": src.replace(DIVIDE, "fmaxf(x * s + u"),
    }


def build(names_src: dict, out_dir: str) -> tuple:
    """{name: (library, ptxas lines)}, one nvcc per source, all at once."""
    from grasp_tpu_torch.ops._build import CSRC_DIR, NVCC_FLAGS, find_nvcc

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
    libs, reports = {}, {}
    for name, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"quantizer_breakdown: nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(so)
        reports[name] = ptxas_report(log)
    return libs, reports


def ptxas_report(log: str) -> list:
    """'kernel: N registers, ... smem' lines of ptxas -v."""
    from chip_smoke import _kernel_name

    kernel, lines = "?", []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = _kernel_name(line)
        elif "registers" in line or "spill" in line or "stack frame" in line:
            lines.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
    return lines


def sass_functions(so: str) -> dict:
    """{kernel instance: [(address, instruction), ...]} from cuobjdump -sass."""
    from chip_smoke import _kernel_name
    from grasp_tpu_torch.ops._build import find_nvcc

    sass = subprocess.run([os.path.join(os.path.dirname(find_nvcc()), "cuobjdump"), "-sass", so],
                          capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = _kernel_name(line)
            funcs[name] = []
        elif name:
            found = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s*(.*?)\s*;", line)
            if found:
                funcs[name].append((int(found.group(1), 16), found.group(2)))
    return funcs


def opcode(instruction: str) -> str:
    """IMAD.WIDE.U32 R2, ... -> IMAD (a predicate such as @!P0 dropped)."""
    return re.sub(r"^@!?U?P\w+\s+", "", instruction).split()[0].split(".")[0]


def chunk_counts(code: list) -> dict:
    """Opcodes of the code that rounds one bf16 chunk of 8 elements, from the
    chunk's shared-memory load to its 8-byte store, without the calls of the
    IEEE division's slow path (a predicated branch jumps over each call and
    the moves around it; operands in range never take it)."""
    store = next(i for i, (_, ins) in enumerate(code) if ins.split()[0] == "STG.E.64")
    load = max(i for i, (_, ins) in enumerate(code[:store]) if ins.startswith("LDS.128"))
    counts, i = collections.Counter(), load
    while i <= store:
        addr, ins = code[i]
        target = re.search(r"BRA (0x[0-9a-f]+)", ins)
        if ins.startswith("@") and target and int(target.group(1), 16) > addr:
            end = next(j for j in range(i, len(code)) if code[j][0] == int(target.group(1), 16))
            if end - i <= 5 and any("CALL" in c for _, c in code[i:end]):
                counts["BRA"] += 1
                i = end  # the slow path's call, not executed
                continue
        counts[opcode(ins)] += 1
        i += 1
    return {"instructions": sum(counts.values()), **dict(counts.most_common())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", default=None, help="an earlier quantize_int8.cu (PARENT_ARGS)")
    p.add_argument("--out", default=os.path.join(ROOT, "build", "quantizer_breakdown.json"))
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("quantizer_breakdown: needs a CUDA device")
    from chip_smoke import QUANT_DRIVEN, _event_ms, card_line
    from grasp_tpu_torch.ops._build import SIGNATURES
    from grasp_tpu_torch.ops.quant import quantize_int8_stochastic, quantize_plan

    with open(os.path.join(ROOT, "grasp_tpu_torch", "csrc", "quantize_int8.cu")) as f:
        sources = variants(f.read())
    if args.parent:
        with open(args.parent) as f:
            sources["parent"] = f.read()
    out_dir = os.path.join(ROOT, "build", "quantizer_breakdown")
    libs, reports = build(sources, out_dir)
    fns = {}
    for name, lib in libs.items():
        fn = lib.grasp_quantize_int8_stochastic
        if name == "parent":
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_ulonglong,
                                                                        ctypes.c_void_p]
        else:
            fn.restype, fn.argtypes = SIGNATURES["grasp_quantize_int8_stochastic"]
        fns[name] = fn
    card = card_line()
    funcs = {k: v for k, v in sass_functions(os.path.join(out_dir, "full.so")).items()
             if k.startswith("quantize_int8_kernel")}
    report = {"card": card, "ptxas": reports,
              "sass": {k: {"instructions": len(v),
                           **collections.Counter(opcode(ins) for _, ins in v)}
                       for k, v in funcs.items()},
              "bf16_chunk": chunk_counts(funcs["quantize_int8_kernel<bf16,true,256>"])}
    for line in reports["full"] + reports.get("parent", []):
        print(f"ptxas: {line}")
    for kernel, counts in report["sass"].items():
        print(f"sass: {kernel}: {counts['instructions']} instructions")
    print(f"sass: one bf16 chunk (8 elements) of quantize_int8_kernel<bf16,true,256>, load to "
          f"store: {json.dumps(report['bf16_chunk'])}")

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream

    def call(name, w, q, scale, seed, threads=None):
        in_f, out_f = w.shape
        if name == "parent":
            rc = fns[name](w.data_ptr(), q.data_ptr(), scale.data_ptr(), in_f, out_f, 1, seed,
                           stream)
        else:
            plan = quantize_plan(in_f, out_f, w.dtype)
            rc = fns[name](w.data_ptr(), q.data_ptr(), scale.data_ptr(), in_f, out_f, 1,
                           plan.cluster, plan.rows_per_block, threads or plan.threads,
                           int(plan.keep), plan.smem_bytes, seed, stream)
        if rc:
            raise SystemExit(f"quantizer_breakdown: {name} failed: cudaError {rc}")

    gen = torch.Generator(device=dev).manual_seed(9)
    if args.parent:  # the earlier kernel's bits at the eight driven shapes
        same = []
        for i, (in_f, out_f) in enumerate(QUANT_DRIVEN):
            w = (torch.randn(in_f, out_f, generator=gen, device=dev) * 0.02).bfloat16()
            q, scale = quantize_int8_stochastic(w, seed=i)
            old_q = torch.empty_like(q)
            old_scale = torch.empty(out_f, dtype=torch.float32, device=dev)
            call("parent", w, old_q, old_scale, i)
            torch.cuda.synchronize()
            same.append(torch.equal(q, old_q) and torch.equal(scale.reshape(-1), old_scale))
        report["parent_bit_equal"] = dict(zip([f"{i}x{o}" for i, o in QUANT_DRIVEN], same))
        print(f"parent against kernel, q and scales bit-equal at the eight driven shapes: "
              f"{report['parent_bit_equal']}")

    report["shapes"] = []
    for in_f, out_f in (*dict.fromkeys(QUANT_DRIVEN), (14336, 4096)):
        n = in_f * out_f
        copies = max(2, -(-64 * 2 ** 20 // (n * 2)))
        weights = [(torch.randn(in_f, out_f, generator=gen, device=dev) * 0.02).bfloat16()
                   for _ in range(copies)]
        q = torch.empty(in_f, out_f, dtype=torch.int8, device=dev)
        scale = torch.empty(out_f, dtype=torch.float32, device=dev)
        turn = {"i": 0}

        plan = quantize_plan(in_f, out_f, torch.bfloat16)

        def timed(name, threads=None):
            def run():
                turn["i"] += 1
                call(name, weights[turn["i"] % copies], q, scale, 1, threads)
            return _event_ms(torch, run, 4 * copies, run_ahead=True)

        order = (["parent", "full", "full", "parent"] if args.parent else ["full", "full"]) + [
            "empty", "absmax", "no_load", "no_philox", "no_div"]
        times = collections.defaultdict(list)
        for name in order:
            times[name].append(timed(name))
        for threads in {256, 512, 1024} - {plan.threads}:
            times[f"full_{threads}_threads"].append(timed("full", threads))
        bound_ms = (3 * n + 4 * out_f) / 3.35e12 * 1e3
        line = {"shape": [in_f, out_f], "copies": copies, "bound_ms": bound_ms,
                "plan": {"cluster": plan.cluster, "rows_per_block": plan.rows_per_block,
                         "threads": plan.threads, "keep": plan.keep,
                         "smem_bytes": plan.smem_bytes,
                         "blocks": plan.grid[0] * plan.grid[1]},
                "ms": {k: v for k, v in times.items()},
                "share_of_bound": {k: bound_ms / (sum(v) / len(v)) for k, v in times.items()}}
        report["shapes"].append(line)
        print(json.dumps(line))
        del weights
    report["card_line"] = card
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
