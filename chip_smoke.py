#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (grasp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. device: requires CUDA; prints the card's name and power limit.
2. build: compiles grasp_tpu_torch/csrc/*.cu with nvcc (sm_90a) into build/.
3. paged kernel: the paged-attention decode kernel against its plain PyTorch
   version on the same inputs, at TinyLlama's decode shape and at head_dim
   128, then at groups of 1 to 16 with lengths on both sides of every edge of
   the launch plan's ranges, in float32 and bfloat16, within stated
   tolerances and torch.equal to itself run to run; then both timed with
   CUDA events at the decode shape. Then the chunk kernel of speculative
   verification against its plain version and, row by row with torch.equal,
   against the decode kernel at each row's own length (head_dim 64 and 128,
   float32 and bfloat16, groups of 1, 4 and 8, chunks of 1, 2, 5 and 9, pages
   of 16 and 128 slots, lengths across tile, page and range edges, a dead
   row); and timed against its plain version and against one decode launch
   per chunk position.
4. flash kernels: the flash-attention forward, dK/dV and dQ kernels against
   the plain version (output and the gradients of sum(o ** 2)) at four
   shapes in float32 and bfloat16, dQ, dK and dV bit-equal over two runs;
   then each kernel, the plain version and scaled_dot_product_attention (a
   yardstick the port never calls) timed at the calibration shape, and the
   whole backward (di, dK/dV, dQ) against one SDPA backward.
5. serving slice: a GRASP-compressed TinyLlama-1.1B at full width (22 layers,
   random weights from a seed, the last two layers' projections low-rank at
   ratio 0.9) saved as a port checkpoint and served by ``grasp_tpu_torch.cli``
   over HTTP: one streamed completion, then 8 concurrent completions with
   prompts of 16 to 1500 tokens, and /v1/models. Checks every response, that
   the kernel ran once per layer per decode step, and that the served tokens
   agree with a teacher-forced plain forward of the same weights.
6. low-rank, int4 and quantizer kernels: the fused low-rank kernel against
   its plain version at five shapes in float32 and bfloat16, with the
   gradients through its autograd function; the int4 matmul kernels (grid
   and double-buffered): their nibble expansion against unpack_int4 for every
   byte value, then both at m = 1, 8, 64 for the model's four weight shapes,
   at m = 1 and 8 for the other served products (k/v, the low-rank factors)
   and at a ragged shape, against the plain version and each other (bf16:
   bit-equal to each other and run to run); the stochastic int8 quantizer
   bit for bit against its plain version (the same Philox stream) at the
   driven shapes, both plan variants and odd shapes, and by structure,
   distribution and seed. Each is timed against its plain version, its bound
   and, where one exists, the library call (two matmuls; a matmul on the
   dequantized weight), int4 at m = 1 and 8 for five shapes, the quantizer
   over copies of w beyond the L2 at the gate/up and lm_head shapes.
7. quantized and fused serving: the serving checkpoint again through
   ``grasp_tpu_torch.cli`` with ``--quantize int4`` (then once more with
   ``GRASP_INT4_KERNEL=dma``), with ``--quantize int8``, and with
   ``use_pallas_lowrank`` set in its model config. Tokens are checked
   against a teacher-forced plain forward of the served (quantized) params
   and launch counts against counts derived from the dispatch rules.
8. speculative and int8-KV serving: the serving checkpoint through
   ``grasp_tpu_torch.cli`` with ``--speculative int8 --gamma 4`` (greedy
   requests together, then a sampled one): launch counts of the chunk and
   decode kernels against the engine's macro-steps, every greedy token
   against a teacher-forced plain forward of the target, and the streams
   against the plain engine's on the same requests. Then with
   ``--quantized_kv``, alone and with speculation: tokens against a
   teacher-forced forward through the int8 dense cache, and neither paged
   kernel launched.
9. compression slice: ``grasp-compress-torch`` on a dense TinyLlama-1.1B at
   full width and depth with 16 synthetic calibration rows of 2047 tokens
   (2 layers, ratio 0.9). Checks the chosen layers, every rank, the plan, the
   parameter count, that the flash kernels ran as often as the sweeps imply,
   that the saved checkpoint loads and runs, and one round's gradients with
   the flash route and the plain route in bf16 against the plain route in
   fp32. The prefix split ("auto" resolves to "cache" on the card) starts
   every sweep at the lowest target layer. Then ``--sweep parallel``: one
   sweep for both layers, checked the same way. At the same width the
   engine then holds: sequential runs under prefix off, recompute and cache
   equal (indices and factors); a run killed after its second round and
   resumed by a fresh engine equal to the uninterrupted one; the gram and
   gram_device SVDs on the parallel path selecting as the device SVD does;
   a full-depth sweep with remat against one without (gradients, peak
   memory). Then the compression from a checkpoint whose model config has
   ``use_pallas_lowrank``, sequential and parallel in chunks of one layer:
   the same layers and ranks, and the fused low-rank kernel launched once per
   compiled projection per later forward.
10. evaluation slice (run inside 9, on the sequential run's checkpoint before
   it is removed): ``grasp-evaluate-torch --eval_ppl synthetic`` on the
   checkpoint as saved and with ``use_flash_attention`` and
   ``use_pallas_lowrank`` in its config; ``windowed_perplexity`` over the same
   8 windows of 2048 tokens plain, with the flash route and with both kernels,
   each window's mean cross entropy against the plain run's; the zero/few-shot
   harness over seed-made documents of five tasks with and without the
   kernels; ``greedy_until`` and LongBench's ``get_pred`` over eight prompts of
   300 to 1000 tokens, every token against a teacher-forced plain forward.
   Every launch count is held to the dispatch rules (no flash launch on the
   dense KV cache).

The third line from the end is a JSON record of each kernel (launches in its
slice's run, error against the plain version, times, bound); then the card's
line; the last line is ``{"ok": true, "device": {...}}``. Imports nothing of
JAX and nothing of grasp_tpu. ``--only flash|kernels|serve|spec|compress|evaluate``
runs one part while developing and prints no result lines.
"""

import argparse
import contextlib
import functools
import gc
import http.client
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# tolerance of kernel vs plain version: the summation order differs (fp32
# accumulation in both); bfloat16 outputs keep ~3 significant digits
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# served token vs teacher-forced plain forward: the largest logit minus the
# served token's logit (bf16 logits of magnitude ~4 have an ulp of 1/64)
GAP_TOL = 0.125

PROMPT_LENS = (16, 100, 257, 500, 768, 1000, 1300, 1500)
MAX_TOKENS = 64


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip()


def _kernel_name(line: str) -> str:
    """kernel<args> from the mangled name in a line of ptxas's or cuobjdump's
    output, e.g.
    ..._ZN..20flash_dkv_mma_kernelILi64EEEv.. -> flash_dkv_mma_kernel<64>,
    ..15flash_dq_kernelIfLi128EEEv.. -> flash_dq_kernel<f32,128>."""
    found = re.search(r"_Z\w+", line)
    if not found:
        return "?"
    sym, name, end = found.group(0), "?", 0
    for d in re.finditer(r"\d+", sym):  # <length><identifier>, the last one naming a kernel
        for i in range(d.start(), d.end()):  # the length may follow other digits
            n = int(sym[i:d.end()])
            ident = sym[d.end():d.end() + n]
            if ident.endswith("_kernel") and len(ident) == n:
                name, end = ident, d.end() + n
    if not sym.startswith("I", end):
        return name
    args = [("bf16" if t.group(0).startswith("13") else "f32" if t.group(0) == "f"
             else t.group(1) if t.group(1) else ("true" if t.group(2) == "1" else "false"))
            for t in re.finditer(r"13__nv_bfloat16|Li(\d+)E|Lb(\d)E|f",
                                 sym[end + 1:sym.find("EE", end) + 1])]
    return f"{name}<{','.join(args)}>"


def phase_build():
    """Build and load the kernels, print the compiler's register and spill
    report, and show from the compiled code (cuobjdump -sass) that every
    tensor-core kernel (flash forward, dQ, dK/dV; fused low-rank; both bf16
    int4 kernels at 1, 2, 4 and 8 n-tiles; bf16 paged decode and chunk at
    head_dim 64 and 128) holds HMMA instructions."""
    from grasp_tpu_torch.ops._build import build, find_nvcc, load_library

    t0 = time.perf_counter()
    so = build()
    load_library()
    secs = time.perf_counter() - t0
    print(f"build: {secs:.2f} s -> {os.path.relpath(so, ROOT)}")
    log = so.with_suffix(".log")
    if log.exists():
        kernel = "?"
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:
                kernel = _kernel_name(line)
            elif "registers" in line or ("spill" in line and "0 bytes spill stores" not in line):
                print(f"  ptxas: {kernel}: {line.replace('ptxas info    :', '').strip()}")
    sass = subprocess.run([os.path.join(os.path.dirname(find_nvcc()), "cuobjdump"), "-sass",
                           str(so)], capture_output=True, text=True, check=True).stdout
    families = ("flash_fwd_mma_kernel", "flash_dq_mma_kernel", "flash_dkv_mma_kernel",
                "lowrank_fused_mma_kernel", "int4_grid_mma_kernel", "int4_dma_mma_kernel",
                "paged_decode_mma_kernel", "paged_chunk_mma_kernel")
    hmma, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = _kernel_name(line)
            name = name if name.split("<")[0] in families else None
            if name:
                hmma[name] = 0
        elif name and "HMMA" in line:
            hmma[name] += 1
    print("sass: HMMA instructions in the tensor-core kernels: "
          + ", ".join(f"{n} {c}" for n, c in sorted(hmma.items())))
    want = {f"{family}<{hd}>" for family in families[:3] for hd in (64, 128)}
    want |= {f"lowrank_fused_mma_kernel<{rc},false>" for rc in range(1, 9)}
    want.add("lowrank_fused_mma_kernel<8,true>")  # the rank chunks of a rank above 256
    want |= {f"{family}<{nt}>" for family in families[4:6] for nt in (1, 2, 4, 8)}
    want |= {f"{family}<{hd}>" for family in families[6:] for hd in (64, 128)}
    if not want <= set(hmma) or min(hmma.values()) == 0:
        raise AssertionError("a tensor-core kernel is missing or was compiled without HMMA")


def _pages_case(torch, gen, dev, dtype, b, nh, nkv, hd, ps, pps, num_pages, lengths,
                layers=1):
    """Random q/pools/tables (pages drawn without repeats), lengths as given;
    a length of 0 in ``lengths`` marks a dead row: table on page 0, length 1."""
    q = torch.randn(b, nh, hd, generator=gen, device=dev).to(dtype)
    shape = (layers, nkv, num_pages, ps, hd)
    k = torch.randn(shape, generator=gen, device=dev).to(dtype)
    v = torch.randn(shape, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev) + 1
    tables = perm[: b * pps].reshape(b, pps).to(torch.int32)
    lens = torch.tensor([max(n, 1) for n in lengths], dtype=torch.int32, device=dev)
    for i, n in enumerate(lengths):
        if n == 0:
            tables[i] = 0
    return q, k, v, lens, tables.contiguous()


def _split_edge_lengths(split_slots, capacity):
    """Lengths on both sides of every range edge of the split plan, two
    ranges and the full table."""
    out = {1, 2 * split_slots, capacity}
    for edge in range(split_slots, capacity + 1, split_slots):
        out |= {edge - 1, edge, edge + 1}
    return sorted(n for n in out if 1 <= n <= capacity)


def phase_kernel(torch):
    """The decode kernel against its plain version within TOL: TinyLlama's
    decode shape and head_dim 128 with lengths across tile and page edges and
    a dead row; then groups of 1, 4, 8 and 16 at head_dim 64 (1, 4, 8 at 128)
    with lengths on both sides of every edge of the plan's ranges. Every call
    runs twice and must be torch.equal to itself. Returns the worst error."""
    from grasp_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_reference, paged_plan)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1234)
    lengths = [1, 127, 128, 129, 2048, 0, 1000, 2047]  # 0: dead row on null page 0
    cases = [(hd, nh, nkv, lengths) for hd, nh, nkv in ((64, 32, 4), (128, 32, 8))]
    for hd, gqas in ((64, (1, 4, 8, 16)), (128, (1, 4, 8))):
        for gqa in gqas:
            split = paged_plan(128, 16, hd, gqa, torch.bfloat16).split_slots
            cases.append((hd, 2 * gqa, 2, _split_edge_lengths(split, 2048)))
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for hd, nh, nkv, lens_case in cases:
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            q, k, v, lens, tables = _pages_case(torch, gen, dev, dtype, len(lens_case), nh, nkv,
                                                hd, 128, 16, 16 * len(lens_case) + 1, lens_case)
            scale = hd ** -0.5
            got = paged_attention(q, k[0], v[0], lens, tables, scale)
            again = paged_attention(q, k[0], v[0], lens, tables, scale)
            want = paged_attention_reference(q, k[0], v[0], lens, tables, scale)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            same = torch.equal(got, again)
            ok = torch.isfinite(got).all().item() and err <= TOL[dtype_name] and same
            print(f"kernel vs plain: hd={hd} nh={nh} nkv={nkv} {dtype_name}, {len(lens_case)} "
                  f"rows of lengths {lens_case[0]}..{max(lens_case)}: max_abs_err={err:.3e} "
                  f"(tol {TOL[dtype_name]:g}), equal run to run: {same} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"paged attention kernel disagrees: hd={hd} nh={nh} "
                                     f"nkv={nkv} {dtype_name}")
            worst[dtype_name] = max(worst[dtype_name], err)
    print(f"kernel vs plain, worst: float32 {worst['float32']:.3e}, bfloat16 "
          f"{worst['bfloat16']:.3e}")
    return max(worst.values())


def _spin(torch, calls=0):
    """Keep the card busy with one idle kernel (it draws no power that would
    lower the clocks) for 20 ms, or 100 us for each of ``calls`` timed calls
    if that is longer, so that the host enqueues a whole timed loop meanwhile
    and the events bracket device time alone."""
    secs = max(0.02, 1e-4 * calls)
    torch.cuda._sleep(int(secs * torch.cuda.get_device_properties(0).clock_rate * 1e3))


def _time_ms(torch, fn, n_layers, iters, run_ahead=False):
    """Mean ms per call over ``iters`` rounds of one call per layer slice
    (the 22 layers' pools together exceed the L2 cache, as in decode).
    ``run_ahead``: see :func:`_spin`."""
    for li in range(n_layers):
        fn(li)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if run_ahead:
        _spin(torch, iters * n_layers)
    start.record()
    for _ in range(iters):
        for li in range(n_layers):
            fn(li)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * n_layers)


def phase_kernel_timing(torch, n_layers):
    """Kernel and plain version at TinyLlama's decode shape: B=8, bf16,
    lengths of the slice's prompts 32 tokens into decoding. Turns: plain,
    kernel, kernel, plain, each after the idle spin; reports the mean of each
    pair."""
    from grasp_tpu_torch.ops.paged_attention import paged_attention, paged_attention_reference

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(99)
    lengths = [n + 32 for n in PROMPT_LENS]
    q, k, v, lens, tables = _pages_case(torch, gen, dev, torch.bfloat16, 8, 32, 4, 64,
                                        128, 16, 256, lengths, layers=n_layers)
    scale = 64 ** -0.5

    def kern(li):
        paged_attention(q, k[li], v[li], lens, tables, scale)

    def plain(li):
        paged_attention_reference(q, k[li], v[li], lens, tables, scale)

    p1 = _time_ms(torch, plain, n_layers, 20, run_ahead=True)
    k1 = _time_ms(torch, kern, n_layers, 20, run_ahead=True)
    k2 = _time_ms(torch, kern, n_layers, 20, run_ahead=True)
    p2 = _time_ms(torch, plain, n_layers, 20, run_ahead=True)
    # least time for this call: the live K and V rows, q and the output moved
    # once at 3.35 TB/s, against q.k and p.v (2 flops each per element) at the
    # bf16 tensor-core peak
    live = sum(lengths)
    nbytes = 2 * live * 4 * 64 * 2 + 2 * 8 * 32 * 64 * 2 + lens.numel() * 4 + tables.numel() * 4
    rec = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, **_bound(nbytes, 4 * live * 32 * 64),
           "library_ms": None}
    print(f"kernel timing (B=8 nh=32 nkv=4 hd=64 bf16, lengths {lengths}): "
          f"kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms" + _shares(rec))
    return rec


# base lengths of the chunk kernel's cases: 1, both sides of the tile edges
# (32 slots at head_dim 128, 64 at 64), of the page edges (16, 128) and of the
# plan's range edges (64-slot ranges on these 256-slot tables), such that
# chunks end inside a tile, on its edge and beyond it; 0 marks a dead row
# (null page, base length 1). Pools are random throughout, so every slot beyond
# a row's length holds stale finite values.
CHUNK_BASES = (1, 14, 16, 30, 33, 62, 64, 120, 127, 128, 189, 200, 247, 0)
CHUNK_LENS = (1, 2, 5, 9)
SPEC_GAMMA = 4


# the verify step's own shape (B=8, 32 query heads over 4, head_dim 64, pages
# of 128, 16 pages per row, a chunk of gamma + 1): base lengths from the
# shortest served context to 1532, one on a page edge, a dead row, and one
# whose last query fills all 16 pages (2044 + 4 = 2048 slots)
SERVED_CHUNK_BASES = (70, 127, 128, 632, 1532, 0, 2044, 1000)
# the same shape with every chunk across an edge of the plan's 256-slot ranges
SPLIT_EDGE_CHUNK_BASES = (252, 254, 255, 256, 508, 1020, 1788, 2043)


def _chunk_compare(torch, q, k, v, base, tables, scale):
    """One chunk-kernel call held against its plain version and, row by row
    with torch.equal, against the decode kernel at length base + c. Returns
    (max abs error against the plain version, chunk positions that differ)."""
    from grasp_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_chunk, paged_attention_chunk_reference)

    got = paged_attention_chunk(q, k, v, base, tables, scale)
    want = paged_attention_chunk_reference(q, k, v, base, tables, scale)
    unequal = []
    for c in range(q.shape[1]):
        single = paged_attention(q[:, c].contiguous(), k, v, base + c, tables, scale)
        if not torch.equal(got[:, c], single):
            unequal.append(c)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all().item():
        raise AssertionError("paged attention chunk kernel: non-finite output")
    return (got.float() - want.float()).abs().max().item(), unequal


def phase_chunk(torch):
    """The chunk kernel against its plain version within TOL, and against the
    decode kernel with torch.equal: row (b, c) is the decode kernel's output
    at length base[b] + c. A grid of small cases, then the verify step's own
    shape. Returns the worst error against the plain version."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)
    b, nkv = len(CHUNK_BASES), 2
    worst, cases, rows = 0.0, 0, 0
    for hd in (64, 128):
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            unequal, errs = [], []
            for gqa in (1, 4, 8):
                for ps, pps in ((16, 16), (128, 2)):
                    _, k, v, base, tables = _pages_case(torch, gen, dev, dtype, b, nkv * gqa, nkv,
                                                        hd, ps, pps, b * pps + 1, CHUNK_BASES)
                    for c_len in CHUNK_LENS:
                        q = torch.randn(b, c_len, nkv * gqa, hd, generator=gen,
                                        device=dev).to(dtype)
                        err, bad = _chunk_compare(torch, q, k[0], v[0], base, tables, hd ** -0.5)
                        unequal += [(gqa, ps, c_len, c) for c in bad]
                        errs.append(err)
                        cases += 1
                        rows += b * c_len
            ok = not unequal and max(errs) <= TOL[dtype_name]
            print(f"chunk kernel: hd={hd} {dtype_name}, gqa 1/4/8, pages of 16 and 128, chunks "
                  f"{CHUNK_LENS}, {b} rows of base lengths {CHUNK_BASES}: max_abs_err against the "
                  f"plain version {max(errs):.3e} (tol {TOL[dtype_name]:g}); rows unequal to the "
                  f"decode kernel at length base + c: {len(unequal)} {unequal[:4]} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"paged attention chunk kernel disagrees: hd={hd} {dtype_name}")
            worst = max(worst, max(errs))
    c_len, nh, nkv, hd = SPEC_GAMMA + 1, 32, 4, 64
    for dtype_name, bases in itertools.product(("float32", "bfloat16"),
                                               (SERVED_CHUNK_BASES, SPLIT_EDGE_CHUNK_BASES)):
        dtype = getattr(torch, dtype_name)
        b = len(bases)
        _, k, v, base, tables = _pages_case(torch, gen, dev, dtype, b, nh, nkv, hd, 128, 16, 256,
                                            bases)
        q = torch.randn(b, c_len, nh, hd, generator=gen, device=dev).to(dtype)
        err, bad = _chunk_compare(torch, q, k[0], v[0], base, tables, hd ** -0.5)
        ok = not bad and err <= TOL[dtype_name]
        print(f"chunk kernel at the verify step's shape: B={b} C={c_len} nh={nh} nkv={nkv} "
              f"hd={hd} {dtype_name}, pages of 128, 16 per row, base lengths "
              f"{bases}: max_abs_err against the plain version {err:.3e} (tol "
              f"{TOL[dtype_name]:g}); chunk positions unequal to the decode kernel: {bad} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"paged attention chunk kernel disagrees at the verify step's "
                                 f"shape: {dtype_name}")
        worst = max(worst, err)
        cases += 1
        rows += b * c_len
    print(f"chunk kernel: {cases} cases, {rows} rows, every row bit-equal to the decode kernel")
    return worst


def phase_chunk_timing(torch, n_layers):
    """The chunk kernel, its plain version and one decode launch per chunk
    position on the same inputs, at the verify step's shape: B=8, bf16, the
    slice's lengths, a chunk of gamma + 1 = 5. Turns: plain, kernel, decode
    launches, decode launches, kernel, plain, each after the idle spin.
    Bound: every K/V row a query of the chunk sees read once, q and the
    output moved once, at 3.35 TB/s, against q.k and p.v at the bf16 peak."""
    from grasp_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_chunk, paged_attention_chunk_reference)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(98)
    lengths = [n + 32 for n in PROMPT_LENS]
    c_len, nh, nkv, hd = SPEC_GAMMA + 1, 32, 4, 64
    _, k, v, base, tables = _pages_case(torch, gen, dev, torch.bfloat16, 8, nh, nkv, hd,
                                        128, 16, 256, lengths, layers=n_layers)
    q = torch.randn(8, c_len, nh, hd, generator=gen, device=dev).bfloat16()
    singles = [(q[:, c].contiguous(), base + c) for c in range(c_len)]
    scale = hd ** -0.5

    def kern(li):
        paged_attention_chunk(q, k[li], v[li], base, tables, scale)

    def plain(li):
        paged_attention_chunk_reference(q, k[li], v[li], base, tables, scale)

    def decodes(li):
        for q_c, lens_c in singles:
            paged_attention(q_c, k[li], v[li], lens_c, tables, scale)

    # the timed inputs themselves, held as phase_chunk holds its cases
    err, bad = _chunk_compare(torch, q, k[0], v[0], base, tables, scale)
    if bad or err > TOL["bfloat16"]:
        raise AssertionError(f"paged attention chunk kernel disagrees on the timed inputs: "
                             f"max_abs_err {err:.3e}, chunk positions unequal to the decode "
                             f"kernel {bad}")
    t = {}
    for name, fn in (("plain", plain), ("kernel", kern), ("decodes", decodes),
                     ("decodes", decodes), ("kernel", kern), ("plain", plain)):
        t.setdefault(name, []).append(_time_ms(torch, fn, n_layers, 10, run_ahead=True))
    mean = {name: sum(xs) / len(xs) for name, xs in t.items()}
    kv_rows = sum(n + c_len - 1 for n in lengths)
    pairs = sum(n + c for n in lengths for c in range(c_len))  # (query, slot) pairs per head
    nbytes = (2 * kv_rows * nkv * hd * 2 + 2 * q.numel() * 2 + base.numel() * 4
              + tables.numel() * 4)
    rec = {"ms": mean["kernel"], "plain_ms": mean["plain"],
           **_bound(nbytes, 4 * pairs * nh * hd), "library_ms": None}
    print(f"chunk kernel timing (B=8 C={c_len} nh={nh} nkv={nkv} hd={hd} bf16, base lengths "
          f"{lengths}), ms per call, two turns each: "
          + ", ".join(f"{name} {xs[0]:.4f}/{xs[1]:.4f}" for name, xs in t.items())
          + f"; {c_len} decode launches over one chunk launch: "
            f"{mean['decodes'] / mean['kernel']:.2f}x" + _shares(rec))
    return rec


# (B, nh, nkv, S, hd, scale): the calibration shape of TinyLlama-1.1B, a ragged
# batch of two, head_dim 128, and a single position; None = hd ** -0.5
FLASH_CASES = ((1, 32, 4, 2047, 64, None), (2, 8, 2, 511, 64, 0.2),
               (1, 32, 8, 1024, 128, None), (1, 4, 4, 1, 64, None))
# each gradient's max abs error over the plain gradient's max abs
FLASH_GRAD_RTOL = 2e-2


def _flash_inputs(torch, gen, dev, dtype, b, nh, nkv, s, hd):
    def rand(heads):
        return torch.randn(b, heads, s, hd, generator=gen, device=dev).to(dtype).requires_grad_()
    return rand(nh), rand(nkv), rand(nkv)


def _fwd_bwd(fn, q, k, v, groups, scale):
    """o and the gradients of sum(o ** 2) with respect to q, k, v."""
    import torch

    o = fn(q, k, v, groups, scale)
    dq, dk, dv = torch.autograd.grad((o.float() ** 2).sum(), (q, k, v))
    return o.detach(), dq, dk, dv


def phase_flash(torch):
    """The three flash-attention kernels against the plain version: forward
    output and the gradients of sum(o ** 2). Returns the worst absolute
    error per kernel over all cases."""
    from grasp_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4321)
    worst = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0}
    for b, nh, nkv, s, hd, scale in FLASH_CASES:
        scale = hd ** -0.5 if scale is None else scale
        for dtype_name in ("float32", "bfloat16"):
            q, k, v = _flash_inputs(torch, gen, dev, getattr(torch, dtype_name), b, nh, nkv, s, hd)
            got = _fwd_bwd(flash_attention, q, k, v, nh // nkv, scale)
            again = _fwd_bwd(flash_attention, q, k, v, nh // nkv, scale)
            want = _fwd_bwd(flash_attention_reference, q, k, v, nh // nkv, scale)
            torch.cuda.synchronize()
            errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
            # each gradient's error is held against the plain gradient's max; one
            # that is exactly 0 (a single key: ds = 0) against the case's largest
            floor = 1e-3 * max(w.float().abs().max().item() for w in want[1:])
            rel = [e / max(w.float().abs().max().item(), floor)
                   for e, w in zip(errs[1:], want[1:])]
            finite = all(torch.isfinite(t).all().item() for t in got)
            same = all(torch.equal(g, a) for g, a in zip(got[1:], again[1:]))
            ok = (finite and same and errs[0] <= TOL[dtype_name]
                  and max(rel) <= FLASH_GRAD_RTOL)
            print(f"flash vs plain: B={b} nh={nh} nkv={nkv} S={s} hd={hd} scale={scale:.4f} "
                  f"{dtype_name}: fwd max_abs_err={errs[0]:.3e} (tol {TOL[dtype_name]:g}), grad "
                  f"max_abs_err dq={errs[1]:.3e} dk={errs[2]:.3e} dv={errs[3]:.3e}, over the "
                  f"plain gradient's max dq={rel[0]:.3e} dk={rel[1]:.3e} dv={rel[2]:.3e} (tol "
                  f"{FLASH_GRAD_RTOL:g}), dQ, dK, dV bit-equal over two runs: {same} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash attention kernels disagree: S={s} hd={hd} "
                                     f"{dtype_name}")
            worst["fwd"] = max(worst["fwd"], errs[0])
            worst["dq"] = max(worst["dq"], errs[1])
            worst["dkv"] = max(worst["dkv"], errs[2], errs[3])
    return worst


def _event_ms(torch, fn, iters, run_ahead=False):
    """Mean ms per call by CUDA events. ``run_ahead``: for calls shorter than
    the host takes to enqueue them (tens of microseconds), see :func:`_spin`."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if run_ahead:
        _spin(torch, iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_flash_timing(torch):
    """Each kernel, the plain version and the library call
    (scaled_dot_product_attention, a yardstick the port never calls) at the
    calibration shape B=1 nh=32 nkv=4 S=2047 hd=64 bf16, in turns plain,
    kernel, library, library, kernel, plain; means of each pair. For dK/dV
    and dQ the plain version is autograd's gradient with respect to (k, v) or
    to q of an already computed forward. SDPA's backward computes dQ, dK and
    dV in one pass whatever it is asked for, so the library figure of dK/dV,
    of dQ and of the whole backward ("bwd": di, then K1k and K1q) is that one
    backward with respect to (q, k, v). The bound is the larger of bytes
    moved over 3.35 TB/s and operations over 989 TFLOP/s (causal: half of the
    S x S products)."""
    import torch.nn.functional as F

    from grasp_tpu_torch.ops import flash_attention as fa
    from grasp_tpu_torch.ops._build import load_library

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(77)
    b, nh, nkv, s, hd = FLASH_CASES[0][:5]
    groups, scale = nh // nkv, hd ** -0.5
    q, k, v = (t.detach() for t in _flash_inputs(torch, gen, dev, torch.bfloat16,
                                                 b, nh, nkv, s, hd))
    dout = torch.randn(q.shape, generator=gen, device=dev).bfloat16()
    o, lse = fa._forward_cuda(q, k, v, scale)
    lib = load_library()
    plan = fa.flash_bwd_plan(b, nh, nkv, s, hd, torch.bfloat16)
    workspace = torch.empty(plan.workspace_bytes // 4, dtype=torch.float32, device=dev)
    di = (o.float() * dout.float()).sum(-1).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    def dkv(di_=di):
        fa._launch_dkv(lib, q, k, v, dout, lse, di_, dk, dv, scale, plan, workspace)

    def dq_(di_=di):
        fa._launch_dq(lib, q, k, v, dout, lse, di_, dq, scale, plan)

    def bwd():  # what the autograd function's backward runs, uncounted
        di_ = (o.float() * dout.float()).sum(-1).contiguous()
        dkv(di_)
        dq_(di_)

    kernels = {"fwd": lambda: fa._forward_cuda(q, k, v, scale), "dkv": dkv, "dq": dq_,
               "bwd": bwd}
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))

    def sdpa(q_, k_, v_, gqa=True):
        if gqa:
            return F.scaled_dot_product_attention(q_, k_, v_, is_causal=True, scale=scale,
                                                  enable_gqa=True)
        return F.scaled_dot_product_attention(
            q_, k_.repeat_interleave(groups, dim=1), v_.repeat_interleave(groups, dim=1),
            is_causal=True, scale=scale)

    # the forward, autograd's gradient with respect to (k, v) or to q alone,
    # and the whole backward
    def runners(attn, parts=True):
        def fwd():
            with torch.no_grad():
                attn(q, k, v)
        o_graph = attn(qg, kg, vg)
        out = {"fwd": fwd, "bwd": lambda: torch.autograd.grad(o_graph, (qg, kg, vg), dout,
                                                              retain_graph=True)}
        if parts:
            out["dkv"] = lambda: torch.autograd.grad(o_graph, (kg, vg), dout, retain_graph=True)
            out["dq"] = lambda: torch.autograd.grad(o_graph, (qg,), dout, retain_graph=True)
        return out

    try:
        sdpa(q, k, v)
    except TypeError:  # a PyTorch without enable_gqa: repeat the kv heads for the yardstick
        sdpa = functools.partial(sdpa, gqa=False)
    turns = {"kernel": kernels,
             "plain": runners(lambda *ts: fa.flash_attention_reference(*ts, groups, scale)),
             "library": runners(sdpa, parts=False)}
    t = {}
    for turn in ("plain", "kernel", "library", "library", "kernel", "plain"):
        for name, fn in turns[turn].items():
            t.setdefault((turn, name), []).append(_event_ms(torch, fn, 10))
    for name in ("dkv", "dq"):  # one SDPA backward gives all three gradients
        t["library", name] = t["library", "bwd"]
    mean = {key: sum(xs) / len(xs) for key, xs in t.items()}

    pairs = b * nh * s * (s + 1) / 2          # live (query, key) pairs
    qo_bytes, kv_bytes = b * nh * s * hd * 2, b * nkv * s * hd * 2
    row_bytes = b * nh * s * 4                # lse or di, fp32
    # (products of 2 * hd flops per pair, bytes read + written); the whole
    # backward reads q, k, v, o, dO and lse and writes dQ, dK, dV
    work = {"fwd": (2, 2 * qo_bytes + 2 * kv_bytes + row_bytes),
            "dkv": (4, 2 * qo_bytes + 4 * kv_bytes + 2 * row_bytes),
            "dq": (3, 3 * qo_bytes + 2 * kv_bytes + 2 * row_bytes),
            "bwd": (5, 4 * qo_bytes + 4 * kv_bytes + row_bytes)}
    library_is = {"fwd": "SDPA forward", "dkv": "the whole SDPA backward",
                  "dq": "the whole SDPA backward", "bwd": "the whole SDPA backward"}
    out = {}
    for name, (products, nbytes) in work.items():
        ops_ms = products * 2 * hd * pairs / 989e12 * 1e3
        bytes_ms = nbytes / 3.35e12 * 1e3
        out[name] = {"ms": mean["kernel", name], "plain_ms": mean["plain", name],
                     "library_ms": mean["library", name], "bound_ms": max(ops_ms, bytes_ms),
                     "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
        print(f"flash timing {name} (B=1 nh=32 nkv=4 S=2047 hd=64 bf16), ms per call, two "
              "turns each: " + ", ".join(f"{turn} {t[turn, name][0]:.4f}/{t[turn, name][1]:.4f}"
                                         for turn in turns)
              + f" (library: {library_is[name]})" + _shares(out[name]))
    return out


# (m, k, r, n) of the fused low-rank kernel: q/o and k/v projections in a
# 512-token prefill, up_proj over a calibration row, down_proj, a ragged case,
# and up_proj at compression ratio 0.5 (rank 750: three rank chunks)
LOWRANK_CASES = ((512, 2048, 102, 2048), (512, 2048, 22, 256), (2047, 2048, 150, 5632),
                 (512, 5632, 150, 2048), (300, 64, 16, 48), (2047, 2048, 750, 5632))
# max abs error over the plain output's (or gradient's) max abs
LOWRANK_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def phase_lowrank(torch):
    """The fused low-rank kernel against its plain version: the output, and
    the gradients of sum(y * g) through the autograd function against
    autograd through the plain version; a rank above 256 runs as one launch
    per rank chunk. Returns the worst absolute error."""
    from grasp_tpu_torch.ops.lowrank import fused_lowrank, fused_lowrank_plain

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2024)
    worst = 0.0
    for m, k, r, n in LOWRANK_CASES:
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            x = torch.randn(m, k, generator=gen, device=dev).to(dtype).requires_grad_()
            a = (torch.randn(k, r, generator=gen, device=dev) * k ** -0.5).to(dtype).requires_grad_()
            b = (torch.randn(r, n, generator=gen, device=dev) * r ** -0.5).to(dtype).requires_grad_()
            g = torch.randn(m, n, generator=gen, device=dev).to(dtype)
            before = fused_lowrank.launches
            got = fused_lowrank(x, a, b)
            launched = fused_lowrank.launches - before
            want = fused_lowrank_plain(x, a, b)
            got_g = torch.autograd.grad(got, (x, a, b), g)
            want_g = torch.autograd.grad(want, (x, a, b), g)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            rel = _rel_err(got, want)
            grad_rel = [_rel_err(gg, wg) for gg, wg in zip(got_g, want_g)]
            tol = LOWRANK_RTOL[dtype_name]
            finite = all(torch.isfinite(t).all().item() for t in (got, *got_g))
            ok = (finite and got.dtype == dtype and rel <= tol and max(grad_rel) <= 2 * tol
                  and launched == -(-r // 256))
            print(f"lowrank vs plain: m={m} k={k} r={r} n={n} {dtype_name}: max_abs_err={err:.3e}, "
                  f"over the plain max {rel:.3e} (tol {tol:g}), gradients dx={grad_rel[0]:.3e} "
                  f"da={grad_rel[1]:.3e} db={grad_rel[2]:.3e} (tol {2 * tol:g}), launches "
                  f"{launched} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"fused low-rank kernel disagrees: {(m, k, r, n)} {dtype_name}")
            worst = max(worst, err)
    return worst


def _turns_ms(torch, runners, iters=10):
    """Each runner timed in turns plain, kernel, library, library, kernel,
    plain (those it has); returns the mean of each pair and the raw pairs."""
    t = {}
    for turn in ("plain", "kernel", "library", "library", "kernel", "plain"):
        if turn in runners:
            t.setdefault(turn, []).append(_event_ms(torch, runners[turn], iters, run_ahead=True))
    return {k: sum(v) / len(v) for k, v in t.items()}, t


def _bound(nbytes, flops):
    bytes_ms, ops_ms = nbytes / 3.35e12 * 1e3, flops / 989e12 * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _shares(rec):
    """A timing line's tail: the kernel's share of its bound and its time
    over the library call's."""
    text = (f"; bound {rec['bound_ms']:.5f} ms by {rec['bound_by']}, the kernel at "
            f"{rec['bound_ms'] / rec['ms']:.2%} of it")
    if rec["library_ms"] is None:
        return text + ", no library call"
    return text + f", {rec['ms'] / rec['library_ms']:.2f}x the library call's time"


def phase_lowrank_timing(torch):
    """Kernel, plain version and the library call (two torch.matmul) in bf16
    at the up_proj of a calibration row and at a 512-token prefill's q_proj.
    Bound: x, A, B, y moved once against 2 m r (k + n) flops at the bf16 peak.
    The record is the first shape's."""
    from grasp_tpu_torch.ops.lowrank import fused_lowrank, fused_lowrank_plain

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    out = None
    for m, k, r, n in (LOWRANK_CASES[2], LOWRANK_CASES[0]):
        x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
        a = (torch.randn(k, r, generator=gen, device=dev) * k ** -0.5).bfloat16()
        b = (torch.randn(r, n, generator=gen, device=dev) * r ** -0.5).bfloat16()
        with torch.no_grad():
            mean, raw = _turns_ms(torch, {
                "kernel": lambda: fused_lowrank(x, a, b),
                "plain": lambda: fused_lowrank_plain(x, a, b),
                "library": lambda: torch.matmul(torch.matmul(x, a), b)})
        rec = {"ms": mean["kernel"], "plain_ms": mean["plain"], "library_ms": mean["library"],
               **_bound(2 * (m * k + k * r + r * n + m * n), 2 * m * r * (k + n))}
        print(f"lowrank timing (m={m} k={k} r={r} n={n} bf16), ms per call, two turns each: "
              + ", ".join(f"{name} {v[0]:.4f}/{v[1]:.4f}" for name, v in raw.items())
              + _shares(rec))
        out = out or rec
    return out


# (in, out) of the model's int4 weights: q/o, gate/up, down, lm_head
INT4_SHAPES = ((2048, 2048), (2048, 5632), (5632, 2048), (2048, 32000))
# the other int4 products quantized serving runs: k/v, and the low-rank
# factors of ranks 22, 102, 150 (in-factors, then rank 150's out-factors: 150
# rows pad to two groups of 128; ranks 22 and 102 make groups of 22 and 102,
# which take the dense route)
INT4_SERVED = ((2048, 256), (2048, 22), (2048, 102), (2048, 150), (5632, 150), (150, 5632),
               (150, 2048))
# |kernel - plain| <= atol + atol_rel * max|plain| + rtol * |plain|. fp32: a
# change of summation order (the JAX package's gate). bf16: both sides read
# the same bf16 x and every expanded nibble is exact in bf16, so they differ
# in the order of fp32 sums and in one bf16 rounding (rtol 1e-2 covers one
# ulp); 1e-3 of the case's largest output catches a dropped group or row.
INT4_TOL = {"float32": (2e-5, 2e-4, 0.0), "bfloat16": (1e-2, 0.0, 1e-3)}


def _int4_weight(torch, gen, dev, in_f, out_f):
    from grasp_tpu_torch.ops.quant import quantize_int4

    return quantize_int4(torch.randn(in_f, out_f, generator=gen, device=dev) * 0.02)


def _int4_expansion(torch, dev):
    """The bf16 kernels' byte -> bf16x2 expansion against unpack_int4 for
    every byte value at every byte position of a 32-bit word."""
    from grasp_tpu_torch.ops.int4_matmul import int4_expand_bytes

    i = torch.arange(256, dtype=torch.int32)
    b = ((i[:, None] + 64 * torch.arange(4)[None]) % 256).reshape(-1)
    b = torch.where(b > 127, b - 256, b).to(torch.int8)  # every value at each position
    got = int4_expand_bytes(b.to(dev)).cpu()
    want = int4_expand_bytes(b)
    ok = torch.equal(got.view(torch.int16), want.view(torch.int16))
    print(f"int4 expansion: 256 byte values x 4 positions bit-equal to unpack_int4: {ok}")
    if not ok:
        raise AssertionError("the int4 nibble expansion disagrees with unpack_int4")


def phase_int4(torch):
    """Both int4 matmul kernels against the plain version and each other,
    after the nibble expansion alone. bf16 where the dma kernel applies: the
    two variants bit-equal, and each bit-equal to itself run to run.
    Returns the worst absolute error per variant."""
    from grasp_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_plain

    dev = torch.device("cuda", 0)
    _int4_expansion(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(31)
    worst = {"grid": 0.0, "dma": 0.0}
    cases = ([(shape, m) for shape in INT4_SHAPES for m in (1, 8, 64)] + [((512, 130), 3)]
             + [(shape, m) for shape in INT4_SERVED for m in (1, 8)])
    for (in_f, out_f), m in cases:
        packed, scale = _int4_weight(torch, gen, dev, in_f, out_f)
        for dtype_name in ("float32", "bfloat16"):
            rtol, atol, atol_rel = INT4_TOL[dtype_name]
            x = torch.randn(m, in_f, generator=gen, device=dev).to(getattr(torch, dtype_name))
            want = int4_matmul_plain(x, packed, scale)
            before = dict(int4_matmul.launches)
            got = {v: int4_matmul(x, packed, scale, kernel=v) for v in ("grid", "dma")}
            torch.cuda.synchronize()
            # out % 128 != 0: the double-buffered variant hands over to the grid kernel
            ran = {v: int4_matmul.launches[v] - before[v] for v in got}
            eligible = out_f % 128 == 0
            want_ran = {"grid": 1, "dma": 1} if eligible else {"grid": 2, "dma": 0}
            bound = atol + atol_rel * want.float().abs().max().item() + rtol * want.float().abs()
            errs, ok = {}, ran == want_ran
            for v, y in got.items():
                diff = (y.float() - want.float()).abs()
                errs[v] = diff.max().item()
                ok = ok and y.dtype == x.dtype and torch.isfinite(y).all().item() and bool(
                    (diff <= bound).all().item())
            between = (got["grid"].float() - got["dma"].float()).abs()
            ok = ok and bool((between <= bound).all().item())
            same = torch.equal(got["grid"], got["dma"])
            rerun = all(torch.equal(int4_matmul(x, packed, scale, kernel=v), got[v]) for v in got)
            if dtype_name == "bfloat16" and eligible:  # one body, one plan, no atomics
                ok = ok and same and rerun
            print(f"int4 vs plain: in={in_f} out={out_f} m={m} {dtype_name}: max_abs_err grid="
                  f"{errs['grid']:.3e} dma={errs['dma']:.3e} (rtol {rtol:g}, atol {atol:g} + "
                  f"{atol_rel:g} x max|plain|), grid against dma {between.max().item():.3e}, "
                  f"bit-equal: {same}, run to run: {rerun}, launches {ran} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"int4 matmul kernels disagree: {(in_f, out_f)} m={m} "
                                     f"{dtype_name}")
            if eligible:
                worst["dma"] = max(worst["dma"], errs["dma"])
            worst["grid"] = max(worst["grid"], errs["grid"])
    return worst


def phase_int4_timing(torch):
    """Both kernels, the plain version and the library call (torch.matmul on
    the dequantized bf16 weight; the dequantization is timed apart) in bf16
    at m = 1 and m = 8 for each of the model's weight shapes and k/v's
    (2048, 256). Every timed call takes the next of enough weight copies to
    exceed the 50 MB L2, as a decode step walks 22 layers of weights. Bound:
    packed weight, scales, x and y moved once against 2 m in out flops at the
    bf16 peak. The record is the gate/up shape's at m = 8."""
    from grasp_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_plain
    from grasp_tpu_torch.ops.quant import unpack_int4

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(32)
    out = None
    for in_f, out_f in (INT4_SHAPES[1], INT4_SHAPES[0], INT4_SHAPES[2], INT4_SHAPES[3],
                        INT4_SERVED[0]):
        copies = max(2, -(-64 * 2 ** 20 // (in_f * out_f // 2)))
        weights = [_int4_weight(torch, gen, dev, in_f, out_f) for _ in range(copies)]

        def dequant(packed, scale):
            w = unpack_int4(packed).float().reshape(scale.shape[0], -1, out_f)
            return (w * scale[:, None, :]).reshape(-1, out_f).bfloat16()

        dense = [dequant(*w) for w in weights[:max(2, copies // 4)]]  # 4x the packed bytes
        turn = {"i": 0}

        def cycle(fn, pool):
            def run():
                turn["i"] += 1
                return fn(pool[turn["i"] % len(pool)])
            return run

        dequant_ms = _event_ms(torch, cycle(lambda w: dequant(*w), weights), copies,
                               run_ahead=True)
        for m in (8, 1):
            x = torch.randn(m, in_f, generator=gen, device=dev).bfloat16()
            mean, raw = _turns_ms(torch, {
                "kernel": cycle(lambda w: int4_matmul(x, *w, kernel="grid"), weights),
                "plain": cycle(lambda w: int4_matmul_plain(x, *w), weights),
                "library": cycle(lambda w: torch.matmul(x, w), dense)}, iters=2 * copies)
            dma, dma_raw = _turns_ms(torch, {
                "kernel": cycle(lambda w: int4_matmul(x, *w, kernel="dma"), weights)},
                iters=2 * copies)
            g = weights[0][1].shape[0]
            bound = _bound(in_f * out_f // 2 + g * out_f * 4 + 2 * m * (in_f + out_f),
                           2 * m * in_f * out_f)
            shared = {"plain_ms": mean["plain"], "library_ms": mean["library"], **bound}
            recs = {"grid": {"ms": mean["kernel"], **shared},
                    "dma": {"ms": dma["kernel"], **shared}}
            print(f"int4 timing (m={m} in={in_f} out={out_f} bf16, {copies} weight copies in "
                  f"turn), ms per call: grid {raw['kernel'][0]:.5f}/{raw['kernel'][1]:.5f}, dma "
                  f"{dma_raw['kernel'][0]:.5f}/{dma_raw['kernel'][1]:.5f}, plain "
                  f"{raw['plain'][0]:.4f}/{raw['plain'][1]:.4f}, library matmul on a dequantized "
                  f"weight {raw['library'][0]:.5f}/{raw['library'][1]:.5f} (dequantizing it "
                  f"{dequant_ms:.4f}); grid" + _shares(recs["grid"]) + "; dma"
                  + _shares(recs["dma"]))
            out = out or recs
        del weights, dense
    return out


# the stochastic quantizer's shapes: drive_quantizer's (a TinyLlama-1.1B
# layer's projection kernels and the lm_head), rows of 24576 (the plan's
# second variant: w read twice) and odd ones (columns no multiple of a
# 16-byte chunk: the kernel's scalar path)
QUANT_DRIVEN = ((2048, 2048), (2048, 256), (2048, 256), (2048, 2048), (2048, 5632), (2048, 5632),
                (5632, 2048), (2048, 32000))
QUANT_SHAPES = tuple(dict.fromkeys(QUANT_DRIVEN)) + ((24576, 96), (24577, 5), (256, 128),
                                                     (1000, 333), (3, 5))


def phase_quantizer(torch):
    """The stochastic int8 quantizer bit for bit against its plain version
    (the same Philox stream in torch int64 arithmetic), q and scales, at
    every shape of QUANT_SHAPES in float32 and bfloat16; and by structure and
    distribution: scales equal to quantize_int8's, every q one of the two
    neighbours of w / scale, |q scale - w| <= scale, the mean rounding error
    within 4 standard errors of 0, the same seed bit-equal and another seed
    different. Returns the largest difference of q or scale from the plain
    version's (0: bit-equal) and prints the worst |q scale - w| (the error a
    round-to-nearest quantizer halves)."""
    from grasp_tpu_torch.ops.quant import (
        quantize_int8, quantize_int8_stochastic, quantize_int8_stochastic_plain, quantize_plan)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(61)
    worst = diff = 0.0
    for (in_f, out_f), dtype_name in itertools.product(QUANT_SHAPES, ("bfloat16", "float32")):
        dtype = getattr(torch, dtype_name)
        w = (torch.randn(in_f, out_f, generator=gen, device=dev) * 0.02).to(dtype)
        w[:, 1] = 0
        q, scale = quantize_int8_stochastic(w, seed=7)
        again, _ = quantize_int8_stochastic(w, seed=7)
        other, _ = quantize_int8_stochastic(w, seed=8)
        plain_q, plain_scale = quantize_int8_stochastic_plain(w, seed=7)
        torch.cuda.synchronize()
        scaled = w.float() / scale
        low = torch.clamp(torch.floor(scaled), -127, 127)
        high = torch.clamp(torch.floor(scaled) + 1, -127, 127)
        qf = q.float()
        neighbours = bool(((qf == low) | (qf == high)).all().item())
        # |q scale - w| <= scale, with room for the product's own rounding
        err = ((qf * scale - w.float()).abs() - scale * (1 + 1e-5)).max().item()
        mean = (qf - scaled).mean().item()
        se = 0.5 / (in_f * out_f) ** 0.5  # a rounding error's variance is at most 1/4
        bits = torch.equal(q, plain_q) and torch.equal(scale, plain_scale)
        same_scale = torch.equal(scale, quantize_int8(w)[1])
        seeds = torch.equal(q, again) and (in_f * out_f <= 100 or not torch.equal(q, other))
        ok = (bits and same_scale and seeds and q.dtype == torch.int8
              and tuple(scale.shape) == (1, out_f) and bool((q[:, 1] == 0).all().item())
              and neighbours and err <= 0 and abs(mean) <= 4 * se)
        plan = quantize_plan(in_f, out_f, dtype)
        print(f"quantizer: {in_f}x{out_f} {dtype_name} (cluster {plan.cluster} x "
              f"{plan.rows_per_block} rows, {'one read' if plan.keep else 'two reads'}): q and "
              f"scales bit-equal to the plain version: {bits}; scales equal quantize_int8's: "
              f"{same_scale}; q in the two neighbours of w/scale: {neighbours}; mean of q - "
              f"w/scale {mean:.3e} (4 standard errors: {4 * se:.3e}); rounded up "
              f"{(qf == high).float().mean().item():.4f}; same seed bit-equal, another seed "
              f"not: {seeds} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"stochastic quantizer: {in_f}x{out_f} {dtype_name}")
        worst = max(worst, (qf * scale - w.float()).abs().max().item())
        diff = max(diff, (qf - plain_q.float()).abs().max().item(),
                   (scale - plain_scale).abs().max().item())
    print(f"quantizer: worst |q scale - w| {worst:.3e}; largest difference from the plain "
          f"version {diff:g}")
    return diff


def phase_quantizer_timing(torch):
    """Kernel and plain version in bf16 at a gate/up projection (2048 x 5632)
    and at the lm_head (2048 x 32000), in turns plain, kernel, kernel, plain.
    Every timed call takes the next of enough copies of w to exceed the 50 MB
    L2, as the quantizer's caller meets each weight once, from device memory.
    No single PyTorch call computes the function. Bound: w read once, q and
    the scales written once, against 5 fp32 operations and 10 32-bit products
    an element (Philox: 40 products a call of four elements) at the 67 TFLOP/s
    of fp32 outside the tensor cores. The record is the gate/up shape's."""
    from grasp_tpu_torch.ops.quant import quantize_int8_stochastic, quantize_int8_stochastic_plain

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(62)
    out = None
    for in_f, out_f in ((2048, 5632), (2048, 32000)):
        copies = max(2, -(-64 * 2 ** 20 // (in_f * out_f * 2)))
        weights = [(torch.randn(in_f, out_f, generator=gen, device=dev) * 0.02).bfloat16()
                   for _ in range(copies)]
        turn = {"i": 0}

        def cycle(fn):
            def run():
                turn["i"] += 1
                return fn(weights[turn["i"] % copies])
            return run

        mean, raw = _turns_ms(torch, {
            "kernel": cycle(lambda w: quantize_int8_stochastic(w, seed=1)),
            "plain": cycle(lambda w: quantize_int8_stochastic_plain(w, seed=1))},
            iters=4 * copies)
        n = in_f * out_f
        bytes_ms, ops_ms = (3 * n + 4 * out_f) / 3.35e12 * 1e3, 15 * n / 67e12 * 1e3
        rec = {"ms": mean["kernel"], "plain_ms": mean["plain"], "library_ms": None,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        print(f"quantizer timing ({in_f}x{out_f} bf16, {copies} copies of w in turn), ms per "
              f"call, two turns each: "
              + ", ".join(f"{name} {v[0]:.5f}/{v[1]:.5f}" for name, v in raw.items())
              + _shares(rec))
        out = out or rec
        del weights
    return out


def build_flagship(torch, dev):
    """TinyLlama-1.1B at full width, bf16, random weights from a seeded
    generator; the last two layers' seven projections become GRASP
    low-rank factors at preserve_rank(in, out, 0.9)."""
    import dataclasses

    from grasp_tpu_torch import ModelConfig
    from grasp_tpu_torch.models.llama import (
        ATTN_PROJS, PROJ_ORDER, default_plan, init_params, plan_set)
    from grasp_tpu_torch.ops.saliency import preserve_rank

    config = dataclasses.replace(ModelConfig.tinyllama_1_1b(), dtype="bfloat16")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(gen, config, device=dev)
    plan = default_plan(config)
    for li in (config.num_hidden_layers - 1, config.num_hidden_layers - 2):
        for proj in PROJ_ORDER:
            group = params["layers"][li]["self_attn" if proj in ATTN_PROJS else "mlp"]
            in_f, out_f = group[proj]["kernel"].shape
            r = max(preserve_rank(in_f, out_f, 0.9), 8)
            group[proj] = {
                "in_kernel": (torch.randn(in_f, r, generator=gen, device=dev) * 0.02).bfloat16(),
                "out_kernel": (torch.randn(r, out_f, generator=gen, device=dev) * 0.02).bfloat16(),
            }
            plan = plan_set(plan, li, proj, "lowrank")
    return config, params, plan


def _post(port, body, timeout=600):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", "/v1/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _stream(port, body):
    """POST a streamed completion; returns (status, tokens, seconds to the
    first token chunk)."""
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", "/v1/completions", json.dumps(dict(body, stream=True)),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    toks, ttft, done = [], None, False
    for raw in resp:
        line = raw.decode().strip()
        if not line.startswith("data: "):
            continue
        if line == "data: [DONE]":
            done = True
            break
        chunk = json.loads(line[len("data: "):])
        if "error" in chunk:
            raise AssertionError(f"stream error: {chunk['error']}")
        if chunk["choices"][0]["token_ids"] and ttft is None:
            ttft = time.perf_counter() - t0
        toks += chunk["choices"][0]["token_ids"]
    conn.close()
    if not done:
        raise AssertionError("stream ended without [DONE]")
    return resp.status, toks, ttft


def _check_completion(status, data, prompt):
    if status != 200:
        raise AssertionError(f"HTTP {status}: {data[:300]!r}")
    body = json.loads(data)
    out = body["choices"][0]["token_ids"]
    n = body["usage"]["completion_tokens"]
    if not (1 <= n <= MAX_TOKENS and n == len(out)):
        raise AssertionError(f"completion has {n} tokens ({len(out)} ids)")
    if body["usage"]["prompt_tokens"] != len(prompt):
        raise AssertionError("prompt_tokens mismatch")
    return out


def check_against_plain(torch, params, config, plan, served, dev, quantized_kv=False):
    """Teacher-forced plain forward (no pages, no kernel) of prompt + served
    tokens: at every generated position the served token's logit must be
    within GAP_TOL of the largest logit. ``quantized_kv``: the forward runs
    through the int8 dense cache, so that its attention reads the quantized
    K/V the int8 pools hold. Returns (max gap, argmax matches, positions)."""
    from grasp_tpu_torch.models.llama import forward, init_kv_cache, prefill

    worst, match, total = 0.0, 0, 0
    with torch.no_grad():
        for prompt, out in served:
            ids = torch.tensor([list(prompt) + out[:-1]], device=dev)
            if quantized_kv:
                cache = init_kv_cache(config, 1, ids.shape[1], device=dev, quantized=True)
                logits = prefill(params, ids, cache, config=config, plan=plan)[0][0].float()
            else:
                logits = forward(params, ids, config=config, plan=plan)["logits"][0].float()
            if not torch.isfinite(logits).all():
                raise AssertionError("non-finite logits in the plain forward")
            rows = logits[len(prompt) - 1:]
            served_t = torch.tensor(out, device=dev)
            gap = rows.max(dim=-1).values - rows.gather(1, served_t[:, None])[:, 0]
            worst = max(worst, gap.max().item())
            match += int((rows.argmax(dim=-1) == served_t).sum().item())
            total += len(out)
    return worst, match, total


SERVE_ARGS = ["--host", "127.0.0.1", "--port", "0", "--max_batch", "8", "--page_size", "128",
              "--num_pages", "256", "--max_pages_per_seq", "16"]
# prompts of the quantized and fused variants: all longer than 64 tokens, so
# that the teacher-forced forward that checks them stays off the int4 kernels,
# and one of 256 rows or more after padding, which the fused kernel takes
VARIANT_PROMPT_LENS = (70, 130, 600)
VARIANT_MAX_TOKENS = 16


@contextlib.contextmanager
def _served(torch, dev, ckpt_root, extra=()):
    """``grasp-serve-torch`` on the checkpoint, in this process: yields
    (engine, port) and shuts the server down afterwards."""
    from grasp_tpu_torch.cli import serve_main

    handles = serve_main(["--model_path", ckpt_root, "--device", str(dev), *SERVE_ARGS, *extra],
                         block=False)
    try:
        yield handles[0].engine, handles[1].server_address[1]
    finally:
        handles[1].shutdown()
        handles[1].server_close()
        handles[0].close()
        del handles
        torch.cuda.empty_cache()


def _int4_projections(params):
    """(groups' size, output width) of every int4 product the model runs per
    forward, in order: each dense projection, both products of each low-rank
    pair, the lm_head."""
    def geometry(packed, scale):
        return 2 * packed.shape[0] // scale.shape[0], packed.shape[1]

    out = []
    for layer in params["layers"]:
        for group in ("self_attn", "mlp"):
            for p in layer[group].values():
                for key in ("kernel", "in_kernel", "out_kernel"):
                    if key + "_q4" in p:
                        out.append(geometry(p[key + "_q4"], p[key + "_scale"]))
    if "kernel_q4" in params.get("lm_head", {}):
        out.append(geometry(params["lm_head"]["kernel_q4"], params["lm_head"]["kernel_scale"]))
    return out


def serve_variant(torch, dev, ckpt_root, label, extra=(), dma_round=False):
    """Serve the checkpoint one more way, a few completions one after the
    other, and hold the tokens to a teacher-forced plain forward of the
    served params and the launch counts to the dispatch rules. Returns the
    launches of the new kernels on this path."""
    import dataclasses

    import numpy as np

    from grasp_tpu_torch.ops.int4_matmul import int4_matmul
    from grasp_tpu_torch.ops.lowrank import FUSED_MIN_ROWS, fused_lowrank
    from grasp_tpu_torch.ops.paged_attention import paged_attention
    from grasp_tpu_torch.ops.quant import takes_int4_kernel

    rng = np.random.default_rng(17)
    t0 = time.perf_counter()
    with _served(torch, dev, ckpt_root, extra) as (engine, port):
        config = engine.config
        prompts = [rng.integers(3, config.vocab_size, size=n).tolist()
                   for n in VARIANT_PROMPT_LENS]
        _check_completion(*_post(port, {"prompt": prompts[0][:65], "max_tokens": 2}),
                          prompts[0][:65])  # warm-up, not counted
        start_s = time.perf_counter() - t0

        def run_round():
            """Counts set to 0, the three completions, counts read."""
            int4_matmul.launches.update(grid=0, dma=0)
            fused_lowrank.launches = paged_attention.launches = 0
            engine.decode_steps, engine.decode_seconds = 0, 0.0
            outs = []
            for prompt in prompts:
                status, data = _post(port, {"prompt": prompt, "max_tokens": VARIANT_MAX_TOKENS})
                outs.append(_check_completion(status, data, prompt))
            return outs, {"grid": int4_matmul.launches["grid"], "dma": int4_matmul.launches["dma"],
                          "fused": fused_lowrank.launches, "paged": paged_attention.launches}

        def derived(dma):
            """Launches per round from the dispatch rules, in plain Python: an
            int4 product takes a kernel at 64 rows or fewer and a group size
            that is a multiple of 128 (decode runs max_batch rows, prefill the
            padded prompt); a low-rank pair takes the fused kernel when the
            config asks and the call has 256 rows or more."""
            steps = engine.decode_steps
            want = {"grid": 0, "dma": 0, "fused": 0, "paged": config.num_hidden_layers * steps}
            ps = engine.pool.page_size
            padded = [-(-len(p) // ps) * ps for p in prompts]
            for rows, times in [(8, steps)] + [(n, 1) for n in padded]:
                for gs, out_f in _int4_projections(engine.params):
                    if takes_int4_kernel(rows, gs):
                        want["dma" if dma and out_f % 128 == 0 else "grid"] += times
                if config.use_pallas_lowrank and rows >= FUSED_MIN_ROWS:
                    want["fused"] += times * sum(
                        "in_kernel" in p for layer in engine.params["layers"]
                        for group in ("self_attn", "mlp") for p in layer[group].values())
            return want

        outs, got = run_round()
        steps, secs = engine.decode_steps, engine.decode_seconds
        want = derived(dma=False)
        print(f"serve {label}: started in {start_s:.1f} s; {len(outs)} completions of "
              f"{[len(o) for o in outs]} tokens, {steps} decode steps in {secs:.3f} s "
              f"({secs / max(steps, 1) * 1e3:.2f} ms per step, one request at a time); launches "
              f"{got}, derived {want}")
        if steps == 0 or got != want:
            raise AssertionError(f"serve {label}: launch counts differ from the dispatch rules")
        plain_config = dataclasses.replace(config, use_pallas_lowrank=False)
        gap, match, total = check_against_plain(torch, engine.params, plain_config, engine.plan,
                                                list(zip(prompts, outs)), dev)
        print(f"serve {label}: served vs plain teacher-forced forward of the served params: "
              f"argmax agrees at {match}/{total} positions, max logit gap {gap:.4f} "
              f"(tol {GAP_TOL})")
        if gap > GAP_TOL:
            raise AssertionError(f"serve {label}: served tokens disagree with the plain forward")
        if dma_round:
            os.environ["GRASP_INT4_KERNEL"] = "dma"
            try:
                dma_outs, dma_got = run_round()
                dma_secs = engine.decode_seconds / max(engine.decode_steps, 1)
            finally:
                del os.environ["GRASP_INT4_KERNEL"]
            dma_want = derived(dma=True)
            gap, match, total = check_against_plain(torch, engine.params, plain_config,
                                                    engine.plan, list(zip(prompts, dma_outs)), dev)
            print(f"serve {label}, GRASP_INT4_KERNEL=dma: {dma_secs * 1e3:.2f} ms per step; "
                  f"launches {dma_got}, derived {dma_want}; argmax agrees at {match}/{total} "
                  f"positions, max logit gap {gap:.4f}; same tokens as the grid kernel: "
                  f"{dma_outs == outs}")
            if dma_got != dma_want or dma_got["dma"] == 0 or gap > GAP_TOL:
                raise AssertionError(f"serve {label}: the double-buffered variant failed")
            got["dma"] = dma_got["dma"]
    return got


SPEC_PROMPT_LENS = (70, 130, 300, 600)
SPEC_MAX_TOKENS = 32
# mean share of positions at which the speculative and the plain engine's
# greedy streams agree (the JAX package's own bound on hardware): a faulty
# verify step collapses it to near 0 after the first accepted draft
SPEC_AGREEMENT = 0.7


def _concurrent_posts(port, bodies):
    """POST the bodies at once, one thread each; returns (status, data) in order."""
    results = [None] * len(bodies)

    def worker(i):
        results[i] = _post(port, bodies[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
        if t.is_alive():
            raise AssertionError("a completion request did not finish")
    return results


def _reset_paged_counts(engine):
    from grasp_tpu_torch.ops.paged_attention import paged_attention, paged_attention_chunk

    paged_attention.launches = paged_attention_chunk.launches = 0
    engine.decode_steps, engine.decode_seconds = 0, 0.0
    if hasattr(engine, "macro_steps"):
        engine.macro_steps = 0
        engine.last_stats.update(chunks=0, drafted=0, accepted=0)


def _full_length(results, prompts, n_tokens, label):
    outs = [_check_completion(s, d, p) for (s, d), p in zip(results, prompts)]
    if any(len(o) != n_tokens for o in outs):
        raise AssertionError(f"serve {label}: completions of {[len(o) for o in outs]} tokens, "
                             f"want {n_tokens} each")
    return outs


def serve_speculative(torch, card, dev, ckpt_root):
    """This slice's main path: ``--speculative int8 --gamma 4`` over fp pools.
    Greedy requests together, then a sampled one. Returns the launches of the
    chunk kernel and of the decode kernel in that run."""
    import numpy as np

    from grasp_tpu_torch.ops.paged_attention import paged_attention, paged_attention_chunk
    from grasp_tpu_torch.serving.paged import ServingEngine
    from grasp_tpu_torch.serving.spec_paged import SpeculativeServingEngine

    label = f"--speculative int8 --gamma {SPEC_GAMMA}"
    rng = np.random.default_rng(23)
    t0 = time.perf_counter()
    with _served(torch, dev, ckpt_root,
                 ["--speculative", "int8", "--gamma", str(SPEC_GAMMA)]) as (engine, port):
        if not isinstance(engine, SpeculativeServingEngine):
            raise AssertionError("the command line did not build the speculative engine")
        config = engine.config
        layers = config.num_hidden_layers
        prompts = [rng.integers(3, config.vocab_size, size=n).tolist() for n in SPEC_PROMPT_LENS]
        _check_completion(*_post(port, {"prompt": prompts[0][:65], "max_tokens": 8}),
                          prompts[0][:65])  # warm-up, not counted
        start_s = time.perf_counter() - t0

        _reset_paged_counts(engine)
        t1 = time.perf_counter()
        outs = _full_length(_concurrent_posts(port, [
            {"prompt": p, "max_tokens": SPEC_MAX_TOKENS} for p in prompts]),
            prompts, SPEC_MAX_TOKENS, label)
        wall = time.perf_counter() - t1
        sampled = _full_length([_post(port, {
            "prompt": prompts[1], "max_tokens": SPEC_MAX_TOKENS, "temperature": 0.8,
            "top_k": 40, "top_p": 0.95, "seed": 5})], prompts[1:2], SPEC_MAX_TOKENS, label)[0]
        steps, stats = engine.macro_steps, dict(engine.last_stats)
        got = {"chunk": paged_attention_chunk.launches, "decode": paged_attention.launches}
        want = {"chunk": layers * steps, "decode": layers * (SPEC_GAMMA + 1) * steps}
        n_tok = sum(len(o) for o in outs) + len(sampled)
        print(f"serve {label}: started in {start_s:.1f} s; {len(outs)} greedy completions "
              f"together ({wall:.3f} s) and 1 sampled, {SPEC_MAX_TOKENS} tokens each; {steps} "
              f"macro-steps in {engine.decode_seconds:.3f} s "
              f"({engine.decode_seconds / max(steps, 1) * 1e3:.2f} ms each); launches {got}, "
              f"derived from the macro-steps {want}; drafts accepted "
              f"{stats['accepted']}/{stats['drafted']} = {engine.acceptance_rate:.3f}, "
              f"{n_tok / max(stats['chunks'], 1):.2f} tokens per verify forward of a row; "
              f"card {card}")
        if (steps == 0 or got != want or engine.decode_steps != (SPEC_GAMMA + 1) * steps
                or any(not 0 <= t < config.vocab_size for t in sampled)):
            raise AssertionError(f"serve {label}: launch counts differ from the macro-steps")

        gap, match, total = check_against_plain(torch, engine.params, config, engine.plan,
                                                list(zip(prompts, outs)), dev)
        print(f"serve {label}: greedy tokens vs plain teacher-forced forward of the target: "
              f"argmax agrees at {match}/{total} positions, max logit gap {gap:.4f} "
              f"(tol {GAP_TOL})")
        if gap > GAP_TOL:
            raise AssertionError(f"serve {label}: served tokens disagree with the plain forward")

        # the same requests through the plain engine over the same weights
        plain = ServingEngine(engine.params, config, engine.plan, device=dev, num_pages=256,
                              page_size=128, max_batch=8, max_pages_per_seq=16)
        rids = [plain.submit(p, SPEC_MAX_TOKENS) for p in prompts]
        with torch.no_grad():
            plain_outs = plain.run()
        plain_outs = [plain_outs[r] for r in rids]
        del plain
        agree = [sum(a == b for a, b in zip(o, w)) / len(w) for o, w in zip(outs, plain_outs)]
        same = sum(o == w for o, w in zip(outs, plain_outs))
        mean = sum(agree) / len(agree)
        print(f"serve {label}: against the plain engine on the same requests: {same}/{len(outs)} "
              f"streams identical, share of agreeing positions {[round(a, 3) for a in agree]}, "
              f"mean {mean:.3f} (bound {SPEC_AGREEMENT}; identity is reported, not required: the "
              f"verify step's projections run at {8 * (SPEC_GAMMA + 1)} rows and the decode "
              f"step's at 8)")
        if [len(o) for o in plain_outs] != [len(o) for o in outs] or mean < SPEC_AGREEMENT:
            raise AssertionError(f"serve {label}: streams stray from the plain engine's")
    return got


def serve_quantized_kv(torch, dev, ckpt_root, speculative):
    """``--quantized_kv``, with or without speculation: int8 pools take the
    gather route, so neither paged kernel may launch; tokens are held by a
    teacher-forced forward through the int8 dense cache."""
    import numpy as np

    from grasp_tpu_torch.ops.paged_attention import paged_attention, paged_attention_chunk

    extra = ["--quantized_kv"]
    if speculative:
        extra += ["--speculative", "int8", "--gamma", str(SPEC_GAMMA)]
    label = " ".join(extra)
    rng = np.random.default_rng(29)
    with _served(torch, dev, ckpt_root, extra) as (engine, port):
        if not engine.pool.quantized or engine.pool.k_pages.dtype != torch.int8:
            raise AssertionError(f"serve {label}: the pool is not int8")
        config = engine.config
        prompts = [rng.integers(3, config.vocab_size, size=n).tolist()
                   for n in VARIANT_PROMPT_LENS]
        _reset_paged_counts(engine)
        outs = _full_length(_concurrent_posts(port, [
            {"prompt": p, "max_tokens": VARIANT_MAX_TOKENS} for p in prompts]),
            prompts, VARIANT_MAX_TOKENS, label)
        launches = (paged_attention.launches, paged_attention_chunk.launches)
        steps = engine.decode_steps
        gap, match, total = check_against_plain(torch, engine.params, config, engine.plan,
                                                list(zip(prompts, outs)), dev, quantized_kv=True)
        spec = (f", {engine.macro_steps} macro-steps, drafts accepted "
                f"{engine.last_stats['accepted']}/{engine.last_stats['drafted']}"
                if speculative else "")
        print(f"serve {label}: {len(outs)} completions of {VARIANT_MAX_TOKENS} tokens, {steps} "
              f"decode steps in {engine.decode_seconds:.3f} s{spec}; decode and chunk kernel "
              f"launches {launches} (want 0, 0); vs teacher-forced forward through the int8 "
              f"dense cache: argmax agrees at {match}/{total} positions, max logit gap "
              f"{gap:.4f} (tol {GAP_TOL})")
        if steps == 0 or launches != (0, 0) or gap > GAP_TOL:
            raise AssertionError(f"serve {label} failed")


def phase_slice(torch, card, dev, spec_only=False):
    """The serving slice, then the same checkpoint served with speculation
    and int8 KV pages, with int4 weights, int8 weights and the fused low-rank
    kernel. Returns the launches of the paged kernel on the main path, of
    the chunk and decode kernels under speculation, and of the int4 and
    fused kernels on theirs. ``spec_only``: the speculative and int8-KV parts
    alone."""
    from grasp_tpu_torch.checkpoints import META_NAME, save_checkpoint
    from grasp_tpu_torch.models.convert import flatten_params

    config, params, plan = build_flagship(torch, dev)
    n_params = sum(t.numel() for t in flatten_params(params).values())
    print(f"slice: TinyLlama-1.1B bf16, {config.num_hidden_layers} layers, "
          f"low-rank layers {[i for i, lp in enumerate(plan) if 'lowrank' in lp]}, "
          f"{n_params} parameters")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt_root = tempfile.mkdtemp(prefix="smoke_ckpt_", dir=os.path.join(ROOT, "build"))
    try:
        t0 = time.perf_counter()
        save_checkpoint(ckpt_root, params, config, plan)
        del params
        torch.cuda.empty_cache()
        launches = None if spec_only else _serve_main_path(torch, card, dev, ckpt_root, config, t0)
        spec_launches = serve_speculative(torch, card, dev, ckpt_root)
        serve_quantized_kv(torch, dev, ckpt_root, speculative=False)
        serve_quantized_kv(torch, dev, ckpt_root, speculative=True)
        if spec_only:
            return launches, spec_launches, None
        variants = {"int4": serve_variant(torch, dev, ckpt_root, "--quantize int4",
                                          ["--quantize", "int4"], dma_round=True),
                    "int8": serve_variant(torch, dev, ckpt_root, "--quantize int8",
                                          ["--quantize", "int8"])}
        meta_path = os.path.join(ckpt_root, META_NAME)
        with open(meta_path) as f:
            meta = json.load(f)
        meta["model_config"]["use_pallas_lowrank"] = True
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        variants["fused"] = serve_variant(torch, dev, ckpt_root, "use_pallas_lowrank")
        if variants["fused"]["fused"] == 0 or variants["int4"]["grid"] == 0:
            raise AssertionError("a serving variant never reached its kernel")
        return launches, spec_launches, variants
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)


def _serve_main_path(torch, card, dev, ckpt_root, config, t0):
    import numpy as np

    from grasp_tpu_torch.ops.paged_attention import paged_attention

    with _served(torch, dev, ckpt_root) as (engine, port):
        print(f"slice: checkpoint saved and served on 127.0.0.1:{port} in "
              f"{time.perf_counter() - t0:.1f} s")

        rng = np.random.default_rng(0)
        prompts = [rng.integers(3, config.vocab_size, size=n).tolist() for n in PROMPT_LENS]
        stream_prompt = rng.integers(3, config.vocab_size, size=512).tolist()

        # warm-up (cuBLAS handles, allocator): one short request, not counted
        _check_completion(*_post(port, {"prompt": prompts[0], "max_tokens": 4}), prompts[0])

        paged_attention.launches = 0
        engine.decode_steps, engine.decode_seconds = 0, 0.0
        status, stoks, ttft = _stream(port, {"prompt": stream_prompt, "max_tokens": MAX_TOKENS})
        if status != 200 or not 1 <= len(stoks) <= MAX_TOKENS:
            raise AssertionError(f"stream: HTTP {status}, {len(stoks)} tokens")
        results = [None] * len(prompts)

        def worker(i):
            results[i] = _post(port, {"prompt": prompts[i], "max_tokens": MAX_TOKENS})

        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/v1/models")
        models = conn.getresponse()
        models_body = json.loads(models.read())
        conn.close()
        for t in threads:
            t.join(timeout=900)
            if t.is_alive():
                raise AssertionError("a completion request did not finish")
        wall = time.perf_counter() - t0
        outs = [_check_completion(s, d, p) for (s, d), p in zip(results, prompts)]
        if models.status != 200 or models_body["data"][0]["id"] != ckpt_root:
            raise AssertionError(f"/v1/models: HTTP {models.status} {models_body}")

        launches, steps = paged_attention.launches, engine.decode_steps
        want = config.num_hidden_layers * steps
        print(f"slice: 1 streamed + {len(outs)} concurrent completions, tokens "
              f"{[len(stoks)] + [len(o) for o in outs]}; decode steps {steps}, kernel "
              f"launches {launches} (want {config.num_hidden_layers} x {steps} = {want})")
        if steps == 0 or launches != want:
            raise AssertionError("the decode path did not run the kernel once per layer per step")
        n_tok = sum(len(o) for o in outs)
        print(f"slice: TTFT (streamed, 512-token prompt, alone) {ttft * 1e3:.1f} ms; "
              f"8 concurrent requests: {n_tok} tokens in {wall:.3f} s = "
              f"{n_tok / wall:.1f} tok/s end to end; decode steps "
              f"{steps} in {engine.decode_seconds:.3f} s; card {card}")
        decode_tok = sum(len(o) for o in outs) + len(stoks)
        print(f"slice: decode-only rate {decode_tok / engine.decode_seconds:.1f} tok/s "
              f"(tokens of all 9 requests over host time inside decode steps)")

        gap, match, total = check_against_plain(
            torch, engine.params, engine.config, engine.plan,
            [(stream_prompt, stoks)] + list(zip(prompts[:3], outs[:3])), dev)
        print(f"slice: served vs plain teacher-forced forward: argmax agrees at "
              f"{match}/{total} positions, max logit gap {gap:.4f} (tol {GAP_TOL})")
        if gap > GAP_TOL:
            raise AssertionError("served tokens disagree with the plain forward")
        return launches


# the compression slice: TinyLlama-1.1B at full width and depth, calibration
# rows of 2048 tokens (2047 after the loader's pre-shift)
COMPRESS_ARGS = ["--model_name_or_path", "tinyllama-1.1b", "--dataset_name", "synthetic",
                 "--num_prune_layers", "2", "--compression_ratio", "0.9",
                 "--num_samples", "16", "--seq_len", "2048", "--dtype", "bfloat16"]
# a round's summed gradients in bf16 against the plain route in fp32, max abs
# error over the reference's max. bf16 rounding alone puts either route near
# 2e-2 there, so the flash route passes within 2e-2 or within 1.5 times what
# the plain bf16 route shows (the kernels themselves are held to the plain
# version above, at 1e-4 in fp32)
FLASH_SWEEP_RTOL = 2e-2
FLASH_SWEEP_SLACK = 1.5
# the prefix modes compute the same values; where the card's kernels would
# break bit-equality, the compiled factors may differ by this much of their max
PREFIX_FACTOR_RTOL = 1e-3
# the share of a projection's selected indices that the gram SVDs must share
# with the device SVD's
GRAM_AGREEMENT = 0.98


def _param_count(params):
    from grasp_tpu_torch.models.convert import flatten_params

    return sum(t.numel() for t in flatten_params(params).values())


def _want_flash(n_layers, n_rows, sweep_layers, prefix_layer, prefix):
    """K1f and K1k/K1q launches of a run: block influence runs every layer
    for every row; each sweep (``sweep_layers``: the lowest target layer of
    each, and the attention rounds' flag) runs its forward from the prefix
    boundary, whose forward runs once a row ("cache") or in every sweep
    ("recompute"), and its backward through the attention of every layer
    whose input depends on a target: above the target layer, and the layer
    itself for an attention round."""
    start = prefix_layer if prefix != "off" else 0
    prefix_fwd = {"off": 0, "cache": 1, "recompute": len(sweep_layers)}[prefix] * start
    fwd = n_rows * (n_layers + prefix_fwd + len(sweep_layers) * (n_layers - start))
    bwd = n_rows * sum(n_layers - lowest - (0 if attn else 1) for lowest, attn in sweep_layers)
    return fwd, bwd


def _check_checkpoint(torch, ckpt_root, dev, label, layers=None):
    """The saved compression: two layers, every rank preserve_rank(in, out,
    0.9), the plan, the factors' shapes, fewer parameters, a finite forward.
    Returns (meta, config)."""
    import numpy as np

    from grasp_tpu_torch.checkpoints import load_checkpoint
    from grasp_tpu_torch.core.engine import module_name, parse_module_name
    from grasp_tpu_torch.models.llama import PROJ_ORDER, _proj_shapes, forward
    from grasp_tpu_torch.ops.saliency import preserve_rank

    params, config, plan, meta = load_checkpoint(ckpt_root, dev)
    got_layers = meta["redundant_layers"]
    n_layers = config.num_hidden_layers
    if len(set(got_layers)) != 2 or not all(0 <= li < n_layers for li in got_layers):
        raise AssertionError(f"{label}: block influence chose {got_layers}, not 2 layers")
    if layers is not None and got_layers != layers:
        raise AssertionError(f"{label}: layers {got_layers}, the sequential run chose {layers}")
    shapes = _proj_shapes(config)
    want_ranks = {module_name(li, proj): preserve_rank(*shapes[proj], 0.9)
                  for li in got_layers for proj in PROJ_ORDER}
    if meta["rank_dict"] != want_ranks:
        raise AssertionError(f"{label}: rank_dict {meta['rank_dict']} != {want_ranks}")
    for li, layer_plan in enumerate(plan):
        want_kind = "lowrank" if li in got_layers else "dense"
        if any(kind != want_kind for kind in layer_plan):
            raise AssertionError(f"{label}: plan of layer {li} is {layer_plan}")
    for name, rank in want_ranks.items():
        li, group, proj = parse_module_name(name)
        got = params["layers"][li][group][proj]
        in_f, out_f = shapes[proj]
        if (tuple(got["in_kernel"].shape), tuple(got["out_kernel"].shape)) != (
                (in_f, rank), (rank, out_f)):
            raise AssertionError(f"{label}: {name}: factors of the wrong shape")
    dense_count = (sum(i * o for i, o in shapes.values()) * n_layers
                   + (2 * n_layers + 1) * config.hidden_size
                   + config.vocab_size * config.hidden_size
                   * (1 if config.tie_word_embeddings else 2))
    count = _param_count(params)
    if not count < dense_count:
        raise AssertionError(f"{label}: parameter count {count} did not fall below {dense_count}")
    with torch.no_grad():
        ids = torch.tensor(np.random.default_rng(5).integers(0, config.vocab_size, (1, 512)),
                           device=dev)
        logits = forward(params, ids, config=config, plan=plan)["logits"]
    if tuple(logits.shape) != (1, 512, config.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"{label}: the saved checkpoint's forward is not finite")
    print(f"{label}: layers {got_layers}, {len(want_ranks)} projections low-rank, ranks "
          f"{sorted(set(want_ranks.values()))}, parameters {dense_count} -> {count}; the saved "
          f"checkpoint loads and its forward is finite")
    return meta, config


def _compress_cli(torch, dev, ckpt_root, extra, label, card):
    """grasp-compress-torch with COMPRESS_ARGS + extra; returns (meta, config,
    flash launches, wall seconds)."""
    from grasp_tpu_torch.cli import compress_main
    from grasp_tpu_torch.ops.flash_attention import flash_attention

    print(f"{label}: grasp-compress-torch {' '.join(COMPRESS_ARGS + extra)} --device {dev}")
    for name in flash_attention.launches:
        flash_attention.launches[name] = 0
    t0 = time.perf_counter()
    rc = compress_main(COMPRESS_ARGS + extra + ["--save_path", ckpt_root, "--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(flash_attention.launches)
    if rc != 0:
        raise AssertionError(f"{label}: compress_main returned {rc}")
    with open(os.path.join(ckpt_root, "grasp_meta.json")) as f:
        summary = json.load(f)["extra"]["summary"]
    print(f"{label}: {wall:.1f} s end to end (summary {summary['wall_clock_s']:.2f} s), stage "
          f"seconds {summary['stage_times_s']}, prefix {summary['prefix']}; card {card}")
    return launches, wall, summary


def _hold_launches(label, launches, want):
    print(f"{label}: flash launches fwd {launches['fwd']} (want {want[0]}), dkv "
          f"{launches['dkv']} and dq {launches['dq']} (want {want[1]})")
    if launches != {"fwd": want[0], "dkv": want[1], "dq": want[1]}:
        raise AssertionError(f"{label}: the sweeps did not run the flash kernels as counted")


def phase_compress(torch, card, dev, evaluate_only=False):
    """``grasp-compress-torch`` on the card, sequential (its checkpoint then
    evaluated: phase_evaluate) and parallel, then checks of what each saved
    and of the engine's run options at the same width. Returns the launch
    counts of the three flash kernels in the two runs, those of the fused
    low-rank kernel in its compressions, and the evaluation's.
    ``evaluate_only``: the sequential run and its evaluation alone."""
    from grasp_tpu_torch.data.loader import get_calibration_batches
    from grasp_tpu_torch.data.tokenizer import load_tokenizer

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt_root = tempfile.mkdtemp(prefix="smoke_grasp_", dir=os.path.join(ROOT, "build"))
    par_root = tempfile.mkdtemp(prefix="smoke_parallel_", dir=os.path.join(ROOT, "build"))
    try:
        launches, _, summary = _compress_cli(torch, dev, ckpt_root, [], "compress", card)
        meta, config = _check_checkpoint(torch, ckpt_root, dev, "compress")
        evaluated = phase_evaluate(torch, card, dev, ckpt_root)
        if evaluate_only:
            return evaluated
        layers = meta["redundant_layers"]
        n_layers = config.num_hidden_layers
        n_rows = len(get_calibration_batches("synthetic", load_tokenizer(None), num_samples=16,
                                             seq_len=2048, seed=42))
        if summary["prefix"] != "cache":
            raise AssertionError(f"prefix auto resolved to {summary['prefix']}, not cache")
        rounds = [(li, attn) for li in sorted(layers, reverse=True) for attn in (False, True)]
        want = _want_flash(n_layers, n_rows, rounds, min(layers), "cache")
        print(f"compress: {n_rows} calibration rows of 2047 tokens, block influence, a prefix "
              f"forward to layer {min(layers)} once a row, {len(rounds)} sweeps from it")
        _hold_launches("compress", launches, want)

        par_launches, _, par_summary = _compress_cli(torch, dev, par_root,
                                                     ["--sweep", "parallel"],
                                                     "compress, parallel", card)
        _check_checkpoint(torch, par_root, dev, "compress, parallel", layers)
        if par_summary["prefix"] != "cache":
            raise AssertionError(f"parallel: prefix auto resolved to {par_summary['prefix']}")
        want = _want_flash(n_layers, n_rows, [(min(layers), True)], min(layers), "cache")
        _hold_launches("compress, parallel", par_launches, want)
        flash_launches = {k: launches[k] + par_launches[k] for k in launches}

        compress_flash_routes(torch, card, dev, layers)
        compress_run_options(torch, card, dev, layers)
        fused = compress_with_fused_lowrank(torch, card, dev, meta, n_rows)
        return flash_launches, fused, evaluated
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
        shutil.rmtree(par_root, ignore_errors=True)


def _smoke_model(dev):
    """The CLI runs' dense model, their calibration batches and GraspConfig
    fields (the engine's runs below use the layers the CLI chose)."""
    from grasp_tpu_torch.cli import load_model
    from grasp_tpu_torch.data.loader import get_calibration_batches

    config, params, _, tok = load_model("tinyllama-1.1b", device=dev, dtype="bfloat16", seed=42)
    batches = get_calibration_batches("synthetic", tok, num_samples=16, seq_len=2048, seed=42)
    return config, params, batches


def compress_flash_routes(torch, card, dev, layers):
    """One attention round on the uncompressed model, so that the backward
    kernels take part: the summed gradients of the flash route and of the
    plain route (GRASP_FLASH_SWEEP=0), both in bf16, against the plain route
    in fp32, and the indices each bf16 route selects."""
    import dataclasses

    from grasp_tpu_torch import GraspConfig
    from grasp_tpu_torch.core.engine import GraspEngine, module_name
    from grasp_tpu_torch.models.convert import map_params
    from grasp_tpu_torch.models.llama import ATTN_PROJS

    config, dense_params, batches = _smoke_model(dev)
    batches = batches[:2]
    names = [module_name(min(layers), proj) for proj in ATTN_PROJS]
    cfg = GraspConfig(compression_ratio=0.9)
    fp32 = (map_params(dense_params, lambda t: t.float()),
            dataclasses.replace(config, dtype="float32"))
    engines, grads = {}, {}
    for route, env, (p, c) in (("flash", "1", (dense_params, config)),
                               ("plain", "0", (dense_params, config)),
                               ("fp32", "0", fp32)):
        os.environ["GRASP_FLASH_SWEEP"] = env
        engines[route] = GraspEngine(p, c, device=dev)
        engines[route]._maybe_enable_flash_sweep(batches)
        grads[route] = engines[route].get_dense_gradients(names, batches)
    del os.environ["GRASP_FLASH_SWEEP"], fp32
    if [e.config.use_flash_attention for e in engines.values()] != [True, False, False]:
        raise AssertionError("GRASP_FLASH_SWEEP did not select the route")

    def worst_error(route, ref):
        return max(((grads[route][n].float() - grads[ref][n].float()).abs().max()
                    / grads[ref][n].float().abs().max()).item() for n in names)

    err = {route: worst_error(route, "fp32") for route in ("flash", "plain")}
    between = worst_error("flash", "plain")
    svd_out = engines["flash"]._svd_of_dense(names)
    overlap = {}
    for route in ("flash", "plain"):
        engines[route]._select_compile_many(names, dict(svd_out), grads[route], cfg)
    for n in names:
        kept = [set(engines[route].indices_dict[n].tolist()) for route in ("flash", "plain")]
        overlap[n.split(".")[-1]] = f"{len(kept[0] & kept[1])}/{len(kept[1])}"
    print(f"compress: layer {min(layers)} attention round over 2 rows, worst gradient error "
          f"over the reference gradient's max: flash route (bf16) against the plain route in "
          f"fp32 {err['flash']:.3e}, plain route (bf16) against it {err['plain']:.3e}, flash "
          f"against plain (both bf16) {between:.3e}; tolerance for the flash route: the "
          f"larger of {FLASH_SWEEP_RTOL:g} and {FLASH_SWEEP_SLACK:g} x the plain route's "
          f"error; selected indices in common {overlap}")
    if not err["flash"] <= max(FLASH_SWEEP_RTOL, FLASH_SWEEP_SLACK * err["plain"]):
        raise AssertionError("the flash route's gradients are further from the fp32 "
                             "reference than the plain route's")

    # remat: a sweep through every layer (layer 0's attention) with and
    # without recomputing each layer's activations in the backward
    names0 = [module_name(0, proj) for proj in ATTN_PROJS]
    remat_grads, peaks = {}, {}
    for remat in (False, True):
        engine = GraspEngine(dense_params, config, device=dev, remat=remat)
        engine._maybe_enable_flash_sweep(batches)
        # what an earlier sweep left in reference cycles must not be freed
        # inside the measured one
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        remat_grads[remat] = engine.get_dense_gradients(names0, batches)
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated(dev) - base
    rel = max(((remat_grads[True][n].float() - remat_grads[False][n].float()).abs().max()
               / remat_grads[False][n].float().abs().max()).item() for n in names0)
    same = all(torch.equal(remat_grads[True][n], remat_grads[False][n]) for n in names0)
    print(f"compress, remat: layer 0 attention sweep over 2 rows (backward through 22 layers, "
          f"flash route): peak memory above the model {peaks[False] / 2**30:.3f} GiB without "
          f"remat, {peaks[True] / 2**30:.3f} GiB with; gradients bit-equal {same}, worst "
          f"difference over the max {rel:.3e} (tol {FLASH_SWEEP_RTOL:g}); card {card}")
    if not rel <= FLASH_SWEEP_RTOL:
        raise AssertionError("remat changed the sweep's gradients")
    del engines, grads, dense_params, svd_out, remat_grads, engine
    torch.cuda.empty_cache()


def _factor_gap(torch, a_params, b_params, names):
    """The largest difference of two runs' compiled factors over the
    factor's max, 0.0 when every factor is torch.equal."""
    from grasp_tpu_torch.core.engine import parse_module_name

    worst = 0.0
    for name in names:
        li, group, proj = parse_module_name(name)
        for key in ("in_kernel", "out_kernel"):
            a = a_params["layers"][li][group][proj][key]
            b = b_params["layers"][li][group][proj][key]
            if not torch.equal(a, b):
                worst = max(worst, ((a.float() - b.float()).abs().max()
                                    / b.float().abs().max()).item())
    return worst


def compress_run_options(torch, card, dev, layers):
    """The engine's run options at full width on the layers the CLI chose:
    sequential runs under prefix off, recompute and cache; a run killed
    after its second round and resumed by a fresh engine; the parallel path
    under the device, gram and gram_device SVDs."""
    from grasp_tpu_torch import GraspConfig
    from grasp_tpu_torch.core.engine import GraspEngine
    from grasp_tpu_torch.models.convert import flatten_params

    config, params, batches = _smoke_model(dev)
    base = dict(layers_id=layers, compression_ratio=0.9)
    runs = {}
    for prefix in ("off", "recompute", "cache"):
        engine = GraspEngine(params, config, device=dev)
        summary = engine.run(batches, GraspConfig(prefix=prefix, **base))
        runs[prefix] = engine
        print(f"compress, prefix {prefix}: {summary['wall_clock_s']:.2f} s, stage seconds "
              f"{summary['stage_times_s']}, stage counts {engine.stage_counts}")
    ref = runs["off"]
    names = sorted(ref.rank_dict)
    for prefix in ("recompute", "cache"):
        got = runs[prefix]
        same_sets = all(set(got.indices_log[n].tolist()) == set(ref.indices_log[n].tolist())
                        for n in names)
        gap = _factor_gap(torch, got.params, ref.params, names)
        print(f"compress, prefix {prefix} against off: ranks equal {got.rank_dict == ref.rank_dict}"
              f", index sets equal {same_sets}, compiled factors "
              f"{'torch.equal' if gap == 0 else f'differ by {gap:.3e} of their max'}")
        if got.rank_dict != ref.rank_dict or not same_sets or gap > PREFIX_FACTOR_RTOL:
            raise AssertionError(f"prefix {prefix} changed the compression")

    # resume: raise from _mark_round_done after the second round, then a
    # fresh engine over the same directory; against the uninterrupted run
    resume_dir = tempfile.mkdtemp(prefix="smoke_resume_", dir=os.path.join(ROOT, "build"))
    try:
        cfg = GraspConfig(prefix="cache", **base)
        killed = GraspEngine(params, config, device=dev)
        mark, calls = killed._mark_round_done, []

        def crash_after_two(layer_id, block_type):
            mark(layer_id, block_type)
            calls.append((layer_id, block_type))
            if len(calls) == 2:
                raise RuntimeError("simulated crash")

        killed._mark_round_done = crash_after_two
        try:
            killed.run(batches, cfg, resume_dir=resume_dir)
            raise AssertionError("the killed run did not stop")
        except RuntimeError as e:
            if str(e) != "simulated crash":
                raise
        del killed
        resumed = GraspEngine(params, config, device=dev)
        summary = resumed.run(batches, cfg, resume_dir=resume_dir)
        flat_a, flat_b = flatten_params(resumed.params), flatten_params(runs["cache"].params)
        equal = flat_a.keys() == flat_b.keys() and all(
            torch.equal(flat_a[k], flat_b[k]) for k in flat_a)
        print(f"compress, resume: killed after rounds {calls}, resumed by a fresh engine "
              f"({resumed.stage_counts.get('grad_sweep')} sweeps left, snapshots "
              f"{summary['stage_times_s'].get('resume_snapshot')} s); params torch.equal to "
              f"the uninterrupted run's: {equal}")
        if not equal or resumed.plan != runs["cache"].plan or resumed.stage_counts["grad_sweep"] != 2:
            raise AssertionError("the resumed run differs from the uninterrupted one")
    finally:
        shutil.rmtree(resume_dir, ignore_errors=True)
    del runs, ref, resumed
    torch.cuda.empty_cache()

    # the gram SVDs on the parallel path against the device SVD
    par = {}
    for method in ("device", "gram", "gram_device"):
        engine = GraspEngine(params, config, device=dev, svd_method=method)
        summary = engine.run(batches, GraspConfig(sweep="parallel", **base))
        par[method] = engine
        print(f"compress, parallel, svd_method {method}: {summary['wall_clock_s']:.2f} s, stage "
              f"seconds {summary['stage_times_s']}")
    bad = []
    for method in ("gram", "gram_device"):
        got = par[method]
        want = par["device"].indices_log
        shares = {".".join(n.split(".")[2::2]): len(set(got.indices_log[n].tolist())
                                                    & set(want[n].tolist())) / len(want[n])
                  for n in names}
        print(f"compress, parallel, {method} against device: ranks equal "
              f"{got.rank_dict == par['device'].rank_dict}, share of selected indices in "
              f"common {shares} (at least {GRAM_AGREEMENT})")
        if got.rank_dict != par["device"].rank_dict or min(shares.values()) < GRAM_AGREEMENT:
            bad.append(method)
    if bad:
        raise AssertionError(f"svd_method {bad} select unlike the device SVD")
    del par, engine, params
    torch.cuda.empty_cache()


def compress_with_fused_lowrank(torch, card, dev, plain_meta, n_batches):
    """The same compression from a checkpoint of the same dense model whose
    config has ``use_pallas_lowrank``: every forward after a round has
    compiled projections runs the fused kernel once per compiled projection
    (calibration rows have 2047 tokens). Must choose the layers and ranks of
    the run without the flag. Then the parallel sweep from the same
    checkpoint, in chunks of one layer: the second chunk's sweep runs the
    first chunk's compiled projections. Returns the fused kernel's launches."""
    import dataclasses

    from grasp_tpu_torch import GraspConfig
    from grasp_tpu_torch.checkpoints import load_checkpoint, save_checkpoint
    from grasp_tpu_torch.cli import compress_main, load_model
    from grasp_tpu_torch.core.engine import GraspEngine
    from grasp_tpu_torch.data.loader import get_calibration_batches
    from grasp_tpu_torch.ops.lowrank import fused_lowrank

    src = tempfile.mkdtemp(prefix="smoke_dense_", dir=os.path.join(ROOT, "build"))
    dst = tempfile.mkdtemp(prefix="smoke_fused_", dir=os.path.join(ROOT, "build"))
    try:
        config, params, plan, _ = load_model("tinyllama-1.1b", device=dev, dtype="bfloat16",
                                             seed=42)
        save_checkpoint(src, params, dataclasses.replace(config, use_pallas_lowrank=True), plan)
        del params
        torch.cuda.empty_cache()
        args = list(COMPRESS_ARGS)
        args[args.index("--model_name_or_path") + 1] = src
        fused_lowrank.launches = 0
        t0 = time.perf_counter()
        rc = compress_main(args + ["--save_path", dst, "--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fused_lowrank.launches
        if rc != 0:
            raise AssertionError(f"compress_main returned {rc}")
        _, got_config, _, meta = load_checkpoint(dst, "cpu")
        # rounds run per layer, highest first, the MLP block (3 projections)
        # then the attention block (4); a round's sweep sees what earlier rounds compiled
        compiled, want = 0, 0
        for _ in meta["redundant_layers"]:
            for block in (3, 4):
                want += n_batches * compiled
                compiled += block
        stages = meta["extra"]["summary"]["stage_times_s"]
        print(f"compress, use_pallas_lowrank: layers {meta['redundant_layers']}, "
              f"{len(meta['rank_dict'])} ranks, fused low-rank launches {launches} (want "
              f"{n_batches} rows x (0 + 3 + 7 + 10 ...) = {want}); {wall:.1f} s end to end, stage "
              f"seconds {stages}; card {card}")
        if (meta["redundant_layers"] != plain_meta["redundant_layers"]
                or meta["rank_dict"] != plain_meta["rank_dict"]):
            raise AssertionError("the fused kernel changed the chosen layers or ranks")
        if not got_config.use_pallas_lowrank or launches == 0 or launches != want:
            raise AssertionError("the sweeps did not run the fused low-rank kernel as counted")

        layers = meta["redundant_layers"]
        fused_config, params, _, tok = load_model(src, device=dev)
        batches = get_calibration_batches("synthetic", tok, num_samples=16, seq_len=2048,
                                          seed=42)
        engine = GraspEngine(params, fused_config, device=dev)
        fused_lowrank.launches = 0
        summary = engine.run(batches, GraspConfig(layers_id=layers, compression_ratio=0.9,
                                                  sweep="parallel", sweep_chunk_layers=1))
        torch.cuda.synchronize()
        par_launches = fused_lowrank.launches
        # chunks [[hi], [lo]]: the second sweep runs the first's 7 compiled projections
        par_want = n_batches * 7 * (len(layers) - 1)
        print(f"compress, use_pallas_lowrank, parallel in chunks of one layer: fused low-rank "
              f"launches {par_launches} (want {n_batches} rows x 7 = {par_want}); "
              f"{summary['wall_clock_s']:.2f} s, stage seconds {summary['stage_times_s']}")
        if engine.rank_dict != plain_meta["rank_dict"] or par_launches != par_want:
            raise AssertionError("the parallel sweep did not run the fused low-rank kernel "
                                 "as counted")
        del engine, params
        torch.cuda.empty_cache()
        return launches + par_launches
    finally:
        shutil.rmtree(src, ignore_errors=True)
        shutil.rmtree(dst, ignore_errors=True)


# the evaluation slice: the compressed TinyLlama-1.1B that phase_compress
# saved, at full width and depth, bf16
EVAL_WINDOWS = 8  # the synthetic corpus: 16,384 tokens in windows of 2048
# a window's mean cross entropy (nats) under the flash (and fused) route
# against the plain route, both in bf16: the routes differ in summation order
# and where they round to bf16. Their logits on one window are held to an
# fp32 forward of the same weights by the compression smoke's bf16 gate
# (FLASH_SWEEP_RTOL, FLASH_SWEEP_SLACK x the plain bf16 route's error)
EVAL_CE_TOL = 1e-2
# a request's summed log-likelihood, flash against plain, relative
EVAL_LL_RTOL = 1e-2
EVAL_TASKS = ("boolq", "piqa", "hellaswag", "winogrande", "arc_easy")
EVAL_DOCS = 24  # documents a task
GEN_PROMPT_LENS = (300, 400, 500, 600, 700, 800, 900, 1000)
GEN_TOKENS = 64


def _eval_counts(reset=False):
    """The flash forward's and the fused low-rank kernel's launch counts;
    ``reset`` sets them to 0 first."""
    from grasp_tpu_torch.ops.flash_attention import flash_attention
    from grasp_tpu_torch.ops.lowrank import fused_lowrank

    if reset:
        for name in flash_attention.launches:
            flash_attention.launches[name] = 0
        fused_lowrank.launches = 0
    return {"fwd": flash_attention.launches["fwd"], "dkv": flash_attention.launches["dkv"],
            "dq": flash_attention.launches["dq"], "fused": fused_lowrank.launches}


def _hold_eval_counts(label, got, fwd, fused):
    print(f"{label}: flash forward launches {got['fwd']} (want {fwd}), fused low-rank "
          f"{got['fused']} (want {fused}), flash backward {got['dkv']} + {got['dq']} (want 0)")
    if got != {"fwd": fwd, "dkv": 0, "dq": 0, "fused": fused}:
        raise AssertionError(f"{label}: the kernels did not run as the dispatch rules count")


def _eval_docs(seed, n):
    """Seed-made documents of the five tasks, shaped like their datasets."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = ("water stone light river cloud salt iron tree glass paper metal wind fire earth "
             "sound wave heat cold north south green blue small large").split()

    def text(k):
        return " ".join(rng.choice(words, k))

    return {
        "boolq": [{"passage": text(40), "question": text(6), "answer": bool(i % 2)}
                  for i in range(n)],
        "piqa": [{"goal": text(8), "sol1": text(12), "sol2": text(12), "label": i % 2}
                 for i in range(n)],
        "hellaswag": [{"activity_label": text(2), "ctx_a": text(15), "ctx_b": text(5),
                       "endings": [text(10) for _ in range(4)], "label": i % 4}
                      for i in range(n)],
        "winogrande": [{"sentence": f"The {text(3)} broke because _ was {text(4)}.",
                        "option1": text(2), "option2": text(2), "answer": str(1 + i % 2)}
                       for i in range(n)],
        "arc_easy": [{"question": text(12), "choices": {"text": [text(3) for _ in range(4)],
                                                        "label": list("ABCD")},
                      "answerKey": "ABCD"[i % 4]} for i in range(n)],
    }


def phase_evaluate(torch, card, dev, ckpt_root):
    """The evaluation slice on the compressed checkpoint: perplexity through
    ``grasp-evaluate-torch`` (plain config, then with ``use_flash_attention``
    and ``use_pallas_lowrank``), the same corpus three ways through
    ``windowed_perplexity``, the zero/few-shot harness with and without the
    flash route, and generation through ``greedy_until`` and LongBench's
    ``get_pred``. Returns the flash forward's and the fused kernel's
    launches, each counted from 0 around its run."""
    import dataclasses

    from grasp_tpu_torch.checkpoints import META_NAME, load_checkpoint
    from grasp_tpu_torch.cli import evaluate_main
    from grasp_tpu_torch.data.loader import get_evaluation_corpus
    from grasp_tpu_torch.data.tokenizer import load_tokenizer
    from grasp_tpu_torch.eval.ppl import windowed_mean_ce, windowed_perplexity
    from grasp_tpu_torch.models.convert import map_params
    from grasp_tpu_torch.models.llama import forward

    params, config, plan, _ = load_checkpoint(ckpt_root, dev)
    n_layers = config.num_hidden_layers
    n_lowrank = sum(kind == "lowrank" for layer in plan for kind in layer)
    if config.use_flash_attention or config.use_pallas_lowrank or n_lowrank == 0:
        raise AssertionError(f"evaluate: the checkpoint's config {config} is not the plain one")
    configs = {"plain": config,
               "flash": dataclasses.replace(config, use_flash_attention=True),
               "flash+fused": dataclasses.replace(config, use_flash_attention=True,
                                                  use_pallas_lowrank=True)}
    launches = {"fwd": 0, "fused": 0}

    def add(got):
        launches["fwd"] += got["fwd"]
        launches["fused"] += got["fused"]

    # perplexity through the CLI: the checkpoint as saved, then with both flags
    results = {}
    meta_path = os.path.join(ckpt_root, META_NAME)
    with open(meta_path) as f:
        meta_text = f.read()
    try:
        for label in ("plain", "flash+fused"):
            if label != "plain":
                meta = json.loads(meta_text)
                meta["model_config"].update(use_flash_attention=True, use_pallas_lowrank=True)
                with open(meta_path, "w") as f:
                    json.dump(meta, f)
            out = os.path.join(ckpt_root, f"eval_{label}.json")
            _eval_counts(reset=True)
            t0 = time.perf_counter()
            rc = evaluate_main(["--model_path", ckpt_root, "--eval_ppl", "synthetic",
                                "--results_json", out, "--device", str(dev)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = _eval_counts()
            with open(out) as f:
                results[label] = json.load(f)
            print(f"evaluate: grasp-evaluate-torch --eval_ppl synthetic ({label} config): "
                  f"{results[label]}, {wall:.1f} s with loading; card {card}")
            if rc != 0 or set(results[label]) != {"synthetic"} or not math.isfinite(
                    results[label]["synthetic"]):
                raise AssertionError(f"evaluate: the CLI gave {rc}, {results[label]}")
            flagged = label != "plain"
            _hold_eval_counts(f"evaluate, CLI {label}", got, n_layers * EVAL_WINDOWS * flagged,
                              n_lowrank * EVAL_WINDOWS * flagged)
            add(got)
    finally:
        with open(meta_path, "w") as f:
            f.write(meta_text)

    # the same corpus three ways: each window's mean CE against the plain run's
    corpus = get_evaluation_corpus("synthetic", load_tokenizer(None))
    ces, ppls, ms = {}, {}, {}
    for label, cfg in configs.items():
        ces[label] = windowed_mean_ce(params, cfg, corpus, plan=plan)
        _eval_counts(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ppls[label] = windowed_perplexity(params, cfg, corpus, plan=plan)
        torch.cuda.synchronize()
        ms[label] = (time.perf_counter() - t0) * 1e3 / EVAL_WINDOWS
        got = _eval_counts()
        _hold_eval_counts(f"evaluate, windowed_perplexity {label}", got,
                          0 if label == "plain" else n_layers * EVAL_WINDOWS,
                          n_lowrank * EVAL_WINDOWS if label == "flash+fused" else 0)
        add(got)
        if len(ces[label]) != EVAL_WINDOWS or not all(map(math.isfinite, ces[label])):
            raise AssertionError(f"evaluate: {label}: window CEs {ces[label]}")
    gaps = {label: float(max(abs(a - b) for a, b in zip(ces[label], ces["plain"])))
            for label in configs}
    cli_gap = abs(results["flash+fused"]["synthetic"] / results["plain"]["synthetic"] - 1)
    with torch.no_grad():
        window = torch.as_tensor(corpus[:2048], device=dev)[None]
        ref = forward(map_params(params, lambda t: t.float()), window,
                      config=dataclasses.replace(config, dtype="float32"),
                      plan=plan)["logits"]
        logit_err = {}
        for label, cfg in configs.items():
            logits = forward(params, window, config=cfg, plan=plan)["logits"].float()
            logit_err[label] = ((logits - ref).abs().max() / ref.abs().max()).item()
        del ref, logits
    logit_tol = max(FLASH_SWEEP_RTOL, FLASH_SWEEP_SLACK * logit_err["plain"])
    print(f"evaluate: synthetic PPL plain {ppls['plain']:.4f}, flash {ppls['flash']:.4f}, "
          f"flash+fused {ppls['flash+fused']:.4f}; window mean CE max |diff| against plain "
          f"flash {gaps['flash']:.2e}, flash+fused {gaps['flash+fused']:.2e} (tol "
          f"{EVAL_CE_TOL}); CLI PPL flagged against plain {cli_gap:.2e}; window 0's logits "
          f"max |diff| from an fp32 forward over its max: plain {logit_err['plain']:.2e}, "
          f"flash {logit_err['flash']:.2e}, flash+fused {logit_err['flash+fused']:.2e} (tol "
          f"for the kernel routes {logit_tol:.2e})")
    print(f"evaluate: PPL ms a window of 2048 tokens (B=1): plain {ms['plain']:.3f}, flash "
          f"{ms['flash']:.3f}, flash+fused {ms['flash+fused']:.3f}; card {card}")
    if (max(gaps.values()) > EVAL_CE_TOL or cli_gap > EVAL_CE_TOL
            or max(logit_err["flash"], logit_err["flash+fused"]) > logit_tol):
        raise AssertionError("evaluate: a kernel route's perplexity left the plain route's")

    add(_evaluate_harness(torch, card, params, configs, plan, n_layers, n_lowrank))
    add(_evaluate_generation(torch, card, dev, params, configs, plan, n_lowrank))
    del params
    torch.cuda.empty_cache()
    print(f"evaluate: flash forward launches {launches['fwd']}, fused low-rank "
          f"{launches['fused']} in the evaluation slice")
    return launches


def _evaluate_harness(torch, card, params, configs, plan, n_layers, n_lowrank):
    """evaluate_tasks over seed-made documents of five tasks, zero-shot and
    one-shot, with the flash and fused kernels and without: loglikelihood
    sums within EVAL_LL_RTOL, the flash forward once a layer a scoring batch,
    the fused kernel once a low-rank projection a batch of 256 rows or more."""
    from grasp_tpu_torch.data.tokenizer import load_tokenizer
    from grasp_tpu_torch.eval import harness

    docs = _eval_docs(0, EVAL_DOCS)
    docs.update({f"{t}:train": d for t, d in _eval_docs(1, EVAL_DOCS).items()})
    recorded = {}
    forward = harness.forward
    try:
        for label in ("flash+fused", "plain"):
            batches = []

            def counting_forward(params_, ids, **kw):
                batches.append(tuple(ids.shape))
                return forward(params_, ids, **kw)

            harness.forward = counting_forward
            lm = harness.EvalLM(params, configs[label], load_tokenizer(None), plan=plan)
            scored = []
            score = lm.loglikelihood

            def recording(requests, score=score, scored=scored):
                out = score(requests)
                scored.extend(out)
                return out

            lm.loglikelihood = recording
            _eval_counts(reset=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = [harness.evaluate_tasks(lm, list(EVAL_TASKS), docs_override=docs,
                                          num_fewshot=shots) for shots in (0, 1)]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = _eval_counts()
            flagged = label != "plain"
            big = sum(b * s >= 256 for b, s in batches)
            print(f"evaluate: harness ({label}): {len(scored)} loglikelihood requests in "
                  f"{len(batches)} batches of <= 8 rows, {wall:.3f} s = "
                  f"{len(scored) / wall:.1f} requests a second; zero-shot "
                  f"{ {t: round(v['acc'], 4) for t, v in res[0].items() if t != 'mean'} }, "
                  f"one-shot mean {res[1]['mean']:.4f}; card {card}")
            _hold_eval_counts(f"evaluate, harness {label}", got,
                              n_layers * len(batches) * flagged, n_lowrank * big * flagged)
            if len(scored) == 0 or not all(math.isfinite(ll) for ll, _ in scored):
                raise AssertionError(f"evaluate: harness {label}: no finite scores")
            recorded[label] = (scored, got)
    finally:
        harness.forward = forward
    flagged, plain = recorded["flash+fused"][0], recorded["plain"][0]
    worst = max(abs(a - b) / abs(b) for (a, _), (b, _) in zip(flagged, plain))
    agree = sum(ga == gb for (_, ga), (_, gb) in zip(flagged, plain)) / len(plain)
    print(f"evaluate: harness loglikelihood sums flash+fused against plain: max relative "
          f"difference {worst:.2e} (tol {EVAL_LL_RTOL}) over {len(plain)} requests; is_greedy "
          f"agrees on {agree:.4f} of them")
    if len(flagged) != len(plain) or worst > EVAL_LL_RTOL:
        raise AssertionError("evaluate: the harness's scores left the plain route's")
    return recorded["flash+fused"][1]


def _evaluate_generation(torch, card, dev, params, configs, plan, n_lowrank):
    """greedy_until (64 new tokens a request) and LongBench's get_pred over
    eight prompts of 300 to 1000 tokens, on the dense KV cache: every token
    within GAP_TOL of a teacher-forced plain forward's largest logit, the
    fused kernel once a low-rank projection a prefill and no flash launch."""
    import numpy as np

    from grasp_tpu_torch.data.tokenizer import load_tokenizer
    from grasp_tpu_torch.eval import harness
    from grasp_tpu_torch.eval.generate import Generator
    from grasp_tpu_torch.eval.longbench import (
        DATASET2MAXLEN, DATASET2PROMPT, eval_longbench, get_pred)

    cfg, tok = configs["flash+fused"], load_tokenizer(None)

    class Recording(Generator):
        """Keeps every (prompt, new tokens) pair and counts prefills."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.served, self.prefills = [], 0

        def greedy(self, prompt_ids, max_new_tokens, **kw):
            out = super().greedy(prompt_ids, max_new_tokens, **kw)
            self.served.append((np.asarray(prompt_ids).reshape(-1).tolist(), out))
            self.prefills += 1
            return out

        def greedy_batch(self, prompts, max_new_tokens, **kw):
            outs = super().greedy_batch(prompts, max_new_tokens, **kw)
            self.served += [(np.asarray(p).reshape(-1).tolist(), o) for p, o in zip(prompts, outs)]
            self.prefills += 1
            return outs

    class SmokeLM(harness.EvalLM):
        max_gen_toks = GEN_TOKENS  # 256 in use

    rng = np.random.default_rng(3)
    contexts = ["".join(chr(c) for c in rng.integers(97, 123, n)) for n in GEN_PROMPT_LENS]
    samples = [{"context": c, "answers": [c[-20:]], "all_classes": None, "length": len(c)}
               for c in contexts]
    gen = Recording(params, cfg, plan)
    lm = SmokeLM(params, cfg, tok, plan=plan)
    lm._generator = gen
    if DATASET2MAXLEN["lcc"] != GEN_TOKENS:
        raise AssertionError("lcc no longer generates 64 tokens")
    _eval_counts(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    texts = lm.greedy_until([(c, []) for c in contexts])
    torch.cuda.synchronize()
    until_s = time.perf_counter() - t0
    n_until = sum(len(o) for _, o in gen.served)
    rsts = get_pred(gen, tok, samples, 1024, GEN_TOKENS, DATASET2PROMPT["lcc"], "lcc",
                    "tinyllama-1.1b")
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as out_dir:
        scores = eval_longbench(params, cfg, tok, "tinyllama-1.1b", ["lcc"], plan=plan,
                                max_length=1024, output_dir=out_dir,
                                samples_override={"lcc": samples})
    torch.cuda.synchronize()
    got = _eval_counts()
    prefills = gen.prefills + 1  # eval_longbench's own generator: one batch of 8
    print(f"evaluate: greedy_until over {len(contexts)} prompts of {GEN_PROMPT_LENS[0]} to "
          f"{GEN_PROMPT_LENS[-1]} tokens: {n_until} new tokens in {until_s:.3f} s = "
          f"{n_until / until_s:.1f} tokens a second (one batch of 8); LongBench lcc score "
          f"{scores['lcc']} over {len(rsts)} predictions; card {card}")
    _hold_eval_counts("evaluate, generation", got, 0, n_lowrank * prefills)
    if len(texts) != len(contexts) or len(rsts) != len(samples) or len(gen.served) != 16:
        raise AssertionError("evaluate: generation lost a request")

    batch_served = list(gen.served)
    singles, agree, total = [], 0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for prompt, out in batch_served[:len(contexts)]:
        single = gen.greedy(prompt, GEN_TOKENS, eos_token_id=tok.eos_token_id)
        singles.append(single)
        agree += sum(a == b for a, b in zip(single, out))
        total += max(len(single), len(out))
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    gap, match, n_tok = check_against_plain(
        torch, params, configs["plain"], plan, [(p, o) for p, o in gen.served if o], dev)
    print(f"evaluate: greedy one prompt at a time {sum(map(len, singles))} tokens in "
          f"{single_s:.3f} s = {sum(map(len, singles)) / single_s:.1f} tokens a second; "
          f"greedy_batch and greedy agree on {agree}/{total} tokens; generated vs plain "
          f"teacher-forced forward: argmax agrees at {match}/{n_tok} positions, max logit gap "
          f"{gap:.4f} (tol {GAP_TOL}); card {card}")
    if n_tok == 0 or gap > GAP_TOL:
        raise AssertionError("evaluate: generated tokens disagree with the plain forward")
    return got


def drive_quantizer(torch, dev):
    """The stochastic quantizer as its users call it: every projection
    kernel of a model layer and the lm_head (TinyLlama-1.1B's shapes, bf16)
    quantized on the card for a copy that will be fine-tuned, and the
    quantized kernels used: q and scales must equal the plain version's bit
    for bit, q scale stay within one scale of w and the int8 product within
    2% of the dense one. No entry point of either package calls it (in the
    JAX package only its test does), so this is its main path. Returns its
    launches."""
    from grasp_tpu_torch.ops.quant import (
        quant_matmul, quantize_int8_stochastic, quantize_int8_stochastic_plain)

    gen = torch.Generator(device=dev).manual_seed(9)
    quantize_int8_stochastic.launches = 0
    worst = 0.0
    for i, (in_f, out_f) in enumerate(QUANT_DRIVEN):
        w = (torch.randn(in_f, out_f, generator=gen, device=dev) * 0.02).bfloat16()
        q, scale = quantize_int8_stochastic(w, seed=i)
        plain_q, plain_scale = quantize_int8_stochastic_plain(w, seed=i)
        x = torch.randn(8, in_f, generator=gen, device=dev).bfloat16()
        got, want = quant_matmul(x, q, scale).float(), torch.matmul(x, w).float()
        rel = ((got - want).abs().max() / want.abs().max()).item()
        inside = bool(((q.float() * scale - w.float()).abs() <= scale * (1 + 1e-5)).all().item())
        bits = torch.equal(q, plain_q) and torch.equal(scale, plain_scale)
        if not (bits and inside and rel <= 0.02 and torch.isfinite(got).all().item()):
            raise AssertionError(f"stochastic quantizer on {in_f}x{out_f}: bit-equal to the plain "
                                 f"version {bits}, product off by {rel}")
        worst = max(worst, rel)
    launches = quantize_int8_stochastic.launches
    print(f"quantizer driven over {len(QUANT_DRIVEN)} projection kernels: {launches} launches, q "
          f"and scales bit-equal to the plain version, int8 product within {worst:.4f} of the "
          f"dense product's max (tol 0.02)")
    if launches != len(QUANT_DRIVEN):
        raise AssertionError("the quantizer did not launch once per kernel")
    return launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", choices=["flash", "kernels", "serve", "spec", "compress",
                                           "evaluate"], default=None,
                        help="development aid: run one part and print no result lines")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script "
                         "needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    import grasp_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase_build()
    if args.only == "flash":
        print(phase_flash(torch))
        print(phase_flash_timing(torch))
        return 0
    if args.only == "kernels":
        print(phase_lowrank(torch), phase_int4(torch), phase_quantizer(torch))
        print(phase_lowrank_timing(torch), phase_int4_timing(torch), phase_quantizer_timing(torch))
        return 0
    dev = torch.device("cuda", 0)
    if args.only == "compress":
        print(phase_compress(torch, card, dev))
        return 0
    if args.only == "evaluate":
        print(phase_compress(torch, card, dev, evaluate_only=True))
        return 0
    paged_err = phase_kernel(torch)
    paged = phase_kernel_timing(torch, 22)
    chunk_err = phase_chunk(torch)
    chunk = phase_chunk_timing(torch, 22)
    if args.only == "spec":
        print(chunk, phase_slice(torch, card, dev, spec_only=True))
        return 0
    if args.only == "serve":
        print(phase_slice(torch, card, dev))
        print(drive_quantizer(torch, dev))
        return 0
    flash_err = phase_flash(torch)
    flash = phase_flash_timing(torch)
    lowrank_err, int4_err, quant_err = phase_lowrank(torch), phase_int4(torch), phase_quantizer(torch)
    lowrank, int4, quant = (phase_lowrank_timing(torch), phase_int4_timing(torch),
                            phase_quantizer_timing(torch))
    paged_launches, spec_launches, served = phase_slice(torch, card, dev)
    flash_launches, fused_compress_launches, evaluated = phase_compress(torch, card, dev)
    quant_launches = drive_quantizer(torch, dev)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "grasp_tpu"))
    if bad:
        raise AssertionError(f"the port imported {bad}")
    flash_src = "grasp_tpu_torch/csrc/flash_attention.cu"
    int4_src = "grasp_tpu_torch/csrc/int4_matmul.cu"
    record = {"kernels": [
        {"name": "paged_attention_decode", "route": "cuda",
         "source": "grasp_tpu_torch/csrc/paged_attention.cu",
         "replaces": "grasp_tpu/ops/pallas_paged64.py:122",
         "launches": paged_launches, "max_abs_err": paged_err, **paged},
        # library_ms: no single PyTorch call reads a page table; the timing line
        # above has one decode launch per chunk position beside it
        {"name": "paged_attention_chunk", "route": "cuda",
         "source": "grasp_tpu_torch/csrc/paged_attention.cu",
         "replaces": "grasp_tpu/ops/pallas_paged64.py:251",
         "launches": spec_launches["chunk"], "max_abs_err": chunk_err, **chunk},
        # the bf16 forward's body (the fp32 inputs of phase_flash take flash_fwd_kernel)
        # launches: the two compressions plus the evaluation slice
        {"name": "flash_fwd_mma_kernel", "route": "cuda", "source": flash_src,
         "replaces": "grasp_tpu/ops/pallas_attention.py:138",
         "launches": flash_launches["fwd"] + evaluated["fwd"], "max_abs_err": flash_err["fwd"],
         **flash["fwd"]},
        # the bf16 backward's bodies: a launch is flash_dkv_mma_kernel and its
        # group sum flash_dkv_reduce_kernel; library_ms is the whole SDPA backward
        {"name": "flash_dkv_mma_kernel", "route": "cuda", "source": flash_src,
         "replaces": "grasp_tpu/ops/pallas_attention.py:305",
         "launches": flash_launches["dkv"], "max_abs_err": flash_err["dkv"], **flash["dkv"]},
        {"name": "flash_dq_mma_kernel", "route": "cuda", "source": flash_src,
         "replaces": "grasp_tpu/ops/pallas_attention.py:344",
         "launches": flash_launches["dq"], "max_abs_err": flash_err["dq"], **flash["dq"]},
        # launches: prefill of the fused serving variant, the flagged compression
        # and the evaluation slice; the bf16 body (the fp32 inputs of
        # phase_lowrank take lowrank_fused_kernel)
        {"name": "lowrank_fused_mma_kernel", "route": "cuda",
         "source": "grasp_tpu_torch/csrc/lowrank_fused.cu",
         "replaces": "grasp_tpu/ops/pallas_lowrank.py:65",
         "launches": served["fused"]["fused"] + fused_compress_launches + evaluated["fused"],
         "max_abs_err": lowrank_err, **lowrank},
        {"name": "int4_matmul_grid", "route": "cuda", "source": int4_src,
         "replaces": "grasp_tpu/ops/pallas_int4.py:198",
         "launches": served["int4"]["grid"], "max_abs_err": int4_err["grid"], **int4["grid"]},
        {"name": "int4_matmul_dma", "route": "cuda", "source": int4_src,
         "replaces": "grasp_tpu/ops/pallas_int4.py:139",
         "launches": served["int4"]["dma"], "max_abs_err": int4_err["dma"], **int4["dma"]},
        {"name": "quantize_int8_stochastic", "route": "cuda",
         "source": "grasp_tpu_torch/csrc/quantize_int8.cu",
         "replaces": "grasp_tpu/ops/quant.py:311",
         "launches": quant_launches, "max_abs_err": quant_err, **quant},
    ]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
