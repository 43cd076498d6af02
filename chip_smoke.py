#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (grasp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. device: requires CUDA; prints the card's name and power limit.
2. build: compiles grasp_tpu_torch/csrc/*.cu with nvcc (sm_90a) into build/.
3. paged kernel: the paged-attention decode kernel against its plain PyTorch
   version on the same inputs, at TinyLlama's decode shape, at head_dim 128
   and at Phi-3's heads (32 MHA heads of 96), Gemma-7B's (16 MHA heads of
   256) and Gemma-2B's (8 over 1 of 256), then at groups of 1 to 16 at
   head_dim 64, 96, 128 and 256 with lengths on both sides of every edge of
   the launch plan's ranges; over int8 pages (the engine's quantizer; the
   plain version dequantizes) at Mistral-7B's and Gemma-7B's heads and the
   groups at head_dim 128 and 256 (the layouts of jax's TPU paged-attention
   kernel, K7); in float32 and bfloat16, within stated tolerances and
   torch.equal to itself run to run; then both timed with CUDA events at
   TinyLlama's, Phi-3's and Mixtral-8x7B's decode shapes (head_dim 64, 96
   and 128), Gemma-7B's and Gemma-2B's (256) and over int8 pages at
   Mistral-7B's and Gemma-7B's. Then the chunk kernel of
   speculative verification against its plain version and, row by row with
   torch.equal, against the decode kernel at each row's own length (head_dim
   64, 96, 128 and 256, int8 pages at 128 and 256, float32 and bfloat16,
   groups of 1 to 16, chunks of 1, 2, 5
   and 9, pages of 16 and 128 slots, lengths across tile, page and range
   edges, a dead row, the verify step's shape at TinyLlama's, Phi-3's,
   Gemma-7B's, Gemma-2B's and, over int8 pages, Mistral-7B's and Gemma-7B's
   heads, and chunks of 9 with a range live for the later positions only at
   head_dim 256 and over int8 pages, whose C x gqa query rows take one to
   nine groups of 16 in the bf16 kernel); and timed at the same shapes as
   the decode kernel against its plain version and against one decode
   launch per chunk position.
4. flash kernels: the flash-attention forward, dK/dV and dQ kernels against
   the plain version (output and the gradients of sum(o ** 2)) at ten
   shapes (head_dim 64, 96, 128 and 256, the last in groups of 8 and 1) in
   float32 and bfloat16, dQ, dK and dV
   bit-equal over two runs; then each kernel, the plain version and
   scaled_dot_product_attention (a yardstick the port never calls) timed at
   TinyLlama's calibration shape, at Phi-3's (head_dim 96) and at
   Mixtral-8x7B's (32 over 8 heads of 128), and the whole backward (di,
   dK/dV, dQ) against one SDPA backward.
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
   kernel launched (int8 pages at head_dim 64 take the gather route, as in
   JAX).
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
11. recovery slice (run inside 9, after 10, on the same checkpoint):
   ``grasp-compress-torch --recovery`` on 200 seed-made Alpaca rows at
   ``--max_length 512`` (40 validation rows, 10 optimizer steps of 4
   micro-batches of 4): its trainer checkpoints pruned to 2, the recovered
   checkpoint (frozen leaves torch.equal to the compressed ones, every
   trainable leaf moved, a finite perplexity); then ``recovery_train`` with
   the fused low-rank kernel (and the flash switch, which the masked batches
   keep off) against plain products, the first loss within TOL, timed in
   turns (ms per optimizer step, trained tokens a second, peak memory),
   under remat, killed after its first save and resumed from disk (losses
   within 1e-5), and in fp32 at TinyLlama's width with 4 layers against the
   same run on the CPU (losses within 1e-4). Every launch count is held: 14
   fused launches a forward of 256 rows or more (a micro-batch, an
   evaluation batch, and again a micro-batch under remat), no flash launch.
12. HF route (run inside 9, after 11): the compression cell's weights written
   as an HF directory (config.json, two bf16 safetensors files) and
   compressed by ``grasp-compress-torch`` from there with ``--export_hf_dir``:
   layers, ranks, plan, launches and saved params equal to the preset route's
   sequential run; the fp32 export read back torch.equal to the merged
   params; ``grasp-serve-torch`` on the export (K3 once per layer per decode
   step, tokens against a teacher-forced plain forward).
13. Phi-3-mini-4k at full width (hidden 3072, 32 heads of 96; 4 of its 32
   layers in the whole run, all 32 under ``--only phi3serve`` and ``--only
   hf``; random weights from a seed) through an HF directory with fused
   qkv_proj / gate_up_proj: the import torch.equal to the unfused weights,
   ``grasp-compress-torch`` with 16 rows of 2047 tokens through K1f, K1k and
   K1q at head_dim 96 (launches, ranks, one round's gradients by route), the
   merged bf16 export re-imported, and ``windowed_perplexity`` of it over 8
   windows with the flash route against plain. Before the export, the
   compressed checkpoint is served by ``grasp-serve-torch`` as in 5 (K3 at
   head_dim 96, a launch a layer a decode step) and with ``--speculative int8
   --gamma 4`` as in 8 (K4, a launch a layer a macro-step); after it, the export
   is served with ``--chat_template phi3`` and the byte-level tokenizer: chat
   completions unstreamed and streamed, n = 2, logprobs, a stop string and
   /metrics.
14. the rest of the serving engine (run inside 5's slice, on its checkpoint,
   between 7's int8 and fused variants): (a) ``--prefix_cache``, one system
   prefix of 1024 tokens and four suffixes of 100 to 300 tokens in turn
   (/metrics' grasp_prefix_tokens_saved 3 x 1024, TTFT cold and on a hit,
   tokens against a teacher-forced plain forward and against an engine
   without the cache); (c) over the same server ``logit_bias``,
   ``repetition_penalty``, ``min_p`` = 1 against greedy (ties by logprob),
   and penalized greedy requests against the penalties recomputed on a
   teacher-forced forward; (d) ``guided_regex`` and ``response_format``
   (json_object, json_schema) with the byte-level tokenizer, each output a
   fullmatch or, cut by max_tokens, a prefix of one; (e) ``--speculative int8
   --gamma 4 --prefix_cache`` with penalized greedy requests, then guided
   speculation with two grammars in one batch through the engine API; and,
   after 7's fused variant, (b) ``--prefill_chunk 256`` on the checkpoint with
   ``use_pallas_lowrank``: four short rows decoding while a 1500-token prompt
   admits in 6 chunks (5 decode steps or more between its first chunk and its
   first token, the short rows' inter-token latency against whole-prompt
   admission). K3 = 22 x decode steps, K4 = 22 x macro-steps and K2 = 14 x
   prefill forwards of 256 rows or more throughout.

15. Mixtral-8x7B at full width (hidden 4096, 8 SwiGLU experts of 14336 with
   top-2 routing, 32 query heads over 8 KV heads of 128, vocab 32000; depth
   cut to 2 of 32 layers, 3.16 B parameters, 6.3 GB in bf16; random weights
   from a seed) through an HF directory (``model_type: mixtral``, a tensor
   per expert): the import torch.equal, ``grasp-compress-torch`` with one
   layer and default targets (the stacked experts' round and the attention
   round) over 8 rows of 2047 tokens through K1f, K1k and K1q at head_dim 128
   (launches, ranks per expert part, the MoE round's gradients by route
   against fp32, stage seconds and peak memory); the compressed checkpoint
   served as in 5 (K3, 4 launches a decode step); then its merged bf16
   export, re-imported torch.equal, served with ``--speculative int8 --gamma
   4`` (K4, 4 launches a macro-step), ``--quantize int8`` and ``--quantize
   int4`` (K5, then K5d). Low-rank experts have no quantized form in either
   package, so the draft and the quantized variants take the merged export.
16. The families of P9 at full width, random weights from a seed written as
   an HF directory of each ``model_type``, imported torch.equal and
   compressed by ``grasp-compress-torch`` with TinyLlama's flags, K1's
   launches held to the flash rule (``models.llama.flash_layer_ok``); every
   served route printed and held (``serving.paged.paged_route``): (a)
   Gemma-2B (18 layers, 8 query heads over 1 KV head of 256, vocab 256000,
   tied head) through K1f, K1k and K1q at head_dim 256, the gradients by
   route against fp32, served plain and with ``--quantize int4`` through K3
   at head_dim 256 (18 launches a decode step), its merged export re-imported
   and its perplexity flash against plain; (b) Mistral-7B (window 4096; 4 of
   its 32 layers in the whole run, all 32 under ``--only families``) served
   over a table its window covers (K3, K4 under ``--speculative int8``; K3's
   and K4's int8 bodies under ``--quantized_kv``, alone and speculating), the
   same requests and one prompt of 6000 tokens over 8192 slots (the gather
   route, live pages at most ceil(4096 / 128) + 2), in bf16 and its export
   in fp32 (K3's fp32 body; the gather route); bf16 tokens beyond the
   logit gap rule held to the same forward in fp32;
   (c) Gemma-2-9B (4 of 42 layers: softcaps, alternating windows; no K1)
   with one prompt past its window, plain and speculative, on the gather
   route.
17. The device mesh (parallel/): K1f, K1k, K1q, K3 and K4 against their
   plain versions at a rank's shapes under ``--tp 2`` (16 query heads over 2
   KV heads); TinyLlama-1.1B at full width and depth compressed by
   ``grasp-compress-torch``'s flags with ``--dp 2 --tp 2`` on four ranks
   that share the card (gloo; two calibration rows a batch, one a data rank)
   against the same flags on one rank: layers and ranks equal, every
   selected index equal or a near tie printed and explained, each rank's
   flash launches as derived, the gathered checkpoint's dense tensors
   bit-equal; recovery in fp32 on the same mesh against one process (losses
   within MESH_LOSS_RTOL, replicated tensors bit-equal on every rank); the
   compressed checkpoint served TP-2 through the engine API, plain (K3, 22
   launches a decode step on each rank) and with an int8 draft at gamma 4
   (K4, 22 a macro-step), held to the single-process teacher-forced forward.
18. The rest of parallel/ on ranks that share the card (gloo): K2, K5 and
   K5d against their plain versions at a TP-2 rank's shapes; (a) ring
   attention at TinyLlama's heads (32 over 4 KV heads of 64) over 8192
   tokens on 4 ranks in fp32 and bf16 against one rank's plain attention;
   (b) ``seq_parallel_logits`` of TinyLlama-1.1B at full width and depth over
   4096 tokens on 4 ranks in fp32 and bf16 against one rank's forward, then
   ``seq_parallel_loss`` and its gradients with remat and two
   ``make_seq_parallel_train_step`` steps at 4 of its 22 layers (the
   gradients' traffic through the host) against one rank, no kernel launched
   on these paths (none in JAX's either); (c) the serving slice's compressed
   TinyLlama-1.1B hybridized (``hybridize_layers``) in 2 stages of 11
   layers, 4 microbatches of 256 rows: the loss in bf16 through K2 against
   the plain products, in fp32 with its gradients against one rank, one
   masked AdamW step (structural zeros kept), K2's launches on each stage as
   derived; (d) the checkpoint served TP-2 through the engine API with int4
   weights (K5, then K5d under ``GRASP_INT4_KERNEL=dma``; K3) and with
   ``use_pallas_lowrank`` (K2 in prefill), launches on each rank as derived,
   tokens held to the single-process teacher-forced forward.
19. ``grasp_tpu_torch.perf`` at TinyLlama-1.1B's full width and depth in
   bf16: (a) ``count_params`` (1,100,048,384) and ``estimate_forward_flops``
   at 2047 tokens, dense and compressed, against a count from the shapes;
   (b) ``device_memory`` against the params' bytes and ``reset_hbm_peak``;
   (c) ``forward_device_benchmark`` at 8 x 2047 with labels through K1f (22
   launches a captured forward), one CUDA graph of the chain beside the same
   chain run eagerly, a replay held to the eager chain's value; (d)
   ``decode_device_benchmark`` at batch 1 and 8 on bf16 and int4 weights
   (K5; K5d under ``GRASP_INT4_KERNEL=dma`` at batch 8; 161 int4 launches a
   captured step, 147 + 14 under dma), graph beside eager, and a longrope
   decode chain across its original context in one CUDA graph, bit-equal to
   the eager chain (the factors are chosen on the device); (e)
   ``generation_benchmark`` of the fused compressed model (K2, 14 a
   prefill); (f) ``trace`` around an eager int4 decode step and a flash
   forward, the kernels in the file counted against the launch counts, and
   around one graph replay. The record's launches add each graph's captured
   launches once for every replay.
20. Gemma-7B at full width (hidden 3072, 16 MHA heads of 256, intermediate
   24576, vocab 256000, tied head; 4 of its 28 layers in the whole run, all
   28 under ``--only gemma7b``; random weights from a seed, the last two
   layers low-rank as in 5) saved as a port checkpoint and served by
   ``grasp-serve-torch`` as in 5 through K3 at head_dim 256 (a launch a layer
   a decode step), with ``--quantized_kv`` through K3's int8 body and with
   ``--speculative int8 --gamma 4`` through K4 at head_dim 256, every token
   held to the teacher-forced forward.

The third line from the end is a JSON record of each kernel (launches in its
slice's run, error against the plain version, times, bound; the flash
and paged kernels' times at head_dim 96 under "hd96", at 128 under "hd128",
the flash kernels' at 256 under "hd256"; the paged kernels' at Gemma-7B's
heads under "hd256", Gemma-2B's under "hd256_gemma2b", over int8 pages at
Mistral-7B's under "int8_hd128" and at Gemma-7B's under "int8_hd256", each
with its error against the plain version, and the JAX call site they also
stand in for under "also_replaces");
then the card's line; the last line is ``{"ok": true, "device": {...}}``.
Imports nothing of JAX, of grasp_tpu or of safetensors. ``--only
flash|kernels|serve|spec|compress|evaluate|recover|hf|phi3serve|features|mixtral|families|mesh|seqpipe``
(or ``perf``, ``gemma7b``, ``paged``) runs one part while developing and prints no result
lines (paged: phase 3 alone, its timing records as one JSON line; phi3serve: the
paged kernels at head_dim 96 and phase 13 with its serving; features: phase
14 alone; mixtral: the paged kernels and the flash timing at head_dim 128,
then phase 15; families: the flash timing at head_dim 256, then phase 16;
mesh: phase 17; seqpipe: phase 18; perf: phase 19; gemma7b: the paged
kernels at head_dim 256, fp and int8 pages, then phase 20).
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
# int8 pages in bfloat16: the kernel rounds P, the value scale and their
# product to bf16 before P V (the JAX gather route's order), where the plain
# version dequantizes the pages in fp32; their bf16 outputs may then sit one
# bf16 step apart, at most 2^-7 of the largest output's magnitude (a row of
# one slot returns that slot's V: 0.03125 at a magnitude of 4 to 8)
INT8_BF16_REL = 2 ** -7


def _tol(dtype_name, quantized, want):
    """The tolerance of a kernel against its plain version's output ``want``."""
    if quantized and dtype_name == "bfloat16":
        return max(TOL[dtype_name], INT8_BF16_REL * want.float().abs().max().item())
    return TOL[dtype_name]


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
    tensor-core kernel (flash forward, dQ, dK/dV at head_dim 64, 96, 128 and 256;
    fused low-rank; both bf16 int4 kernels at 1, 2, 4 and 8 n-tiles; bf16
    paged decode and chunk over fp pages at head_dim 64, 96, 128 and 256 and
    over int8 pages at 128 and 256) holds HMMA instructions."""
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
    want = {f"{family}<{hd}>" for family in families[:3] for hd in (64, 96, 128, 256)}
    want |= {f"lowrank_fused_mma_kernel<{rc},false>" for rc in range(1, 9)}
    want.add("lowrank_fused_mma_kernel<8,true>")  # the rank chunks of a rank above 256
    want |= {f"{family}<{nt}>" for family in families[4:6] for nt in (1, 2, 4, 8)}
    want |= {f"{family}<{hd},false>" for family in families[6:] for hd in (64, 96, 128, 256)}
    want |= {f"{family}<{hd},true>" for family in families[6:] for hd in INT8_HDS}
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


def _int8_pages(torch, k, v):
    """int8 pools of k and v [layers, nkv, P, ps, hd] by the engine's own
    quantizer (one fp32 absmax scale per slot and head, models.llama
    ._quantize_kv): (k8, v8, k_scales, v_scales), the scales [layers, nkv,
    P, ps, 1]."""
    from grasp_tpu_torch.models.llama import _quantize_kv

    (k8, ks), (v8, vs) = _quantize_kv(k), _quantize_kv(v)
    return k8, v8, ks, vs


def _split_edge_lengths(split_slots, capacity):
    """Lengths on both sides of every range edge of the split plan, two
    ranges and the full table."""
    out = {1, 2 * split_slots, capacity}
    for edge in range(split_slots, capacity + 1, split_slots):
        out |= {edge - 1, edge, edge + 1}
    return sorted(n for n in out if 1 <= n <= capacity)


# Phi-3-mini-4k's heads (query heads, kv heads, head_dim): 32 MHA heads of 96
PHI3_HEADS = (32, 32, 96)
# Gemma-7B's (16 MHA heads of 256), Gemma-2B's (8 over 1 of 256), Mistral-7B's
# (32 over 8 of 128)
GEMMA7B_HEADS = (16, 16, 256)
GEMMA2B_HEADS = (8, 1, 256)
MISTRAL_HEADS = (32, 8, 128)
# query heads a kv head that both paged kernels are held at, at every head_dim
PAGED_GROUPS = (1, 4, 8, 16)
# head_dims of the kernels' int8-page bodies: where jax's TPU kernel reads
# int8 pages in place (grasp_tpu/serving/paged.py: head_dim % 128 == 0)
INT8_HDS = (128, 256)


def phase_kernel(torch, hds=(64, 96, 128, 256), int8_hds=INT8_HDS):
    """The decode kernel against its plain version within TOL: TinyLlama's
    decode shape, head_dim 128 and Phi-3's heads (32 MHA heads of 96) with
    lengths across tile and page edges and a dead row, Phi-3's heads again on
    both sides of every edge of the plan's ranges, Gemma-7B's and Gemma-2B's
    heads (head_dim 256); then groups of 1, 4, 8 and 16 at each head_dim with
    lengths on both sides of every range edge. Over int8 pages (the engine's
    quantizer; the plain version dequantizes them) at ``int8_hds``:
    Mistral-7B's and Gemma-7B's heads and the groups. Every call runs twice
    and must be torch.equal to itself. ``hds``: the head_dims to hold over fp
    pages. Returns the worst error."""
    from grasp_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_reference, paged_plan)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1234)
    lengths = [1, 127, 128, 129, 2048, 0, 1000, 2047]  # 0: dead row on null page 0
    nh96, nkv96, _ = PHI3_HEADS
    cases = [(64, 32, 4, lengths, False), (128, 32, 8, lengths, False),
             (96, nh96, nkv96, lengths, False), (256, *GEMMA7B_HEADS[:2], lengths, False),
             (256, *GEMMA2B_HEADS[:2], lengths, False), (128, *MISTRAL_HEADS[:2], lengths, True),
             (256, *GEMMA7B_HEADS[:2], lengths, True)]
    split96 = paged_plan(128, 16, 96, 1, torch.bfloat16).split_slots
    cases.append((96, nh96, nkv96, _split_edge_lengths(split96, 2048) + [0], False))
    for hd, quantized in [(hd, False) for hd in (64, 96, 128, 256)] + [
            (hd, True) for hd in INT8_HDS]:
        for gqa in PAGED_GROUPS:
            split = paged_plan(128, 16, hd, gqa, torch.bfloat16,
                               torch.int8 if quantized else None).split_slots
            cases.append((hd, 2 * gqa, 2, _split_edge_lengths(split, 2048), quantized))
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for hd, nh, nkv, lens_case, quantized in cases:
        if hd not in (int8_hds if quantized else hds):
            continue
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            q, k, v, lens, tables = _pages_case(torch, gen, dev, dtype, len(lens_case), nh, nkv,
                                                hd, 128, 16, 16 * len(lens_case) + 1, lens_case)
            scales = {}
            if quantized:
                k, v, ks, vs = _int8_pages(torch, k, v)
                scales = {"k_scales": ks[0], "v_scales": vs[0]}
            scale = hd ** -0.5
            got = paged_attention(q, k[0], v[0], lens, tables, scale, **scales)
            again = paged_attention(q, k[0], v[0], lens, tables, scale, **scales)
            want = paged_attention_reference(q, k[0], v[0], lens, tables, scale, **scales)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            same = torch.equal(got, again)
            tol = _tol(dtype_name, quantized, want)
            ok = torch.isfinite(got).all().item() and err <= tol and same
            print(f"kernel vs plain: hd={hd} nh={nh} nkv={nkv} {dtype_name}"
                  f"{' over int8 pages' if quantized else ''}, {len(lens_case)} "
                  f"rows of lengths {min(lens_case)}..{max(lens_case)}: max_abs_err={err:.3e} "
                  f"(tol {tol:g}), equal run to run: {same} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"paged attention kernel disagrees: hd={hd} nh={nh} "
                                     f"nkv={nkv} {dtype_name} int8 pages {quantized}")
            worst[dtype_name] = max(worst[dtype_name], err)
            del q, k, v, scales
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


# the served shapes the paged kernels are timed at: (layer slices cycled
# through, query heads, kv heads, head_dim, pages in the pool). TinyLlama's
# 22 layers' pools together exceed the L2 cache, as in decode; one call at
# Phi-3's heads already reads 70 MB of live K/V, so 4 slices do; Mixtral's
# heads (32 query heads over 8 of 128) in 4 layer slices, and Mistral-7B's
# (the same heads) over int8 pages; Gemma-7B's 94 MB of live K/V (47 MB over
# int8 pages) in 2 and 4 slices; Gemma-2B's 6 MB a call in its 18.
TINYLLAMA_TIMING = (22, 32, 4, 64, 256)
PHI3_TIMING = (4, 32, 32, 96, 129)
MIXTRAL_TIMING = (4, 32, 8, 128, 129)
GEMMA7B_TIMING = (2, *GEMMA7B_HEADS, 129)
GEMMA7B_INT8_TIMING = (4, *GEMMA7B_HEADS, 129)
GEMMA2B_TIMING = (18, *GEMMA2B_HEADS, 129)


def _timing_pools(torch, gen, dev, nh, nkv, hd, num_pages, n_layers, lengths, quantized,
                  c_len=None):
    """The timed inputs at a served shape: q ([8, nh, hd], or [8, c_len, nh,
    hd]) and bf16 or int8 pools of ``n_layers`` layer slices; returns (q,
    k, v, lengths, tables, {layer: scales kwargs})."""
    q, k, v, lens, tables = _pages_case(torch, gen, dev, torch.bfloat16, 8, nh, nkv, hd,
                                        128, 16, num_pages, lengths, layers=n_layers)
    if c_len is not None:
        q = torch.randn(8, c_len, nh, hd, generator=gen, device=dev).bfloat16()
    scales = {li: {} for li in range(n_layers)}
    if quantized:
        k, v, ks, vs = _int8_pages(torch, k, v)
        scales = {li: {"k_scales": ks[li], "v_scales": vs[li]} for li in range(n_layers)}
    return q, k, v, lens, tables, scales


def _kv_bytes(rows, nkv, hd, quantized):
    """Bytes of ``rows`` live K and V rows of every kv head: bf16, or int8
    with an fp32 scale a row."""
    return 2 * rows * nkv * (hd + 4 if quantized else hd * 2)


def phase_kernel_timing(torch, n_layers, nh=32, nkv=4, hd=64, num_pages=256, quantized=False):
    """Kernel and plain version at a served decode shape: B=8, bf16 q,
    lengths of the slice's prompts 32 tokens into decoding, pages of 128, 16
    a row (TinyLlama's heads by default), bf16 or (``quantized``) int8
    pages. The timed inputs are held to the plain version first. Turns:
    plain, kernel, kernel, plain, each after the idle spin; reports the mean
    of each pair."""
    from grasp_tpu_torch.ops.paged_attention import paged_attention, paged_attention_reference

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(99)
    lengths = [n + 32 for n in PROMPT_LENS]
    q, k, v, lens, tables, scales = _timing_pools(torch, gen, dev, nh, nkv, hd, num_pages,
                                                  n_layers, lengths, quantized)
    scale = hd ** -0.5

    def kern(li):
        return paged_attention(q, k[li], v[li], lens, tables, scale, **scales[li])

    def plain(li):
        return paged_attention_reference(q, k[li], v[li], lens, tables, scale, **scales[li])

    want = plain(0)
    err = (kern(0).float() - want.float()).abs().max().item()
    if err > _tol("bfloat16", quantized, want):
        raise AssertionError(f"paged attention kernel disagrees on the timed inputs: hd={hd} "
                             f"int8 pages {quantized}, max_abs_err {err:.3e}")

    p1 = _time_ms(torch, plain, n_layers, 20, run_ahead=True)
    k1 = _time_ms(torch, kern, n_layers, 20, run_ahead=True)
    k2 = _time_ms(torch, kern, n_layers, 20, run_ahead=True)
    p2 = _time_ms(torch, plain, n_layers, 20, run_ahead=True)
    # least time for this call: the live K and V rows (and their scales), q
    # and the output moved once at 3.35 TB/s, against q.k and p.v (2 flops
    # each per element) at the bf16 tensor-core peak
    live = sum(lengths)
    nbytes = (_kv_bytes(live, nkv, hd, quantized) + 2 * q.numel() * 2 + lens.numel() * 4
              + tables.numel() * 4)
    rec = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, **_bound(nbytes, 4 * live * nh * hd),
           "library_ms": None, "max_abs_err": err}
    print(f"kernel timing (B=8 nh={nh} nkv={nkv} hd={hd} bf16, "
          f"{'int8' if quantized else 'bf16'} pages, lengths {lengths}): max_abs_err against "
          f"the plain version {err:.3e}; kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} "
          f"ms" + _shares(rec))
    del q, k, v, scales
    torch.cuda.empty_cache()
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
# chunks of 9 with a range live for the chunk's later positions only (249:
# the last position alone reaches slot 256), across every edge but the last
SPLIT_EDGE_CHUNK9_BASES = (249, 252, 254, 256, 505, 1020, 1790, 2039)
# verify steps of 9 queries whose C x gqa rows the bf16 kernel cuts into
# groups of 16: Gemma-7B's one row a kv head and position, Mistral-7B's 4
# over int8 pages (3 groups), Gemma-2B's 8 (5 groups), groups of 16 (9
# groups: one position each) at head_dim 256 and over int8 pages at 128
GROUP_CHUNK_SHAPES = ((GEMMA7B_HEADS, False), (GEMMA7B_HEADS, True), (MISTRAL_HEADS, True),
                      (GEMMA2B_HEADS, False), ((32, 2, 256), False), ((32, 2, 128), True))


def _chunk_compare(torch, q, k, v, base, tables, scale, **scales):
    """One chunk-kernel call held against its plain version and, row by row
    with torch.equal, against the decode kernel at length base + c; int8
    pages pass their ``k_scales``/``v_scales``. Returns (max abs error
    against the plain version, chunk positions that differ, the tolerance
    in bf16: ``_tol`` of the plain version's output)."""
    from grasp_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_chunk, paged_attention_chunk_reference)

    got = paged_attention_chunk(q, k, v, base, tables, scale, **scales)
    want = paged_attention_chunk_reference(q, k, v, base, tables, scale, **scales)
    unequal = []
    for c in range(q.shape[1]):
        single = paged_attention(q[:, c].contiguous(), k, v, base + c, tables, scale, **scales)
        if not torch.equal(got[:, c], single):
            unequal.append(c)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all().item():
        raise AssertionError("paged attention chunk kernel: non-finite output")
    return ((got.float() - want.float()).abs().max().item(), unequal,
            _tol("bfloat16", bool(scales), want))


def phase_chunk(torch, hds=(64, 96, 128, 256), int8_hds=INT8_HDS):
    """The chunk kernel against its plain version within TOL, and against the
    decode kernel with torch.equal: row (b, c) is the decode kernel's output
    at length base[b] + c. A grid of small cases, then the verify step's own
    shape at TinyLlama's heads, Phi-3's (32 MHA heads of 96), Gemma-7B's and
    Gemma-2B's (head_dim 256); over int8 pages at ``int8_hds`` the grid and
    Mistral-7B's and Gemma-7B's heads. ``hds``: the head_dims to hold over fp
    pages. At head_dim 256 and over int8 pages also chunks of 9 across the
    range edges (a range live for the later positions only) with groups of
    1 to 16 (GROUP_CHUNK_SHAPES), whose rows take one to nine groups of 16.
    Returns the worst error against the plain version."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)
    b, nkv = len(CHUNK_BASES), 2
    worst, cases, rows = 0.0, 0, 0
    for hd, quantized in [(hd, False) for hd in hds] + [(hd, True) for hd in int8_hds]:
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            unequal, errs, over = [], [], []
            for gqa in PAGED_GROUPS:
                for ps, pps in ((16, 16), (128, 2)):
                    _, k, v, base, tables = _pages_case(torch, gen, dev, dtype, b, nkv * gqa, nkv,
                                                        hd, ps, pps, b * pps + 1, CHUNK_BASES)
                    scales = {}
                    if quantized:
                        k, v, ks, vs = _int8_pages(torch, k, v)
                        scales = {"k_scales": ks[0], "v_scales": vs[0]}
                    for c_len in CHUNK_LENS:
                        q = torch.randn(b, c_len, nkv * gqa, hd, generator=gen,
                                        device=dev).to(dtype)
                        err, bad, tol = _chunk_compare(torch, q, k[0], v[0], base, tables,
                                                       hd ** -0.5, **scales)
                        tol = tol if dtype_name == "bfloat16" else TOL[dtype_name]
                        unequal += [(gqa, ps, c_len, c) for c in bad]
                        errs.append(err)
                        over += [(gqa, ps, c_len, err, tol)] if err > tol else []
                        cases += 1
                        rows += b * c_len
            ok = not unequal and not over
            tol_text = (f"tol {TOL[dtype_name]:g}" if not (quantized and dtype_name == "bfloat16")
                        else f"tol the larger of {TOL[dtype_name]:g} and {INT8_BF16_REL:g} of "
                             f"the plain output's max; beyond it {over[:4]}")
            print(f"chunk kernel: hd={hd} {dtype_name}{' over int8 pages' if quantized else ''}, "
                  f"gqa {PAGED_GROUPS}, pages of 16 and "
                  f"128, chunks {CHUNK_LENS}, {b} rows of base lengths {CHUNK_BASES}: max_abs_err "
                  f"against the plain version {max(errs):.3e} ({tol_text}); rows "
                  f"unequal to the decode kernel at length base + c: {len(unequal)} "
                  f"{unequal[:4]} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"paged attention chunk kernel disagrees: hd={hd} {dtype_name}"
                                     f" int8 pages {quantized}")
            worst = max(worst, max(errs))
    shapes = [(s, False) for s in ((32, 4, 64), PHI3_HEADS, GEMMA7B_HEADS, GEMMA2B_HEADS)]
    shapes += [(s, True) for s in (MISTRAL_HEADS, GEMMA7B_HEADS)]
    verify = [(shape, SPEC_GAMMA + 1, bases) for shape in shapes
              for bases in (SERVED_CHUNK_BASES, SPLIT_EDGE_CHUNK_BASES)]
    verify += [(shape, 9, SPLIT_EDGE_CHUNK9_BASES) for shape in GROUP_CHUNK_SHAPES]
    verify = [case for case in verify if case[0][0][2] in (int8_hds if case[0][1] else hds)]
    for (((nh, nkv, hd), quantized), c_len, bases), dtype_name in itertools.product(
            verify, ("float32", "bfloat16")):
        dtype = getattr(torch, dtype_name)
        b = len(bases)
        _, k, v, base, tables = _pages_case(torch, gen, dev, dtype, b, nh, nkv, hd, 128, 16, 256,
                                            bases)
        scales = {}
        if quantized:
            k, v, ks, vs = _int8_pages(torch, k, v)
            scales = {"k_scales": ks[0], "v_scales": vs[0]}
        q = torch.randn(b, c_len, nh, hd, generator=gen, device=dev).to(dtype)
        err, bad, tol = _chunk_compare(torch, q, k[0], v[0], base, tables, hd ** -0.5, **scales)
        tol = tol if dtype_name == "bfloat16" else TOL[dtype_name]
        ok = not bad and err <= tol
        print(f"chunk kernel at the verify step's shape: B={b} C={c_len} nh={nh} nkv={nkv} "
              f"hd={hd} {dtype_name}{' over int8 pages' if quantized else ''}, pages of 128, 16 "
              f"per row, base lengths "
              f"{bases}: max_abs_err against the plain version {err:.3e} (tol "
              f"{tol:g}); chunk positions unequal to the decode kernel: {bad} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"paged attention chunk kernel disagrees at the verify step's "
                                 f"shape: hd={hd} {dtype_name} int8 pages {quantized}")
        worst = max(worst, err)
        cases += 1
        rows += b * c_len
        del q, k, v, scales
    print(f"chunk kernel: {cases} cases, {rows} rows, every row bit-equal to the decode kernel")
    return worst


def phase_chunk_timing(torch, n_layers, nh=32, nkv=4, hd=64, num_pages=256, quantized=False):
    """The chunk kernel, its plain version and one decode launch per chunk
    position on the same inputs, at the verify step's shape: B=8, bf16 q,
    the slice's lengths, a chunk of gamma + 1 = 5 (TinyLlama's heads by
    default), bf16 or (``quantized``) int8 pages. Turns: plain, kernel,
    decode launches, decode launches, kernel, plain, each after the idle
    spin. Bound: every K/V row a query of the chunk sees read once, q and the
    output moved once, at 3.35 TB/s, against q.k and p.v at the bf16 peak."""
    from grasp_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_chunk, paged_attention_chunk_reference)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(98)
    lengths = [n + 32 for n in PROMPT_LENS]
    c_len = SPEC_GAMMA + 1
    q, k, v, base, tables, scales = _timing_pools(torch, gen, dev, nh, nkv, hd, num_pages,
                                                  n_layers, lengths, quantized, c_len=c_len)
    singles = [(q[:, c].contiguous(), base + c) for c in range(c_len)]
    scale = hd ** -0.5

    def kern(li):
        paged_attention_chunk(q, k[li], v[li], base, tables, scale, **scales[li])

    def plain(li):
        paged_attention_chunk_reference(q, k[li], v[li], base, tables, scale, **scales[li])

    def decodes(li):
        for q_c, lens_c in singles:
            paged_attention(q_c, k[li], v[li], lens_c, tables, scale, **scales[li])

    # the timed inputs themselves, held as phase_chunk holds its cases
    err, bad, tol = _chunk_compare(torch, q, k[0], v[0], base, tables, scale, **scales[0])
    if bad or err > tol:
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
    nbytes = (_kv_bytes(kv_rows, nkv, hd, quantized) + 2 * q.numel() * 2 + base.numel() * 4
              + tables.numel() * 4)
    rec = {"ms": mean["kernel"], "plain_ms": mean["plain"],
           **_bound(nbytes, 4 * pairs * nh * hd), "library_ms": None,
           "decodes_ms": mean["decodes"], "max_abs_err": err}
    print(f"chunk kernel timing (B=8 C={c_len} nh={nh} nkv={nkv} hd={hd} bf16, "
          f"{'int8' if quantized else 'bf16'} pages, base lengths "
          f"{lengths}), ms per call, two turns each: "
          + ", ".join(f"{name} {xs[0]:.4f}/{xs[1]:.4f}" for name, xs in t.items())
          + f"; {c_len} decode launches over one chunk launch: "
            f"{mean['decodes'] / mean['kernel']:.2f}x" + _shares(rec))
    del q, k, v, singles, scales
    torch.cuda.empty_cache()
    return rec


# the JAX engine's call of jax's own TPU paged-attention kernel, which the paged
# kernels stand in for at head_dim 128 and 256 over fp and int8 pages
K7_SITE = ("grasp_tpu/serving/paged.py:306 (jax.experimental.pallas.ops.tpu.paged_attention, "
           "its pl.pallas_call at paged_attention_kernel.py:628)")


def phase_k7_timing(torch, timing, gemma2b=True):
    """``timing`` (phase_kernel_timing or phase_chunk_timing) at the layouts
    of jax's paged-attention route: Gemma-7B's heads over bf16 pages
    ("hd256") and over int8 pages ("int8_hd256"), Mistral-7B's over int8
    pages ("int8_hd128") and, with ``gemma2b``, Gemma-2B's over bf16 pages
    ("hd256_gemma2b"). Returns {key: record}."""
    out = {"hd256": timing(torch, *GEMMA7B_TIMING)}
    if gemma2b:
        out["hd256_gemma2b"] = timing(torch, *GEMMA2B_TIMING)
        out["int8_hd128"] = timing(torch, *MIXTRAL_TIMING, quantized=True)
    out["int8_hd256"] = timing(torch, *GEMMA7B_INT8_TIMING, quantized=True)
    return out


# (B, nh, nkv, S, hd, scale): the calibration shape of TinyLlama-1.1B, a ragged
# batch of two, head_dim 128, and a single position; None = hd ** -0.5
FLASH_CASES = ((1, 32, 4, 2047, 64, None), (2, 8, 2, 511, 64, 0.2),
               (1, 32, 8, 1024, 128, None), (1, 4, 4, 1, 64, None),
               # head_dim 96 (Phi-3): its calibration shape (groups of 1), then
               # groups of 4 at lengths across the 64-row tile edges
               (1, 32, 32, 2047, 96, None), (2, 8, 2, 130, 96, 0.2), (1, 8, 2, 65, 96, None),
               # head_dim 256 (Gemma): Gemma-2B's calibration shape (8 query heads over
               # one kv head), Gemma-7B's 16 MHA heads at a ragged batch of two, and a
               # length across the tile edges
               (1, 8, 1, 2047, 256, None), (2, 16, 16, 130, 256, 0.0625),
               (1, 8, 1, 65, 256, None))
# the shape each flash kernel is timed at: TinyLlama's and Phi-3's calibration
# (and Mixtral-8x7B's, head_dim 128)
FLASH_TIMING_SHAPES = {64: (1, 32, 4, 2047, 64), 96: (1, 32, 32, 2047, 96),
                       128: (1, 32, 8, 2047, 128), 256: (1, 8, 1, 2047, 256)}
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


def phase_flash_timing(torch, shape=FLASH_TIMING_SHAPES[64]):
    """Each kernel, the plain version and the library call
    (scaled_dot_product_attention, a yardstick the port never calls) at a
    calibration ``shape`` (B, nh, nkv, S, hd) in bf16, in turns plain,
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
    b, nh, nkv, s, hd = shape
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
        print(f"flash timing {name} (B={b} nh={nh} nkv={nkv} S={s} hd={hd} bf16), ms per call, "
              "two turns each: " + ", ".join(f"{turn} {t[turn, name][0]:.4f}/{t[turn, name][1]:.4f}"
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


def build_flagship(torch, dev, config=None):
    """TinyLlama-1.1B (or ``config``) at full width, bf16, random weights
    from a seeded generator; the last two layers' seven projections become
    GRASP low-rank factors at preserve_rank(in, out, 0.9)."""
    import dataclasses

    from grasp_tpu_torch import ModelConfig
    from grasp_tpu_torch.models.llama import (
        ATTN_PROJS, PROJ_ORDER, default_plan, init_params, plan_set)
    from grasp_tpu_torch.ops.saliency import preserve_rank

    config = dataclasses.replace(config or ModelConfig.tinyllama_1_1b(), dtype="bfloat16")
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


def _post(port, body, timeout=600, path="/v1/completions"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
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


def _served_gaps(torch, params, config, plan, served, dev, quantized_kv=False):
    """Teacher-forced plain forward (no pages, no kernel) of prompt + served
    tokens: for each served sequence, each generated token's logit below the
    largest logit at its position [n], and whether it is the argmax [n].
    ``quantized_kv``: the forward runs through the int8 dense cache, so that
    its attention reads the quantized K/V the int8 pools hold."""
    from grasp_tpu_torch.models.llama import forward, init_kv_cache, prefill

    out_gaps = []
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
            out_gaps.append((gap, rows.argmax(dim=-1) == served_t))
            del logits, rows
    return out_gaps


def check_against_plain(torch, params, config, plan, served, dev, quantized_kv=False):
    """At every generated position the served token's logit must be within
    GAP_TOL of the teacher-forced plain forward's largest logit
    (_served_gaps). Returns (max gap, argmax matches, positions)."""
    gaps = _served_gaps(torch, params, config, plan, served, dev, quantized_kv)
    return (max(g.max().item() for g, _ in gaps), sum(int(m.sum().item()) for _, m in gaps),
            sum(len(g) for g, _ in gaps))


def _bf16_drift(torch, params, config, plan, served, dev, gaps, quantized_kv=False):
    """How far bf16 rounding alone moves the served tokens' gaps: the
    teacher-forced forward of a dense bf16 model (``gaps``, from
    _served_gaps) run again in fp32 on the same weights, each cast up
    exactly (through the int8 dense cache with ``quantized_kv``). Returns
    (the largest |bf16 gap - fp32 gap| over the served tokens, the largest
    fp32 gap)."""
    import dataclasses

    from grasp_tpu_torch.models.convert import map_params

    p32 = map_params(params, lambda t: t.float() if t.is_floating_point() else t)
    gaps32 = _served_gaps(torch, p32, dataclasses.replace(config, dtype="float32"), plan,
                          served, dev, quantized_kv)
    del p32
    torch.cuda.empty_cache()
    drift = max((g16 - g32).abs().max().item() for (g16, _), (g32, _) in zip(gaps, gaps32))
    return drift, max(g.max().item() for g, _ in gaps32)


# A served token is held within GAP_TOL of the teacher-forced forward's
# largest logit. A dense bf16 model deep enough that bf16 rounding alone
# moves a served token's gap by more (Mistral-7B's 32 layers of random
# weights, on an H100: a token 0.2188 below the bf16 forward's largest logit
# lies 0.015 below its fp32 twin's) is held within twice that drift
# instead, measured on the same tokens each run: the
# server and the forward each round in bf16, independently. Its fp32 serving
# stays held to GAP_TOL.
#
# A bf16 MoE model's router picks between nearly tied experts by the rounding
# of the batch it runs in, and on random weights a changed expert moves the
# logits by whole units. So in bf16 a served token may lie further than
# GAP_TOL below the teacher-forced forward's largest logit only where a
# router near tie explains it: at some layer the logits of the last expert
# taken and the next one lie within ROUTER_TIE of the layer's router logits'
# standard deviation at that position, and taking the next expert there
# instead brings the served token within GAP_TOL of the largest logit.
ROUTER_TIE = 1 / 16


@contextlib.contextmanager
def _routed(torch, choose):
    """While open, every MoE layer's router takes the first top_k experts of
    ``choose(logits, order, call)``: ``order`` is the router's own ranking
    [T, E] (a stable descending sort of the fp32 softmax), ``call`` the
    number of router calls before this one. The taken experts are weighted
    as the router weights them (softmax over all, renormalised over the
    taken); a ``choose`` that returns ``order`` gives the router's own
    combine bit for bit."""
    import grasp_tpu_torch.models.moe as moe

    plain = moe.router_weights
    calls = [0]

    def router(logits, top_k):
        probs = torch.softmax(logits.float(), dim=-1)
        order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
        idx = choose(logits, order, calls[0])[..., :top_k]
        calls[0] += 1
        vals = torch.gather(probs, -1, idx)
        return torch.zeros_like(probs).scatter(-1, idx, vals / vals.sum(dim=-1, keepdim=True))

    moe.router_weights = router
    try:
        yield calls
    finally:
        moe.router_weights = plain


def _routed_witness(torch, params, config, plan, served, dev):
    """For a bf16 MoE model, each served token beyond GAP_TOL of the
    teacher-forced forward's largest logit, in order along its sequence,
    explained by one router swap at its own position (the next expert taken
    in place of the last one): the layers in order of their margin there
    (the last taken expert's logit minus the next one's, over the standard
    deviation of the position's router logits), those under ROUTER_TIE, the
    first whose swap brings the token within GAP_TOL. Each swap found stays
    in the forward for the positions after it, whose keys and values it
    changes. Returns (for each token beyond GAP_TOL its (layer, margin), or
    (position, gap, margins, gaps after each swap) where none explains it;
    the share of all generated positions with a near tie at some layer)."""
    from grasp_tpu_torch.models.llama import forward

    k = config.num_experts_per_tok
    explained, tied, total = [], 0, 0
    with torch.no_grad():
        for prompt, out in served:
            ids = torch.tensor([list(prompt) + out[:-1]], device=dev)
            p0 = len(prompt) - 1
            served_t = torch.tensor(out, device=dev)
            swaps = []  # (layer, row) of the swaps found so far

            def run(extra=()):
                """(gap of each served token, margin [layers, tokens])."""
                logs = []

                def choose(logits, order, call):
                    logs.append(logits.float())
                    rows = [row for layer, row in swaps + list(extra) if layer == call]
                    if rows:
                        order = order.clone()
                        last, after = order[rows, k - 1].clone(), order[rows, k].clone()
                        order[rows, k - 1], order[rows, k] = after, last
                    return order

                with _routed(torch, choose):
                    rows = forward(params, ids, config=config, plan=plan)["logits"][0, p0:].float()
                r = torch.stack(logs)[:, p0:]
                top = r.sort(dim=-1, descending=True).values
                gap = rows.max(dim=-1).values - rows.gather(1, served_t[:, None])[:, 0]
                return gap, (top[..., k - 1] - top[..., k]) / r.std(dim=-1)

            gap, margin = run()
            tied += int((margin.min(dim=0).values < ROUTER_TIE).sum().item())
            total += len(out)
            j = 0
            while True:
                beyond = (gap[j:] > GAP_TOL).nonzero()
                if len(beyond) == 0:
                    break
                j += beyond[0].item()
                tried, found = [], None
                for layer in margin[:, j].argsort().tolist():
                    if margin[layer, j].item() >= ROUTER_TIE:
                        break
                    alt_gap, alt_margin = run([(layer, p0 + j)])
                    tried.append(round(alt_gap[j].item(), 4))
                    if alt_gap[j].item() <= GAP_TOL:
                        found = (layer, round(margin[layer, j].item(), 4))
                        swaps.append((layer, p0 + j))
                        gap, margin = alt_gap, alt_margin
                        break
                explained.append(found or (j, round(gap[j].item(), 4),
                                           [round(m, 4) for m in margin[:, j].tolist()], tried))
                j += 1
    return explained, tied / max(total, 1)


def hold_to_plain(torch, params, config, plan, served, dev, quantized_kv=False):
    """The served tokens against a teacher-forced plain forward (through the
    int8 dense cache with ``quantized_kv``): (whether they fail, a report).
    Every token within GAP_TOL of the largest logit; in bf16, a dense
    model's within twice the bf16 drift where that is larger (_bf16_drift),
    and a MoE model's beyond it only where a router near tie explains it
    (_routed_witness)."""
    gaps = _served_gaps(torch, params, config, plan, served, dev, quantized_kv)
    gap = max(g.max().item() for g, _ in gaps)
    match, total = sum(int(m.sum().item()) for _, m in gaps), sum(len(g) for g, _ in gaps)
    report = f"argmax agrees at {match}/{total} positions, max logit gap {gap:.4f}"
    if config.dtype != "bfloat16" or (gap <= GAP_TOL and not config.num_local_experts):
        return gap > GAP_TOL, report + f" (tol {GAP_TOL})"
    if not config.num_local_experts:
        drift, worst32 = _bf16_drift(torch, params, config, plan, served, dev, gaps,
                                     quantized_kv)
        tol = max(GAP_TOL, 2 * drift)
        return gap > tol, (
            f"{report}, beyond {GAP_TOL}: the same forward in fp32 puts the served tokens at a "
            f"max gap of {worst32:.4f}, and bf16 rounding moves a served token's gap by up to "
            f"{drift:.4f}; tol {tol:.4f} (the larger of {GAP_TOL} and twice that drift)")
    explained, share = _routed_witness(torch, params, config, plan, served, dev)
    found = [e for e in explained if len(e) == 2]
    missing = [e for e in explained if len(e) != 2]
    return bool(missing), (
        f"{report}; {len(explained)} tokens beyond tol {GAP_TOL}, each to be explained by one "
        f"router swap at a near tie (margin under {ROUTER_TIE:g} of the router logits' standard "
        f"deviation): (layer, margin) {found}; unexplained {len(missing)} (position, gap, "
        f"margin by layer, gaps after the swaps tried; the first 8) {missing[:8]}; positions "
        f"with such a near tie at some layer {share:.3f} of all")


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
        gc.collect()  # the server and its engine free their tensors only in a collection
        torch.cuda.empty_cache()


def _int4_projections(params):
    """(groups' size, output width) of every int4 product the model runs per
    forward, in order: each dense projection, both products of each low-rank
    pair, the lm_head."""
    def geometry(packed, scale):
        return 2 * packed.shape[0] // scale.shape[0], packed.shape[1]

    out = []
    for layer in params["layers"]:
        for group in ("self_attn", "mlp"):  # MoE experts take the plain stacked products
            for p in layer.get(group, {}).values():
                for key in ("kernel", "in_kernel", "out_kernel"):
                    if key + "_q4" in p:
                        out.append(geometry(p[key + "_q4"], p[key + "_scale"]))
    if "kernel_q4" in params.get("lm_head", {}):
        out.append(geometry(params["lm_head"]["kernel_q4"], params["lm_head"]["kernel_scale"]))
    return out


def serve_variant(torch, dev, ckpt_root, label, extra=(), dma_round=False, *, route):
    """Serve the checkpoint one more way, a few completions one after the
    other, and hold the tokens to a teacher-forced plain forward of the
    served params and the launch counts to the dispatch rules and to
    ``route``, the attention route expected ("kernel" or "gather"). Returns
    the launches of the new kernels on this path."""
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
            want = {"grid": 0, "dma": 0, "fused": 0,
                    "paged": _route_layers(engine, config, route) * steps}
            ps = engine.pool.page_size
            padded = [-(-len(p) // ps) * ps for p in prompts]
            for rows, times in [(8, steps)] + [(n, 1) for n in padded]:
                for gs, out_f in _int4_projections(engine.params):
                    if takes_int4_kernel(rows, gs):
                        want["dma" if dma and out_f % 128 == 0 else "grid"] += times
                if config.use_pallas_lowrank and rows >= FUSED_MIN_ROWS:
                    want["fused"] += times * sum(
                        "in_kernel" in p for layer in engine.params["layers"]
                        for group in ("self_attn", "mlp") for p in layer.get(group, {}).values())
            return want

        outs, got = run_round()
        steps, secs = engine.decode_steps, engine.decode_seconds
        want = derived(dma=False)
        print(f"serve {label}: started in {start_s:.1f} s, attention route {engine.route}; "
              f"{len(outs)} completions of "
              f"{[len(o) for o in outs]} tokens, {steps} decode steps in {secs:.3f} s "
              f"({secs / max(steps, 1) * 1e3:.2f} ms per step, one request at a time); launches "
              f"{got}, derived {want}")
        if steps == 0 or got != want:
            raise AssertionError(f"serve {label}: launch counts differ from the dispatch rules")
        plain_config = dataclasses.replace(config, use_pallas_lowrank=False)
        bad, report = hold_to_plain(torch, engine.params, plain_config, engine.plan,
                                    list(zip(prompts, outs)), dev)
        print(f"serve {label}: served vs plain teacher-forced forward of the served params: "
              f"{report}")
        if bad:
            raise AssertionError(f"serve {label}: served tokens disagree with the plain forward")
        if dma_round:
            os.environ["GRASP_INT4_KERNEL"] = "dma"
            try:
                dma_outs, dma_got = run_round()
                dma_secs = engine.decode_seconds / max(engine.decode_steps, 1)
            finally:
                del os.environ["GRASP_INT4_KERNEL"]
            dma_want = derived(dma=True)
            bad, report = hold_to_plain(torch, engine.params, plain_config, engine.plan,
                                        list(zip(prompts, dma_outs)), dev)
            print(f"serve {label}, GRASP_INT4_KERNEL=dma: {dma_secs * 1e3:.2f} ms per step; "
                  f"launches {dma_got}, derived {dma_want}; {report}; same tokens as the grid "
                  f"kernel: {dma_outs == outs}")
            if dma_got != dma_want or dma_got["dma"] == 0 or bad:
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


def serve_speculative(torch, card, dev, ckpt_root, tag="serve", agreement=SPEC_AGREEMENT,
                      extra=(), *, route):
    """This slice's main path: ``--speculative int8 --gamma 4`` over fp pools.
    Greedy requests together, then a sampled one. Returns the launches of the
    chunk kernel and of the decode kernel in that run. ``tag`` starts each
    printed line. ``agreement``: the least mean share of positions at which
    the greedy streams agree with the plain engine's, or None to report the
    share only (where random weights leave the top logits tied to within the
    served path's rounding, two correct engines part at the first tie).
    ``extra``: more server flags. ``route``: the attention route expected of
    the target's verify and the draft's decode, which the kernels' launches
    are held to."""
    import numpy as np

    from grasp_tpu_torch.ops.paged_attention import paged_attention, paged_attention_chunk
    from grasp_tpu_torch.serving.paged import ServingEngine
    from grasp_tpu_torch.serving.spec_paged import SpeculativeServingEngine

    label = f"{tag} --speculative int8 --gamma {SPEC_GAMMA}"
    rng = np.random.default_rng(23)
    t0 = time.perf_counter()
    with _served(torch, dev, ckpt_root,
                 ["--speculative", "int8", "--gamma", str(SPEC_GAMMA), *extra]) as (engine, port):
        if not isinstance(engine, SpeculativeServingEngine):
            raise AssertionError("the command line did not build the speculative engine")
        config = engine.config
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
        want = {"chunk": _route_layers(engine, config, route) * steps,
                "decode": _route_layers(engine, engine.dconfig, route, engine.draft_route)
                * (SPEC_GAMMA + 1) * steps}
        n_tok = sum(len(o) for o in outs) + len(sampled)
        print(f"{label}: started in {start_s:.1f} s, routes verify {engine.route[0]}, draft "
              f"{engine.draft_route[0]}; {len(outs)} greedy completions "
              f"together ({wall:.3f} s) and 1 sampled, {SPEC_MAX_TOKENS} tokens each; {steps} "
              f"macro-steps in {engine.decode_seconds:.3f} s "
              f"({engine.decode_seconds / max(steps, 1) * 1e3:.2f} ms each); launches {got}, "
              f"derived from the macro-steps {want}; drafts accepted "
              f"{stats['accepted']}/{stats['drafted']} = {engine.acceptance_rate:.3f}, "
              f"{n_tok / max(stats['chunks'], 1):.2f} tokens per verify forward of a row; "
              f"card {card}")
        if (steps == 0 or got != want or engine.decode_steps != (SPEC_GAMMA + 1) * steps
                or any(not 0 <= t < config.vocab_size for t in sampled)):
            raise AssertionError(f"{label}: launch counts differ from the macro-steps")

        bad, report = hold_to_plain(torch, engine.params, config, engine.plan,
                                    list(zip(prompts, outs)), dev)
        print(f"{label}: greedy tokens vs plain teacher-forced forward of the target: {report}")
        if bad:
            raise AssertionError(f"{label}: served tokens disagree with the plain forward")

        # the same requests through the plain engine over the same weights
        plain = ServingEngine(engine.params, config, engine.plan, device=dev,
                              num_pages=engine.pool.num_pages, page_size=128, max_batch=8,
                              max_pages_per_seq=engine.max_pages_per_seq)
        rids = [plain.submit(p, SPEC_MAX_TOKENS) for p in prompts]
        with torch.no_grad():
            plain_outs = plain.run()
        plain_outs = [plain_outs[r] for r in rids]
        del plain
        agree = [sum(a == b for a, b in zip(o, w)) / len(w) for o, w in zip(outs, plain_outs)]
        same = sum(o == w for o, w in zip(outs, plain_outs))
        mean = sum(agree) / len(agree)
        print(f"{label}: against the plain engine on the same requests: {same}/{len(outs)} "
              f"streams identical, share of agreeing positions {[round(a, 3) for a in agree]}, "
              f"mean {mean:.3f} (bound {agreement}; identity is reported, not required: the "
              f"verify step's projections run at {8 * (SPEC_GAMMA + 1)} rows and the decode "
              f"step's at 8)")
        if [len(o) for o in plain_outs] != [len(o) for o in outs] or (
                agreement is not None and mean < agreement):
            raise AssertionError(f"{label}: streams stray from the plain engine's")
    return got


def serve_quantized_kv(torch, dev, ckpt_root, speculative, route="gather", extra=(),
                       tag="serve"):
    """``--quantized_kv``, with or without speculation: int8 pools take
    ``route``, the attention route expected (the gather route at head_dim 64
    and 96, where neither paged kernel may launch; the kernels' int8 bodies
    at 128 and 256: K3 once a layer a decode step, and under speculation K4
    once a layer a macro-step). Tokens are held by a teacher-forced forward
    through the int8 dense cache: within GAP_TOL on the gather route, and by
    hold_to_plain's rule (a deep bf16 model's drift) on the kernel route.
    ``extra``: more server flags; ``tag`` starts each printed line. Returns
    the launches of K3 ("paged") and K4 ("chunk")."""
    import numpy as np

    from grasp_tpu_torch.ops.paged_attention import paged_attention, paged_attention_chunk

    flags = ["--quantized_kv"]
    if speculative:
        flags += ["--speculative", "int8", "--gamma", str(SPEC_GAMMA)]
    label = f"{tag} {' '.join(flags)}"
    rng = np.random.default_rng(29)
    with _served(torch, dev, ckpt_root, flags + list(extra)) as (engine, port):
        if not engine.pool.quantized or engine.pool.k_pages.dtype != torch.int8:
            raise AssertionError(f"{label}: the pool is not int8")
        config = engine.config
        layers = _route_layers(engine, config, route)
        if speculative:
            dlayers = _route_layers(engine, engine.dconfig, route, engine.draft_route)
        prompts = [rng.integers(3, config.vocab_size, size=n).tolist()
                   for n in VARIANT_PROMPT_LENS]
        _reset_paged_counts(engine)
        outs = _full_length(_concurrent_posts(port, [
            {"prompt": p, "max_tokens": VARIANT_MAX_TOKENS} for p in prompts]),
            prompts, VARIANT_MAX_TOKENS, label)
        launches = (paged_attention.launches, paged_attention_chunk.launches)
        steps = engine.decode_steps
        if speculative:
            want = (dlayers * steps, layers * engine.macro_steps)
        else:
            want = (layers * steps, 0)
        if route == "gather":
            gap, match, total = check_against_plain(torch, engine.params, config, engine.plan,
                                                    list(zip(prompts, outs)), dev,
                                                    quantized_kv=True)
            bad = gap > GAP_TOL
            report = (f"argmax agrees at {match}/{total} positions, max logit gap {gap:.4f} "
                      f"(tol {GAP_TOL})")
        else:
            bad, report = hold_to_plain(torch, engine.params, config, engine.plan,
                                        list(zip(prompts, outs)), dev, quantized_kv=True)
        spec = (f", {engine.macro_steps} macro-steps, drafts accepted "
                f"{engine.last_stats['accepted']}/{engine.last_stats['drafted']}"
                if speculative else "")
        print(f"{label}: routes {engine.route[0]} ({engine.route[1]})"
              f"{', draft ' + engine.draft_route[0] if speculative else ''}; {len(outs)} "
              f"completions of {VARIANT_MAX_TOKENS} tokens, {steps} decode steps in "
              f"{engine.decode_seconds:.3f} s ({engine.decode_seconds / max(steps, 1) * 1e3:.2f} "
              f"ms each){spec}; decode and chunk kernel launches {launches} (want {want}); vs "
              f"teacher-forced forward through the int8 dense cache: {report}")
        if steps == 0 or launches != want or bad:
            raise AssertionError(f"{label} failed")
    return {"paged": launches[0], "chunk": launches[1]}


# the rest of the serving engine: one system prefix of 8 pages, suffixes of
# 100 to 300 tokens; four short rows and a long prompt for chunked admission
FEATURE_PREFIX = 1024
FEATURE_SUFFIXES = (100, 180, 240, 300)
FEATURE_MAX_TOKENS = 32
CHUNK_SHORT_LENS = (70, 90, 110, 130)
CHUNK_LONG_LEN = 1500
CHUNK_MAX_TOKENS = 64
PREFILL_CHUNK = 256
# greedy requests with every penalty (the logit bias is held on its own)
FEATURE_PEN = {"presence_penalty": 0.6, "frequency_penalty": 0.4, "repetition_penalty": 1.3}
FEATURE_REGEX = "[a-z]{3}-[0-9]{4}"
FEATURE_SCHEMA = {"type": "object", "properties": {
    "name": {"type": "string", "pattern": "[a-z]{1,8}"}, "n": {"type": "integer"}},
    "required": ["name", "n"]}


def _body(status, data, label):
    if status != 200:
        raise AssertionError(f"{label}: HTTP {status}: {data[:300]!r}")
    return json.loads(data)["choices"][0]


def _metrics(port):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", "/metrics")
    body = conn.getresponse().read().decode()
    conn.close()
    return dict(line.split(" ", 1) for line in body.strip().splitlines())


def check_penalized_against_plain(torch, params, config, plan, served, dev, pen):
    """check_against_plain with the penalties recomputed on the teacher-forced
    logits: at each generated position the counts of the prompt and the
    tokens served before it, a seen token's logit divided by the repetition
    penalty (multiplied where negative), minus frequency x count and presence
    x seen; the served token within GAP_TOL of the adjusted maximum."""
    from grasp_tpu_torch.models.llama import forward

    rep, pres, freq = (pen["repetition_penalty"], pen["presence_penalty"],
                       pen["frequency_penalty"])
    worst, match, total = 0.0, 0, 0
    with torch.no_grad():
        for prompt, out in served:
            ids = torch.tensor([list(prompt) + out[:-1]], device=dev)
            rows = forward(params, ids, config=config, plan=plan)["logits"][0].float()
            rows = rows[len(prompt) - 1:]
            for i, tok in enumerate(out):
                counts = torch.bincount(torch.tensor(list(prompt) + out[:i], device=dev),
                                        minlength=config.vocab_size).float()
                seen = counts > 0
                row = rows[i]
                row = torch.where(seen, torch.where(row < 0, row * rep, row / rep), row)
                row = row - counts * freq - seen.float() * pres
                worst = max(worst, (row.max() - row[tok]).item())
                match += int(row.argmax().item() == tok)
                total += 1
    return worst, match, total


def _grammar_walk(pattern, tokens):
    """(every token allowed, the end state accepting) of byte tokens through
    the byte-level DFA of ``pattern``."""
    from grasp_tpu_torch.serving.guided import CompiledGrammar

    g = CompiledGrammar(pattern, [bytes([i]) for i in range(256)])
    state = g.start
    for t in tokens:
        if not 0 <= t < 256 or g.token_trans[state, t] < 0:
            return False, False
        state = int(g.token_trans[state, t])
    return True, bool(g.accepting[state])


def _hold_guided(label, pattern, choice, tokens):
    """A guided output fullmatches its grammar, or, cut by max_tokens, is a
    prefix a continuation can complete."""
    ok, accepting = _grammar_walk(pattern, tokens)
    if not ok or (choice["finish_reason"] == "stop" and not accepting):
        raise AssertionError(f"{label}: {choice['text']!r} leaves the grammar")
    return "fullmatch" if accepting and choice["finish_reason"] == "stop" else "valid prefix"


def _hold_counts(label, got, want):
    print(f"{label}: launches {got}, derived {want}")
    if got != want or not all(want.values()):
        raise AssertionError(f"{label}: launch counts differ from the derived ones")


def serve_features(torch, card, dev, ckpt_root):
    """Phase 14 on the serving checkpoint: (a) ``--prefix_cache`` with one
    system prefix and four suffixes in turn, (c) the sampling controls and
    (d) guided decoding over HTTP on the same server, (e) ``--speculative
    int8 --gamma 4 --prefix_cache`` with penalized greedy requests, then
    guided speculation with two grammars through the engine API. Returns
    the launches of K3 and K4."""
    import numpy as np

    from grasp_tpu_torch.data.tokenizer import ByteTokenizer
    from grasp_tpu_torch.ops.paged_attention import paged_attention, paged_attention_chunk
    from grasp_tpu_torch.serving.guided import json_regex, schema_regex
    from grasp_tpu_torch.serving.paged import ServingEngine
    from grasp_tpu_torch.serving.spec_paged import SpeculativeServingEngine

    rng = np.random.default_rng(41)
    launches = {"paged": 0, "chunk": 0}
    with _served(torch, dev, ckpt_root, ["--prefix_cache"]) as (engine, port):
        config, layers = engine.config, engine.config.num_hidden_layers
        prefix = rng.integers(3, config.vocab_size, size=FEATURE_PREFIX).tolist()
        prompts = [prefix + rng.integers(3, config.vocab_size, size=n).tolist()
                   for n in FEATURE_SUFFIXES]
        warm = rng.integers(3, config.vocab_size, size=300).tolist()
        _check_completion(*_post(port, {"prompt": warm, "max_tokens": 2}), warm)
        saved0 = engine.prefix_tokens_saved
        _reset_paged_counts(engine)
        outs, ttfts = [], []
        for p in prompts:  # in turn: the first is cold, the others hit its 8 pages
            status, toks, ttft = _stream(port, {"prompt": p, "max_tokens": FEATURE_MAX_TOKENS})
            if status != 200 or not 1 <= len(toks) <= FEATURE_MAX_TOKENS:
                raise AssertionError(f"features (a): HTTP {status}, {len(toks)} tokens")
            outs.append(toks)
            ttfts.append(ttft)
        steps, got = engine.decode_steps, paged_attention.launches
        metrics = _metrics(port)
        saved = int(metrics["grasp_prefix_tokens_saved"]) - saved0
        print(f"features (a) --prefix_cache: {len(prompts)} requests in turn of a "
              f"{FEATURE_PREFIX}-token system prefix + {list(FEATURE_SUFFIXES)} tokens, "
              f"{FEATURE_MAX_TOKENS} new each; /metrics grasp_prefix_tokens_saved {saved} (want "
              f"{3 * FEATURE_PREFIX}) of grasp_prefix_tokens_total "
              f"{metrics['grasp_prefix_tokens_total']}; TTFT cold {ttfts[0] * 1e3:.1f} ms, "
              f"hits {[round(t * 1e3, 1) for t in ttfts[1:]]} ms (host clock, streamed); K3 "
              f"launches {got} (want {layers} x {steps}); card {card}")
        if saved != 3 * FEATURE_PREFIX or steps == 0 or got != layers * steps:
            raise AssertionError("features (a): the prefix cache or K3 ran other than counted")
        launches["paged"] += got
        gap, match, total = check_against_plain(torch, engine.params, config, engine.plan,
                                                list(zip(prompts, outs)), dev)
        plain = ServingEngine(engine.params, config, engine.plan, device=dev, num_pages=256,
                              page_size=128, max_batch=8, max_pages_per_seq=16)
        rids = [plain.submit(p, FEATURE_MAX_TOKENS) for p in prompts]
        with torch.no_grad():
            plain_outs = plain.run()
        del plain
        same = sum(a == b for o, r in zip(outs, rids) for a, b in zip(o, plain_outs[r]))
        print(f"features (a): vs plain teacher-forced forward: argmax agrees at {match}/{total}, "
              f"max logit gap {gap:.4f} (tol {GAP_TOL}); tokens equal to an engine without "
              f"the cache at {same}/{total} positions (reported: a suffix prefill runs its "
              f"products at fewer rows)")
        if gap > GAP_TOL:
            raise AssertionError("features (a): served tokens disagree with the plain forward")

        # (c) the sampling controls, greedy unless noted
        _reset_paged_counts(engine)
        p = prompts[0][-200:]
        bias_tok = 1234
        biased = _body(*_post(port, {"prompt": p, "max_tokens": 16,
                                     "logit_bias": {str(bias_tok): 100}}), "(c) bias")
        rep = _body(*_post(port, {"prompt": p, "max_tokens": 24, "repetition_penalty": 1e6}),
                    "(c) repetition")
        # min_p = 1 keeps the tokens at the top probability: the greedy
        # stream, where bf16 logits tie at the top either of the tied ones
        greedy = _body(*_post(port, {"prompt": p, "max_tokens": 16, "logprobs": 1}),
                       "(c) greedy")
        min_p = _body(*_post(port, {"prompt": p, "max_tokens": 16, "min_p": 1.0,
                                    "temperature": 1.0, "seed": 3, "logprobs": 1}), "(c) min_p")
        diverge = next((i for i, (a, b) in enumerate(zip(min_p["token_ids"],
                                                         greedy["token_ids"])) if a != b), None)
        min_p_ok = len(min_p["token_ids"]) == len(greedy["token_ids"]) and (
            diverge is None or min_p["logprobs"]["token_logprobs"][diverge]
            == greedy["logprobs"]["token_logprobs"][diverge])
        top1 = all(lp == max(top.values()) for lp, top in zip(
            min_p["logprobs"]["token_logprobs"], min_p["logprobs"]["top_logprobs"]))
        pen_outs = [_body(*_post(port, {"prompt": q[-300:], "max_tokens": FEATURE_MAX_TOKENS,
                                        **FEATURE_PEN}), "(c) penalties")["token_ids"]
                    for q in prompts[:2]]
        gap, match, total = check_penalized_against_plain(
            torch, engine.params, config, engine.plan,
            [(q[-300:], o) for q, o in zip(prompts, pen_outs)], dev, FEATURE_PEN)
        steps, got = engine.decode_steps, paged_attention.launches
        where = "throughout" if diverge is None else f"up to a tie at position {diverge}"
        print(f"features (c): logit_bias {{{bias_tok}: 100}} -> {biased['token_ids'][:6]}...; "
              f"repetition_penalty 1e6: {len(set(rep['token_ids']))} distinct of "
              f"{len(rep['token_ids'])}; min_p 1 at temperature 1: every token the model's "
              f"top-1 {top1}, the greedy stream {where}; "
              f"{FEATURE_PEN}: vs the adjusted "
              f"teacher-forced forward argmax agrees at {match}/{total}, max gap {gap:.4f} "
              f"(tol {GAP_TOL}); K3 {got} (want {layers} x {steps})")
        if (set(biased["token_ids"]) != {bias_tok} or len(biased["token_ids"]) != 16
                or len(set(rep["token_ids"])) != len(rep["token_ids"])
                or not (min_p_ok and top1) or gap > GAP_TOL
                or got != layers * steps):
            raise AssertionError("features (c): a sampling control misbehaved")
        launches["paged"] += got

        # (d) guided decoding with the byte-level tokenizer the server loaded
        _reset_paged_counts(engine)
        schema = {"type": "json_schema", "json_schema": {"name": "s", "schema": FEATURE_SCHEMA}}
        seen = []
        for label, field, pattern in (
                ("guided_regex", {"guided_regex": FEATURE_REGEX}, FEATURE_REGEX),
                ("json_object", {"response_format": {"type": "json_object"}}, json_regex()),
                ("json_schema", {"response_format": schema}, schema_regex(FEATURE_SCHEMA))):
            t0 = time.perf_counter()
            choice = _body(*_post(port, {"prompt": "Answer: ", "max_tokens": 64, **field}),
                           f"(d) {label}")
            secs = time.perf_counter() - t0
            verdict = _hold_guided(f"features (d) {label}", pattern, choice, choice["token_ids"])
            if label == "guided_regex" and not re.fullmatch(FEATURE_REGEX, choice["text"]):
                raise AssertionError(f"features (d): {choice['text']!r} does not fullmatch")
            if verdict == "fullmatch" and label == "json_schema":
                value = json.loads(choice["text"])
                if set(value) != {"name", "n"} or not isinstance(value["n"], int):
                    raise AssertionError(f"features (d): {value} does not match the schema")
            seen.append(f"{label} {choice['text']!r} ({verdict}, {choice['finish_reason']}, "
                        f"{secs:.2f} s with the grammar's first compile)")
        steps, got = engine.decode_steps, paged_attention.launches
        print(f"features (d): {'; '.join(seen)}; K3 {got} (want {layers} x {steps})")
        if got != layers * steps:
            raise AssertionError("features (d): K3 ran other than counted")
        launches["paged"] += got

    # (e) speculation with the prefix cache and penalized greedy requests
    label = f"features (e) --speculative int8 --gamma {SPEC_GAMMA} --prefix_cache"
    with _served(torch, dev, ckpt_root, ["--speculative", "int8", "--gamma", str(SPEC_GAMMA),
                                         "--prefix_cache"]) as (engine, port):
        if not isinstance(engine, SpeculativeServingEngine) or not engine.prefix_cache:
            raise AssertionError(f"{label}: the command line built another engine")
        config = engine.config
        _check_completion(*_post(port, {"prompt": warm, "max_tokens": 2}), warm)
        _reset_paged_counts(engine)
        saved0 = engine.prefix_tokens_saved
        spec_prompts = prompts[:3]
        outs = []
        for q in spec_prompts:
            outs.append(_body(*_post(port, {"prompt": q, "max_tokens": FEATURE_MAX_TOKENS,
                                            **FEATURE_PEN}), label)["token_ids"])
        steps, stats = engine.macro_steps, dict(engine.last_stats)
        got = {"chunk": paged_attention_chunk.launches, "decode": paged_attention.launches}
        want = {"chunk": layers * steps, "decode": layers * engine.decode_steps}
        gap, match, total = check_penalized_against_plain(
            torch, engine.params, config, engine.plan, list(zip(spec_prompts, outs)), dev,
            FEATURE_PEN)
        print(f"{label}: {len(outs)} penalized greedy requests in turn, {steps} macro-steps "
              f"({engine.decode_seconds / max(steps, 1) * 1e3:.2f} ms each), drafts accepted "
              f"{stats['accepted']}/{stats['drafted']}, prefix tokens saved "
              f"{engine.prefix_tokens_saved - saved0}; K4/K3 {got} (want {want}); vs the "
              f"adjusted teacher-forced forward argmax agrees at {match}/{total}, max gap "
              f"{gap:.4f} (tol {GAP_TOL})")
        if (steps == 0 or got != want or gap > GAP_TOL
                or engine.decode_steps != (SPEC_GAMMA + 1) * steps
                or engine.prefix_tokens_saved - saved0 != 2 * FEATURE_PREFIX
                or not all(1 <= len(o) <= FEATURE_MAX_TOKENS for o in outs)):
            raise AssertionError(f"{label}: failed")
        launches["chunk"] += got["chunk"]
        launches["paged"] += got["decode"]

        # guided speculation through the engine API: two grammars in a batch
        tok = ByteTokenizer()
        api = SpeculativeServingEngine(engine.params, config, engine.dparams, config,
                                       plan=engine.plan, draft_plan=engine.dplan,
                                       gamma=SPEC_GAMMA, device=dev, num_pages=64,
                                       page_size=128, max_batch=4, max_pages_per_seq=4,
                                       eos_token_id=tok.eos_token_id, tokenizer=tok)
        pats = [FEATURE_REGEX, schema_regex(FEATURE_SCHEMA), FEATURE_REGEX]
        _reset_paged_counts(api)
        rids = [api.submit(tok.encode(f"Request {i}: ", add_special_tokens=True), 48,
                           guided_regex=pat, **(FEATURE_PEN if i == 2 else {}))
                for i, pat in enumerate(pats)]
        with torch.no_grad():
            done = {r.rid: r for r in _drain(api)}
        got = {"chunk": paged_attention_chunk.launches, "decode": paged_attention.launches}
        want = {"chunk": layers * api.macro_steps, "decode": layers * api.decode_steps}
        verdicts = []
        for rid, pat in zip(rids, pats):
            r = done[rid]
            choice = {"finish_reason": "stop" if r.finish == "eos" else "length",
                      "text": tok.decode(r.out)}
            verdicts.append(f"{choice['text']!r} ({_hold_guided(label, pat, choice, r.out)})")
        print(f"{label}, engine API, two grammars in one batch: {'; '.join(verdicts)}; "
              f"{api.macro_steps} macro-steps; K4/K3 {got} (want {want})")
        if got != want or api.macro_steps == 0:
            raise AssertionError(f"{label}: guided speculation ran the kernels other than counted")
        launches["chunk"] += got["chunk"]
        launches["paged"] += got["decode"]
        del api
    return launches


def _drain(engine):
    done = []
    while engine.has_work():
        engine.step()
        done += engine.collect_requests()
    return done


def serve_chunked(torch, card, dev, ckpt_root):
    """Phase 14 (b) on the checkpoint whose config sets use_pallas_lowrank:
    ``--prefill_chunk 256``, four short requests decoding when a 1500-token
    prompt arrives; then the same through an engine without chunks (the
    engine API) for the short rows' inter-token latency under whole-prompt
    admission. Returns the launches of K2 and K3."""
    import dataclasses

    import numpy as np

    from grasp_tpu_torch.ops.lowrank import FUSED_MIN_ROWS, fused_lowrank
    from grasp_tpu_torch.ops.paged_attention import paged_attention
    from grasp_tpu_torch.serving.paged import ServingEngine

    label = f"features (b) --prefill_chunk {PREFILL_CHUNK}"
    rng = np.random.default_rng(43)
    with _served(torch, dev, ckpt_root, ["--prefill_chunk", str(PREFILL_CHUNK)]) as (engine,
                                                                                       port):
        config, layers = engine.config, engine.config.num_hidden_layers
        if not config.use_pallas_lowrank or engine.prefill_chunk != PREFILL_CHUNK:
            raise AssertionError(f"{label}: not the fused checkpoint with chunks")
        n_lowrank = sum("in_kernel" in p for lp in engine.params["layers"]
                        for group in ("self_attn", "mlp") for p in lp[group].values())
        short = [rng.integers(3, config.vocab_size, size=n).tolist() for n in CHUNK_SHORT_LENS]
        long = rng.integers(3, config.vocab_size, size=CHUNK_LONG_LEN).tolist()
        # warm-up, not counted: a short prompt and one whose first chunk takes K2
        warm = rng.integers(3, config.vocab_size, size=300).tolist()
        for p in (short[0], warm):
            _check_completion(*_post(port, {"prompt": p, "max_tokens": 2}), p)

        def logged(eng):
            """Wrap eng.step to log (seconds, decode steps, admissions in flight)."""
            log, step = [], eng.step

            def timed():
                t0 = time.perf_counter()
                step()
                log.append((time.perf_counter() - t0, eng.decode_steps, bool(eng._admitting)))
            eng.step = timed
            return log

        def run_pattern(eng, submit, wait):
            """The four short rows, then the long prompt once they decode."""
            handles = [submit(p, CHUNK_MAX_TOKENS) for p in short]
            while eng.decode_steps < 3:
                wait()
            handles.append(submit(long, 8))
            return handles

        _reset_paged_counts(engine)
        fused_lowrank.launches = 0
        log = logged(engine)
        results = [None] * 5

        def post(i, p, n):
            results[i] = _post(port, {"prompt": p, "max_tokens": n})

        def submit(p, n):
            t = threading.Thread(target=post, args=(len(threads), p, n))
            threads.append(t)
            t.start()
            return t

        threads = []
        run_pattern(engine, submit, lambda: time.sleep(0.002))
        for t in threads:
            t.join(timeout=900)
        del engine.step
        outs = [_check_completion(s, d, p) for (s, d), p in zip(results, short + [long])]
        in_flight = [(secs, steps) for secs, steps, adm in log if adm]
        steady = [secs for secs, _, adm in log[-20:] if not adm]
        got = {"fused": fused_lowrank.launches, "paged": paged_attention.launches}
        ps = engine.pool.page_size
        rows = [-(-len(p) // ps) * ps for p in short + [long]]
        chunks = [min(PREFILL_CHUNK, r - f) for r in rows for f in range(0, r, PREFILL_CHUNK)]
        want = {"fused": n_lowrank * sum(c >= FUSED_MIN_ROWS for c in chunks),
                "paged": layers * engine.decode_steps}
        itl = [s * 1e3 for s, _ in in_flight]
        print(f"{label}: 4 rows of {list(CHUNK_SHORT_LENS)} tokens ({CHUNK_MAX_TOKENS} new) "
              f"decoding when a {CHUNK_LONG_LEN}-token prompt arrives: {len(in_flight)} decode "
              f"steps between its first chunk and its first token (want 5 or more); short "
              f"rows' inter-token latency during the admission {min(itl):.2f} to "
              f"{max(itl):.2f} ms (mean {sum(itl) / len(itl):.2f}), steady "
              f"{sum(steady) / len(steady) * 1e3:.2f} ms (host clock around engine.step); "
              f"card {card}")
        _hold_counts(label, got, want)
        if len(in_flight) < 5:
            raise AssertionError(f"{label}: the short rows waited for the long admission")
        plain_config = dataclasses.replace(config, use_pallas_lowrank=False)
        gap, match, total = check_against_plain(torch, engine.params, plain_config, engine.plan,
                                                list(zip(short + [long], outs)), dev)
        print(f"{label}: vs plain teacher-forced forward: argmax agrees at {match}/{total}, "
              f"max logit gap {gap:.4f} (tol {GAP_TOL})")
        if gap > GAP_TOL:
            raise AssertionError(f"{label}: served tokens disagree with the plain forward")
        launches = dict(got)

        # the same pattern with whole-prompt admission, through the engine API
        whole = ServingEngine(engine.params, config, engine.plan, device=dev, num_pages=256,
                              page_size=128, max_batch=8, max_pages_per_seq=16)
        _reset_paged_counts(whole)
        fused_lowrank.launches = paged_attention.launches = 0
        wlog = logged(whole)
        with torch.no_grad():
            run_pattern(whole, whole.submit, whole.step)
            whole.run()
        admit = [secs for secs, _, _ in wlog[3:4]]
        wsteady = [secs for secs, _, _ in wlog[5:25]]
        got = {"fused": fused_lowrank.launches, "paged": paged_attention.launches}
        want = {"fused": n_lowrank * sum(r >= FUSED_MIN_ROWS for r in rows),
                "paged": layers * whole.decode_steps}
        print(f"{label}, against whole-prompt admission (engine API): the short rows' "
              f"inter-token latency at the long prompt's admission {admit[0] * 1e3:.2f} ms, "
              f"steady {sum(wsteady) / len(wsteady) * 1e3:.2f} ms")
        _hold_counts(f"{label}, whole-prompt", got, want)
        del whole
        return {k: launches[k] + got[k] for k in launches}


def _set_fused(ckpt_root):
    """Set use_pallas_lowrank in the checkpoint's model config."""
    from grasp_tpu_torch.checkpoints import META_NAME

    meta_path = os.path.join(ckpt_root, META_NAME)
    with open(meta_path) as f:
        meta = json.load(f)
    meta["model_config"]["use_pallas_lowrank"] = True
    with open(meta_path, "w") as f:
        json.dump(meta, f)


def phase_features(torch, card, dev, ckpt_root):
    """Phase 14 on the serving checkpoint, (b) after setting
    use_pallas_lowrank in it. Returns the launches of K3, K4 and K2."""
    served = serve_features(torch, card, dev, ckpt_root)
    _set_fused(ckpt_root)
    chunked = serve_chunked(torch, card, dev, ckpt_root)
    return {"paged": served["paged"] + chunked["paged"], "chunk": served["chunk"],
            "fused": chunked["fused"]}


def phase_slice(torch, card, dev, only=None):
    """The serving slice, then the same checkpoint served with speculation
    and int8 KV pages, with int4 weights, int8 weights, the rest of the
    serving engine (phase 14) and the fused low-rank kernel. Returns the
    launches of the paged kernel on the main path, of the chunk and decode
    kernels under speculation, of the int4 and fused kernels on theirs, and
    of K2, K3 and K4 in phase 14. ``only``: "spec" the speculative and
    int8-KV parts alone, "features" phase 14 alone."""
    from grasp_tpu_torch.checkpoints import save_checkpoint
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
        if only == "features":
            return phase_features(torch, card, dev, ckpt_root)
        launches = None if only else _serve_main_path(torch, card, dev, ckpt_root, config, t0,
                                                      route="kernel")
        spec_launches = serve_speculative(torch, card, dev, ckpt_root, route="kernel")
        serve_quantized_kv(torch, dev, ckpt_root, speculative=False)
        serve_quantized_kv(torch, dev, ckpt_root, speculative=True)
        if only == "spec":
            return launches, spec_launches, None, None
        variants = {"int4": serve_variant(torch, dev, ckpt_root, "--quantize int4",
                                          ["--quantize", "int4"], dma_round=True, route="kernel"),
                    "int8": serve_variant(torch, dev, ckpt_root, "--quantize int8",
                                          ["--quantize", "int8"], route="kernel")}
        served = serve_features(torch, card, dev, ckpt_root)
        _set_fused(ckpt_root)
        variants["fused"] = serve_variant(torch, dev, ckpt_root, "use_pallas_lowrank",
                                          route="kernel")
        if variants["fused"]["fused"] == 0 or variants["int4"]["grid"] == 0:
            raise AssertionError("a serving variant never reached its kernel")
        chunked = serve_chunked(torch, card, dev, ckpt_root)
        features = {"paged": served["paged"] + chunked["paged"], "chunk": served["chunk"],
                    "fused": chunked["fused"]}
        return launches, spec_launches, variants, features
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)


def _route_layers(engine, config, want, route=None):
    """Layers whose attention launches a paged kernel in each step: all of
    them on the kernel route, none on the gather route. ``want`` is the
    route the caller expects for its model, pools and table, stated apart
    from the engine's rule (serving.paged.paged_route); ``route`` (default
    the engine's) must be it."""
    got = route or engine.route
    if got[0] != want:
        raise AssertionError(f"attention route {got}, where {want!r} was expected")
    return config.num_hidden_layers if want == "kernel" else 0


def _serve_main_path(torch, card, dev, ckpt_root, config, t0, tag="slice", extra=(), *,
                     route, then=None):
    """The served main path: one streamed completion of a 512-token prompt,
    then 8 concurrent completions of PROMPT_LENS and /v1/models; tokens
    against a teacher-forced plain forward, K3 launches against the decode
    steps and ``route``, the attention route expected (none on the gather
    route). ``tag`` starts each printed line; ``extra``: more server flags;
    ``then``, if given, is called with the engine before the server stops.
    Returns K3's launches."""
    import numpy as np

    from grasp_tpu_torch.ops.paged_attention import paged_attention

    with _served(torch, dev, ckpt_root, extra) as (engine, port):
        print(f"{tag}: checkpoint served on 127.0.0.1:{port} in "
              f"{time.perf_counter() - t0:.1f} s; attention route {engine.route[0]} "
              f"({engine.route[1]})")

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
        layers = _route_layers(engine, config, route)
        want = layers * steps
        print(f"{tag}: 1 streamed + {len(outs)} concurrent completions, tokens "
              f"{[len(stoks)] + [len(o) for o in outs]}; decode steps {steps}, kernel "
              f"launches {launches} (want {layers} x {steps} = {want})")
        if steps == 0 or launches != want:
            raise AssertionError("the decode path did not run the kernel once per layer per step")
        n_tok = sum(len(o) for o in outs)
        print(f"{tag}: TTFT (streamed, 512-token prompt, alone) {ttft * 1e3:.1f} ms; "
              f"8 concurrent requests: {n_tok} tokens in {wall:.3f} s = "
              f"{n_tok / wall:.1f} tok/s end to end; decode steps "
              f"{steps} in {engine.decode_seconds:.3f} s; card {card}")
        decode_tok = sum(len(o) for o in outs) + len(stoks)
        print(f"{tag}: decode-only rate {decode_tok / engine.decode_seconds:.1f} tok/s "
              f"(tokens of all 9 requests over host time inside decode steps)")

        bad, report = hold_to_plain(torch, engine.params, engine.config, engine.plan,
                                    [(stream_prompt, stoks)] + list(zip(prompts[:3], outs[:3])),
                                    dev)
        print(f"{tag}: served vs plain teacher-forced forward: {report}")
        if bad:
            raise AssertionError("served tokens disagree with the plain forward")
        if then is not None:
            then(engine)
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


def phase_compress(torch, card, dev, only=None):
    """``grasp-compress-torch`` on the card, sequential (its checkpoint then
    evaluated, phase_evaluate, and recovered, phase_recover) and parallel,
    then checks of what each saved and of the engine's run options at the
    same width. Returns the launch counts of the three flash kernels in the
    two runs, those of the fused low-rank kernel in its compressions, the
    evaluation's and the recovery's, and those of the HF route
    (compress_from_hf, on the sequential run's checkpoint). ``only``
    "evaluate", "recover" or "hf": the sequential run and that slice alone."""
    from grasp_tpu_torch.data.loader import get_calibration_batches
    from grasp_tpu_torch.data.tokenizer import load_tokenizer

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt_root = tempfile.mkdtemp(prefix="smoke_grasp_", dir=os.path.join(ROOT, "build"))
    par_root = tempfile.mkdtemp(prefix="smoke_parallel_", dir=os.path.join(ROOT, "build"))
    try:
        launches, _, summary = _compress_cli(torch, dev, ckpt_root, [], "compress", card)
        meta, config = _check_checkpoint(torch, ckpt_root, dev, "compress")
        if only == "recover":
            return phase_recover(torch, card, dev, ckpt_root, launches)
        if only == "hf":
            return compress_from_hf(torch, card, dev, ckpt_root, launches)
        evaluated = phase_evaluate(torch, card, dev, ckpt_root)
        if only == "evaluate":
            return evaluated
        recovered = phase_recover(torch, card, dev, ckpt_root, launches)
        from_hf = compress_from_hf(torch, card, dev, ckpt_root, launches)
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
        return flash_launches, fused, evaluated, recovered, from_hf
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
    """On TinyLlama-1.1B: one attention round's gradients by route
    (_route_gradients), then a sweep through every layer with and without
    remat."""
    from grasp_tpu_torch.core.engine import GraspEngine, module_name
    from grasp_tpu_torch.models.llama import ATTN_PROJS

    config, dense_params, batches = _smoke_model(dev)
    batches = batches[:2]
    _route_gradients(torch, dev, config, dense_params, batches, min(layers), "compress")

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
    del dense_params, remat_grads, engine
    torch.cuda.empty_cache()


def _route_gradients(torch, dev, config, dense_params, batches, layer, label):
    """One attention round at ``layer`` on the uncompressed model, so that
    the backward kernels take part: the summed gradients of the flash route
    and of the plain route (GRASP_FLASH_SWEEP=0), both in bf16, against the
    plain route in fp32, and the indices each bf16 route selects."""
    import dataclasses

    from grasp_tpu_torch import GraspConfig
    from grasp_tpu_torch.core.engine import GraspEngine, module_name
    from grasp_tpu_torch.models.convert import map_params
    from grasp_tpu_torch.models.llama import ATTN_PROJS

    names = [module_name(layer, proj) for proj in ATTN_PROJS]
    cfg = GraspConfig(compression_ratio=0.9)
    fp32 = (map_params(dense_params, lambda t: t.float()),
            dataclasses.replace(config, dtype="float32"))
    # an MoE model's bf16 routes take the experts that the fp32 route takes,
    # so that their gradients differ from it by rounding, not by experts
    # taken otherwise on near ties
    taken = []

    def record(logits, order, call):
        taken.append(order)
        return order

    def replay(logits, order, call):
        if call >= len(taken) or taken[call].shape != order.shape:
            raise AssertionError(f"{label}: router call {call} has no fp32 counterpart")
        return taken[call]

    engines, grads = {}, {}
    for route, env, (p, c), choose in (("fp32", "0", fp32, record),
                                       ("flash", "1", (dense_params, config), replay),
                                       ("plain", "0", (dense_params, config), replay)):
        os.environ["GRASP_FLASH_SWEEP"] = env
        engines[route] = GraspEngine(p, c, device=dev)
        engines[route]._maybe_enable_flash_sweep(batches)
        with _routed(torch, choose) as calls:
            grads[route] = engines[route].get_dense_gradients(names, batches)
        if calls[0] != len(taken):
            raise AssertionError(f"{label}: {route} route made {calls[0]} router calls, fp32 "
                                 f"{len(taken)}")
    del os.environ["GRASP_FLASH_SWEEP"], fp32
    if [engines[r].config.use_flash_attention for r in ("flash", "plain", "fp32")] != [
            True, False, False]:
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
    print(f"{label}: layer {layer} attention round over {len(batches)} rows, worst gradient error "
          f"over the reference gradient's max: flash route (bf16) against the plain route in "
          f"fp32 {err['flash']:.3e}, plain route (bf16) against it {err['plain']:.3e}, flash "
          f"against plain (both bf16) {between:.3e}; tolerance for the flash route: the "
          f"larger of {FLASH_SWEEP_RTOL:g} and {FLASH_SWEEP_SLACK:g} x the plain route's "
          f"error; selected indices in common {overlap}"
          + (f"; the bf16 routes take the fp32 route's experts ({len(taken)} router calls)"
             if taken else ""))
    if not err["flash"] <= max(FLASH_SWEEP_RTOL, FLASH_SWEEP_SLACK * err["plain"]):
        raise AssertionError(f"{label}: the flash route's gradients are further from the fp32 "
                             "reference than the plain route's")
    del engines, grads, svd_out
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


# the recovery slice (GRASP*): the compression's checkpoint fine-tuned on
# seed-made Alpaca rows, read by the ByteTokenizer at --max_length 512: 40
# validation rows (seed 42's split) and 40 micro-batches of 4, 10 optimizer
# steps of 16 rows
RECOVER_ROWS = 200
RECOVER_ARGS = ["--recovery", "--max_length", "512", "--micro_batch_size", "4",
                "--train_batch_size", "16", "--eval_every", "5", "--save_total_limit", "2"]
# the CLI run's learning rate: bf16 weights keep an update below half their
# ulp (2**-9 under 1.0), so at the default 3e-4 the norm weights (all 1.0)
# would never move; every other run keeps the default
RECOVER_CLI_LR = "1e-2"
RECOVER_ACCUM = 4
# a resumed run's losses against the uninterrupted run's (the tolerance of
# tests/test_recover_resume.py)
RESUME_RTOL = 1e-5
# fp32 losses on the card (TF32 off) against the same run on CPU tensors, at
# TinyLlama's width with 4 layers: the two compressed ones on top of two dense
CPU_RTOL = 1e-4
RECOVER_CPU_LAYERS = (0, 1, 20, 21)
RECOVER_CPU_MICRO = 17  # micro-batches of 2 rows of 128 tokens, accumulation 2


def _alpaca_rows(seed, n):
    """Seed-made Alpaca-format rows (instruction, input, output); every third
    row has an empty input (the no-input template)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = ("water stone light river cloud salt iron tree glass paper metal wind fire earth "
             "sound wave heat cold north south green blue small large").split()

    def text(k):
        return " ".join(rng.choice(words, k))

    return [{"instruction": text(int(rng.integers(4, 12))),
             "input": text(int(rng.integers(3, 20))) if i % 3 else "",
             "output": text(int(rng.integers(20, 60)))} for i in range(n)]


def _trained_tokens(batches):
    """Label positions that enter the loss (shifted, not -100)."""
    return int(sum((b["labels"][:, 1:] != -100).sum() for b in batches))


def _recover_run(torch, label, want_fused, *args, **kw):
    """recovery_train with the launch counts held (no flash launch: the
    batches carry a mask); returns (params, history, seconds, peak GiB)."""
    from grasp_tpu_torch.train.recover import recovery_train

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _eval_counts(reset=True)
    t0 = time.perf_counter()
    params, history = recovery_train(*args, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    _hold_eval_counts(f"recover, {label}", _eval_counts(), 0, want_fused)
    losses = [v for _, v in history["train_loss"]]
    if not losses or not all(map(math.isfinite, losses)):
        raise AssertionError(f"recover, {label}: losses {losses}")
    return params, history, wall, peak


def _recover_gradients(torch, params, configs, plan, layers, batch, n_lowrank):
    """The first micro-batch's loss and the gradients of every trainable leaf
    (both factors of each low-rank projection and both norms of the redundant
    layers), through K2 (its forward; its backward is plain products) and
    through plain products, both in bf16, held against plain products in fp32
    by the compression smoke's rule: each leaf's max |diff| over the fp32
    gradient's max, the worst leaf of K2 within the larger of FLASH_SWEEP_RTOL
    and FLASH_SWEEP_SLACK x the plain bf16 route's worst."""
    import dataclasses

    from grasp_tpu_torch.models.convert import map_params
    from grasp_tpu_torch.models.llama import forward, hf_causal_lm_loss
    from grasp_tpu_torch.train.recover import _leaf_paths, _value_and_grad

    dev = params["embed_tokens"]["weight"].device
    ids, labels, mask = (torch.as_tensor(batch[k], device=dev)
                         for k in ("input_ids", "labels", "attention_mask"))
    paths = [p for p, _ in _leaf_paths(params)
             if p.split(".")[:2] in [["layers", str(li)] for li in layers]]
    routes = {"fp32": (map_params(params, lambda t: t.float()),
                       dataclasses.replace(configs["plain"], dtype="float32")),
              "plain": (params, configs["plain"]), "K2": (params, configs["K2"])}
    got = {}
    for label, (p, cfg) in routes.items():
        _eval_counts(reset=True)
        got[label] = _value_and_grad(
            lambda tr, cfg=cfg: hf_causal_lm_loss(
                forward(tr, ids, config=cfg, plan=plan, attention_mask=mask)["logits"], labels),
            p, paths)
        torch.cuda.synchronize()
        _hold_eval_counts(f"recover, gradients {label}", _eval_counts(), 0,
                          n_lowrank if label == "K2" else 0)
    del routes
    ref = got["fp32"][1]

    def worst(label):
        return max(((got[label][1][q].float() - ref[q]).abs().max()
                    / ref[q].abs().max()).item() for q in paths)

    err = {label: worst(label) for label in ("plain", "K2")}
    tol = max(FLASH_SWEEP_RTOL, FLASH_SWEEP_SLACK * err["plain"])
    between = max(((got["K2"][1][q].float() - got["plain"][1][q].float()).abs().max()
                   / got["plain"][1][q].float().abs().max()).item() for q in paths)
    loss = {label: got[label][0].item() for label in got}
    print(f"recover: first micro-batch {tuple(ids.shape)} on {dev}, loss fp32 {loss['fp32']:.6f}"
          f", plain {loss['plain']:.6f}, K2 {loss['K2']:.6f}; {len(paths)} trainable leaves' "
          f"gradients, worst max |diff| over the fp32 gradient's max: plain (bf16) "
          f"{err['plain']:.3e}, K2 (bf16) {err['K2']:.3e} (tol {tol:.3e}, the larger of "
          f"{FLASH_SWEEP_RTOL:g} and {FLASH_SWEEP_SLACK:g} x plain's), K2 against plain "
          f"{between:.3e}")
    if (not all(map(math.isfinite, loss.values())) or abs(loss["K2"] - loss["plain"])
            > TOL["bfloat16"] or not err["K2"] <= tol):
        raise AssertionError("recover: the gradients through K2 left plain products'")
    del got, ref
    torch.cuda.empty_cache()


def phase_recover(torch, card, dev, ckpt_root, compress_launches):
    """The recovery slice on the compression's checkpoint (TinyLlama-1.1B,
    bf16, two layers low-rank): ``grasp-compress-torch --recovery`` (its
    trainer checkpoints, the recovered checkpoint, frozen leaves equal and
    trainable ones moved, the recovered model's perplexity), then
    ``recovery_train`` with the fused low-rank kernel (K2) against plain
    products (first loss within TOL; the first micro-batch's trainable
    gradients against an fp32 reference), timed in turns, under remat, killed and
    resumed from disk, and in fp32 on the card against the CPU. Every launch
    count is held to the dispatch rules; returns K2's launches in bf16."""
    import dataclasses

    import numpy as np

    from grasp_tpu_torch.checkpoints import load_checkpoint
    from grasp_tpu_torch.cli import _compress_parser, compress_main, recovery_batches
    from grasp_tpu_torch.data.loader import get_evaluation_corpus
    from grasp_tpu_torch.data.tokenizer import load_tokenizer
    from grasp_tpu_torch.eval.ppl import windowed_perplexity
    from grasp_tpu_torch.models.convert import flatten_params, map_params
    from grasp_tpu_torch.train.recover import latest_checkpoint, load_train_meta, recovery_train

    root = tempfile.mkdtemp(prefix="smoke_recover_", dir=os.path.join(ROOT, "build"))
    try:
        rows = _alpaca_rows(7, RECOVER_ROWS)
        data = os.path.join(root, "alpaca.json")
        with open(data, "w") as f:
            json.dump(rows, f)

        # 1. the CLI: compress (the same compression as phase_compress's), recover
        save = os.path.join(root, "ck")
        cli = COMPRESS_ARGS + RECOVER_ARGS + ["--learning_rate", RECOVER_CLI_LR]
        print(f"recover: grasp-compress-torch {' '.join(cli)} --data_path <{RECOVER_ROWS} "
              f"seed-made rows> --device {dev}")
        _eval_counts(reset=True)
        t0 = time.perf_counter()
        rc = compress_main(cli + ["--data_path", data, "--save_path", save, "--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _eval_counts()
        # the compression's sweeps launch the flash kernels as phase_compress's
        # run did; the recovery adds none (masked batches) and, on the saved
        # config, no fused low-rank launch
        want = {"fwd": compress_launches["fwd"], "dkv": compress_launches["dkv"],
                "dq": compress_launches["dq"], "fused": 0}
        print(f"recover, CLI: {wall:.1f} s with the compression and every save; launches {got} "
              f"(want {want}); card {card}")
        if rc != 0 or got != want:
            raise AssertionError("recover, CLI: failed or launched kernels off the rules")
        trainer = os.path.join(save + "_trainer")
        kept = sorted(os.listdir(trainer))
        meta = load_train_meta(latest_checkpoint(trainer))
        params, config, plan, ck_meta = load_checkpoint(save, dev)
        recovered, _, _, rec_meta = load_checkpoint(save + "_recovered", dev)
        history = rec_meta["extra"]["recovery_history"]
        layers = ck_meta["redundant_layers"]
        with open(os.path.join(ckpt_root, "grasp_meta.json")) as f:
            if json.load(f)["rank_dict"] != ck_meta["rank_dict"]:
                raise AssertionError("recover, CLI: another compression than phase_compress's")
        moved, frozen_equal = [], []
        base = flatten_params(params)
        for key, leaf in flatten_params(recovered).items():
            trained = key.split(".")[:2] in [["layers", str(li)] for li in layers]
            (moved if trained else frozen_equal).append(
                not torch.equal(leaf, base[key]) if trained else torch.equal(leaf, base[key]))
        corpus = get_evaluation_corpus("synthetic", load_tokenizer(None))
        ppl = windowed_perplexity(recovered, config, corpus, plan=plan)
        losses = [v for _, v in history["train_loss"] + history["eval_loss"]]
        print(f"recover, CLI: trainer checkpoints {kept} (optimizer step {meta['opt_step']}), "
              f"history {history}; {sum(moved)} of {len(moved)} trainable leaves moved, "
              f"{sum(frozen_equal)} of {len(frozen_equal)} frozen leaves torch.equal to the "
              f"compressed checkpoint's; the recovered checkpoint's synthetic PPL {ppl:.2f}")
        if (kept != ["step_20", "step_40"] or meta["opt_step"] != 10 or not moved
                or not all(moved) or not all(frozen_equal) or not math.isfinite(ppl)
                or not all(map(math.isfinite, losses)) or len(history["eval_loss"]) != 2):
            raise AssertionError("recover, CLI: the recovery did not run as asked")
        del params, recovered, base
        shutil.rmtree(save, ignore_errors=True)
        shutil.rmtree(save + "_recovered", ignore_errors=True)
        shutil.rmtree(trainer, ignore_errors=True)

        # 2. recovery_train on phase_compress's checkpoint, plain and through K2
        params, config, plan, ck_meta = load_checkpoint(ckpt_root, dev)
        layers = ck_meta["redundant_layers"]
        n_lowrank = sum(kind == "lowrank" for layer in plan for kind in layer)
        args = _compress_parser().parse_args(["--model_name_or_path", "x"] + RECOVER_ARGS)
        train, val = recovery_batches(rows, load_tokenizer(None), args)
        tokens = _trained_tokens(train)
        configs = {"plain": config,
                   "K2": dataclasses.replace(config, use_flash_attention=True,
                                             use_pallas_lowrank=True)}
        kw = dict(accum_steps=RECOVER_ACCUM, steps_per_epoch=len(train), log_every=1)
        steps = len(train) // RECOVER_ACCUM
        widths = sorted({b["input_ids"].shape[1] for b in train})
        print(f"recover: {len(train)} micro-batches of 4 rows of {widths[0]} to {widths[-1]} "
              f"tokens, {len(val)} validation batches, {steps} optimizer steps, {tokens} "
              f"trained tokens; {n_lowrank} low-rank projections in layers {layers}")
        fused = 0
        curves = {}
        for label, cfg in configs.items():
            want_k2 = n_lowrank * (len(train) + 2 * len(val)) if label == "K2" else 0
            _, history, _, _ = _recover_run(torch, f"{label} with evaluation", want_k2, params,
                                            cfg, plan, layers, train, val, eval_every=5, **kw)
            fused += want_k2
            curves[label] = [v for _, v in history["train_loss"]]
            print(f"recover, {label}: train losses {curves[label]}, eval {history['eval_loss']}")
        first_gap = abs(curves["K2"][0] - curves["plain"][0])
        print(f"recover: first loss (before any update) K2 {curves['K2'][0]:.6f}, plain "
              f"{curves['plain'][0]:.6f}, |diff| {first_gap:.3e} (tol {TOL['bfloat16']})")
        if len(curves["K2"]) != steps or first_gap > TOL["bfloat16"]:
            raise AssertionError("recover: the fused kernel's first loss left plain products'")
        _recover_gradients(torch, params, configs, plan, layers, train[0], n_lowrank)
        fused += n_lowrank

        # timed in turns, no evaluation
        timed = {"plain": [], "K2": []}
        uninterrupted = None
        for label in ("plain", "K2", "K2", "plain"):
            want_k2 = n_lowrank * len(train) if label == "K2" else 0
            _, history, wall, peak = _recover_run(torch, f"{label}, timed", want_k2, params,
                                                  configs[label], plan, layers, train, **kw)
            fused += want_k2
            timed[label].append((wall * 1e3 / steps, tokens / wall, peak))
            if label == "K2" and uninterrupted is None:
                uninterrupted = dict(history["train_loss"])
        for label, runs in timed.items():
            print(f"recover, {label}: ms per optimizer step "
                  f"{', '.join(f'{r[0]:.2f}' for r in runs)}; trained tokens a second "
                  f"{', '.join(f'{r[1]:.0f}' for r in runs)}; peak GiB "
                  f"{', '.join(f'{r[2]:.3f}' for r in runs)}; card {card}")

        # remat: each micro-batch recomputes the trainable layers' forward
        short = train[:2 * RECOVER_ACCUM]
        _, history, _, peak = _recover_run(torch, "K2 under remat", 2 * n_lowrank * len(short),
                                           params, configs["K2"], plan, layers, short,
                                           remat=True, **kw)
        fused += 2 * n_lowrank * len(short)
        remat_gap = max(abs(v - uninterrupted[s]) for s, v in history["train_loss"])
        print(f"recover, remat: losses {[v for _, v in history['train_loss']]} against "
              f"{[uninterrupted[s] for s, _ in history['train_loss']]} without, max |diff| "
              f"{remat_gap:.3e} (tol {TOL['bfloat16']}); peak {peak:.3f} GiB")
        if remat_gap > TOL["bfloat16"]:
            raise AssertionError("recover: remat changed the losses")

        # killed after its first save, resumed from disk
        out = os.path.join(root, "trainer")
        save_at = 4 * RECOVER_ACCUM  # optimizer step 4
        fed = save_at + 1
        _recover_run(torch, "K2 killed", n_lowrank * fed, params, configs["K2"], plan, layers,
                     train[:fed], output_dir=out, eval_every=4, save_total_limit=1, **kw)
        if not latest_checkpoint(out).endswith(f"step_{save_at}"):
            raise AssertionError(f"recover, resume: saved {os.listdir(out)}")
        _, history, _, _ = _recover_run(torch, "K2 resumed", n_lowrank * (len(train) - save_at),
                                        params, configs["K2"], plan, layers, train,
                                        output_dir=out, eval_every=4, save_total_limit=1,
                                        resume_from_checkpoint=out, **kw)
        fused += n_lowrank * (fed + len(train) - save_at)
        resumed = dict(history["train_loss"])
        after = [s for s in uninterrupted if s > save_at]
        equal = all(resumed[s] == uninterrupted[s] for s in after)
        worst = max(abs(resumed[s] / uninterrupted[s] - 1) for s in after)
        print(f"recover, resume: killed after micro-step {fed} (saved at {save_at}), resumed "
              f"from disk: losses after the save equal {equal}, max relative diff {worst:.3e} "
              f"(tol {RESUME_RTOL}) over {len(after)} optimizer steps")
        if sorted(resumed) != sorted(uninterrupted) or worst > RESUME_RTOL:
            raise AssertionError("recover: the resumed run left the uninterrupted curve")
        shutil.rmtree(out, ignore_errors=True)

        # fp32 on the card (TF32 off) against the same run on CPU tensors
        sub = {**params, "layers": [params["layers"][li] for li in RECOVER_CPU_LAYERS]}
        f32 = map_params(sub, lambda t: t.float())
        del params, sub
        cfg32 = dataclasses.replace(config, num_hidden_layers=len(RECOVER_CPU_LAYERS),
                                    dtype="float32", use_pallas_lowrank=True)
        plan4 = tuple(plan[li] for li in RECOVER_CPU_LAYERS)
        layers4 = [i for i, li in enumerate(RECOVER_CPU_LAYERS) if li in layers]
        args32 = _compress_parser().parse_args(
            ["--model_name_or_path", "x", "--max_length", "128", "--micro_batch_size", "2",
             "--train_on_inputs"])
        train32 = recovery_batches(rows, load_tokenizer(None), args32)[0][:RECOVER_CPU_MICRO]
        kw32 = dict(accum_steps=2, steps_per_epoch=len(train32), log_every=1, warmup_steps=2)
        n32 = sum(kind == "lowrank" for li in layers4 for kind in plan4[li])
        _, card_hist, card_wall, _ = _recover_run(torch, "fp32 on the card", n32 * len(train32),
                                                  f32, cfg32, plan4, layers4, train32, **kw32)
        t0 = time.perf_counter()
        _, cpu_hist = recovery_train(map_params(f32, lambda t: t.cpu()), cfg32, plan4, layers4,
                                     train32, **kw32)
        cpu_wall = time.perf_counter() - t0
        got32 = np.array([v for _, v in card_hist["train_loss"]])
        want32 = np.array([v for _, v in cpu_hist["train_loss"]])
        rel = float(np.max(np.abs(got32 / want32 - 1))) if len(got32) == len(want32) else math.inf
        print(f"recover, fp32 at TinyLlama width, layers {list(RECOVER_CPU_LAYERS)} "
              f"(trainable {layers4}), {len(train32)} micro-batches of 2 x 128, "
              f"{len(got32)} optimizer steps: card losses {got32.tolist()}, CPU "
              f"{want32.tolist()}, max relative diff {rel:.3e} (tol {CPU_RTOL}); "
              f"{card_wall:.1f} s on the card, {cpu_wall:.1f} s on the CPU")
        if len(got32) < 8 or rel > CPU_RTOL:
            raise AssertionError("recover: fp32 on the card left the CPU run")
        del f32
        torch.cuda.empty_cache()
        print(f"recover: fused low-rank launches {fused} in bf16 in the recovery slice")
        return {"fused": fused}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# HF checkpoint directories: the weights of a compression cell written as a
# public release ships them (bf16, two safetensors files), compressed by the
# CLI from there, exported and read back
HF_SHARDS = 2
PHI3_SEED = 42
# Phi-3-mini-4k's depth in the whole smoke (its time limit); --only phi3serve
# and --only hf run all 32 layers
PHI3_LAYERS = 4
PHI3_ARGS = ["--dataset_name", "synthetic", "--num_prune_layers", "2", "--compression_ratio",
             "0.9", "--num_samples", "16", "--seq_len", "2048", "--dtype", "bfloat16"]


def _free_disk(path, need, label):
    """Print ``df`` of the file system under ``path``; raise below ``need``
    bytes free."""
    df = subprocess.run(["df", "-h", path], capture_output=True, text=True).stdout
    free = shutil.disk_usage(path).free
    print(f"{label}: {df.strip().splitlines()[-1]} (df -h); {free / 1e9:.1f} GB free, "
          f"{need / 1e9:.1f} GB needed")
    if free < need:
        raise AssertionError(f"{label}: {free / 1e9:.1f} GB free under {path}, "
                             f"{need / 1e9:.1f} GB needed")


def _write_hf_dir(torch, params, config, path, model_type):
    """``params`` as an HF checkpoint directory in bf16: config.json from
    hf_config_dict and the state dict split over HF_SHARDS files by the
    port's safetensors writer (save_hf_checkpoint writes one file). Returns
    (seconds, bytes of weights)."""
    from grasp_tpu_torch.models.hf_io import (
        hf_config_dict,
        state_dict_from_params,
        write_safetensors,
    )

    t0 = time.perf_counter()
    os.makedirs(path)
    sd = state_dict_from_params(params, config, dtype=torch.bfloat16,
                                fuse_phi3=model_type == "phi3")
    keys = list(sd)
    step = -(-len(keys) // HF_SHARDS)
    for i in range(HF_SHARDS):
        part = {k: sd[k] for k in keys[i * step:(i + 1) * step]}
        write_safetensors(part, os.path.join(
            path, f"model-{i + 1:05d}-of-{HF_SHARDS:05d}.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config_dict(config, model_type), f, indent=2)
    nbytes = sum(t.numel() * t.element_size() for t in sd.values())
    del sd
    torch.cuda.empty_cache()
    return time.perf_counter() - t0, nbytes


def _same_tree(torch, got, want):
    """Leaves of ``got`` that are not torch.equal to ``want``'s (their
    dotted names), or the key sets' difference."""
    from grasp_tpu_torch.models.convert import flatten_params

    a, b = flatten_params(got), flatten_params(want)
    if a.keys() != b.keys():
        return sorted(set(a) ^ set(b))
    return [k for k in a if not torch.equal(a[k], b[k])]


def compress_from_hf(torch, card, dev, preset_root, preset_launches):
    """TinyLlama-1.1B through an HF directory: the compression cell's weights
    (the preset, bf16, the CLI's seed) written as an HF directory in two
    shards, ``grasp-compress-torch`` from it with ``--export_hf_dir``; the
    layers, ranks, plan, saved params and flash launches must equal the
    preset route's sequential run (``preset_root``: the same weights take the
    same ops), the fp32 export read back must be torch.equal to the merged
    params, and ``grasp-serve-torch`` serves the export (K3 once per layer
    per decode step, tokens against a teacher-forced plain forward). Returns
    the flash kernels' and K3's launches."""
    from grasp_tpu_torch.checkpoints import load_checkpoint
    from grasp_tpu_torch.cli import load_model
    from grasp_tpu_torch.models.hf_io import read_safetensors, state_dict_from_params

    root = tempfile.mkdtemp(prefix="smoke_hf_", dir=os.path.join(ROOT, "build"))
    try:
        hf_dir, ck, export = (os.path.join(root, name) for name in ("hf", "ck", "export"))
        config, params, _, _ = load_model("tinyllama-1.1b", device=dev, dtype="bfloat16", seed=42)
        _free_disk(root, 5 * _param_count(params) * 2, "compress, HF directory")
        secs, nbytes = _write_hf_dir(torch, params, config, hf_dir, "llama")
        del params
        print(f"compress, HF directory: TinyLlama-1.1B's preset weights (seed 42) written as "
              f"{HF_SHARDS} bf16 safetensors files, {nbytes} bytes in {secs:.2f} s")
        launches, _, summary = _compress_cli(
            torch, dev, ck, ["--model_name_or_path", hf_dir, "--export_hf_dir", export],
            "compress, HF directory", card)
        got, got_config, got_plan, got_meta = load_checkpoint(ck, dev)
        want, want_config, want_plan, want_meta = load_checkpoint(preset_root, dev)
        differ = _same_tree(torch, got, want)
        same = {"config": got_config == want_config, "plan": got_plan == want_plan,
                "layers": got_meta["redundant_layers"] == want_meta["redundant_layers"],
                "rank_dict": got_meta["rank_dict"] == want_meta["rank_dict"],
                "launches": launches == preset_launches, "params torch.equal": not differ}
        print(f"compress, HF directory against the preset route: {same}; flash launches "
              f"{launches}, prefix {summary['prefix']}")
        if not all(same.values()):
            raise AssertionError(f"compress, HF directory: differs from the preset route "
                                 f"({differ[:4]})")
        del got
        t0 = time.perf_counter()
        back = read_safetensors(os.path.join(export, "model.safetensors"))
        read_s = time.perf_counter() - t0
        merged = state_dict_from_params(want, want_config, merge=True)
        bad = sorted(set(back) ^ set(merged)) or [
            k for k in merged if not torch.equal(back[k], merged[k].cpu())]
        size = os.path.getsize(os.path.join(export, "model.safetensors"))
        print(f"compress, HF export: {size} bytes of fp32 (LlamaForCausalLM), read back in "
              f"{read_s:.2f} s; {len(merged)} tensors torch.equal to the merged params: "
              f"{not bad}")
        if bad:
            raise AssertionError(f"compress, HF export: {bad[:4]} differ from the merged params")
        del back, merged, want
        torch.cuda.empty_cache()
        served = serve_variant(torch, dev, export, "HF export", route="kernel")
        return {**launches, "paged": served["paged"]}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _sse(port, body, path):
    """A streamed request's chunks, up to [DONE]."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", path, json.dumps(dict(body, stream=True)),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    lines = [raw.decode().strip() for raw in resp if raw.startswith(b"data: ")]
    conn.close()
    if resp.status != 200 or not lines or lines[-1] != "data: [DONE]":
        raise AssertionError(f"stream {path}: HTTP {resp.status}, ended {lines[-1:]}")
    chunks = [json.loads(line[len("data: "):]) for line in lines[:-1]]
    if any("error" in c for c in chunks):
        raise AssertionError(f"stream {path}: {chunks[-1]}")
    return chunks


def serve_phi3_endpoints(torch, card, dev, export):
    """``grasp-serve-torch --chat_template phi3`` on the merged bf16 Phi-3
    export (no tokenizer file beside it: the byte-level tokenizer, which
    keeps transformers, and with it safetensors, out of the process): a chat
    completion unstreamed and streamed (the same tokens), n = 2 sampled with
    a seed (choice j equal to a single request at seed + j), logprobs = 5 on
    a greedy request (tokens unchanged, the chosen logprob the top-1 within
    1e-5), a stop string (finish "stop", the text ending before the match),
    and /metrics against what was served. Greedy tokens are held to a
    teacher-forced plain forward, K3's launches to 32 x decode steps. Returns
    K3's launches."""
    import numpy as np

    from grasp_tpu_torch.data.tokenizer import load_tokenizer
    from grasp_tpu_torch.ops.paged_attention import paged_attention
    from grasp_tpu_torch.serving.server import render_chat

    tok = load_tokenizer(export)
    rng = np.random.default_rng(31)

    def words(n):
        return " ".join(f"w{i}" for i in rng.integers(3, 32000, n))

    msgs = [{"role": "system", "content": words(12)}, {"role": "user", "content": words(60)}]
    prompt = render_chat(msgs, tok, "phi3")
    chat_path = "/v1/chat/completions"
    served, counted = [], {"requests": 0, "tokens": 0}

    def answer(status, data, n_choices=1):
        if status != 200:
            raise AssertionError(f"phi3 endpoints: HTTP {status}: {data[:300]!r}")
        body = json.loads(data)
        if len(body["choices"]) != n_choices:
            raise AssertionError(f"phi3 endpoints: {len(body['choices'])} choices")
        counted["requests"] += n_choices
        counted["tokens"] += body["usage"]["completion_tokens"]
        return body

    def ids(choice):
        return choice["message"]["token_ids"] if "message" in choice else choice["token_ids"]

    with _served(torch, dev, export, ["--chat_template", "phi3"]) as (engine, port):
        _reset_paged_counts(engine)
        chat = answer(*_post(port, {"messages": msgs, "max_tokens": 24}, path=chat_path))
        c0 = chat["choices"][0]
        chat_ids = ids(c0)
        ok = {"chat object": chat["object"] == "chat.completion"
              and c0["message"]["role"] == "assistant",
              "chat prompt tokens": chat["usage"]["prompt_tokens"] == len(prompt),
              "chat text": c0["message"]["content"] == tok.decode(chat_ids,
                                                                  skip_special_tokens=True)}
        served.append((prompt, chat_ids))

        chunks = _sse(port, {"messages": msgs, "max_tokens": 24}, chat_path)
        streamed = [t for c in chunks for t in c["choices"][0]["delta"].get("token_ids", [])]
        counted["requests"] += 1
        counted["tokens"] += len(streamed)
        ok["chat streamed"] = (streamed == chat_ids
                               and {c["object"] for c in chunks} == {"chat.completion.chunk"}
                               and chunks[-1]["choices"][0]["finish_reason"]
                               == c0["finish_reason"])

        kw = {"messages": msgs, "max_tokens": 16, "temperature": 0.8, "top_k": 40}
        pair = answer(*_post(port, dict(kw, n=2, seed=7), path=chat_path), n_choices=2)
        singles = [answer(*_post(port, dict(kw, seed=s), path=chat_path)) for s in (7, 8)]
        ok["n=2 choice j = seed + j"] = [ids(c) for c in pair["choices"]] == [
            ids(b["choices"][0]) for b in singles]

        greedy = answer(*_post(port, {"prompt": prompt, "max_tokens": 16}))
        lp = answer(*_post(port, {"prompt": prompt, "max_tokens": 16, "logprobs": 5}))
        block = lp["choices"][0]["logprobs"]
        gaps = [abs(chosen - max(top.values()))
                for chosen, top in zip(block["token_logprobs"], block["top_logprobs"])]
        worst_lp = max(gaps, default=math.inf)
        ok["logprobs"] = (ids(lp["choices"][0]) == ids(greedy["choices"][0])
                          and len(gaps) == len(ids(greedy["choices"][0]))
                          and all(len(top) <= 5 for top in block["top_logprobs"])
                          and worst_lp <= 1e-5)

        # the byte-level tokenizer decodes ids below 256 only: the stop string
        # is a character of the first of 16 greedy continuations of 64 tokens
        # whose text has one other than U+FFFD (a part of a multi-byte
        # character decodes to U+FFFD until the rest arrives)
        starts = [rng.integers(3, 32000, 40).tolist() for _ in range(16)]
        texts = answer(*_post(port, {"prompt": starts, "max_tokens": 64}), n_choices=16)
        found = [(p, c, [x for x in c["text"] if x != "\ufffd"])
                 for p, c in zip(starts, texts["choices"])]
        found = [f for f in found if f[2]]
        if not found:
            raise AssertionError("phi3 endpoints: no continuation decodes to a character")
        start, full, chars = found[0]
        served.append((start, full["token_ids"]))
        stop = chars[len(chars) // 2]
        cut = answer(*_post(port, {"prompt": start, "max_tokens": 64, "stop": [stop]}))
        cut = cut["choices"][0]
        ok["stop"] = (cut["finish_reason"] == "stop"
                      and cut["text"] == full["text"][:full["text"].find(stop)]
                      and stop not in cut["text"]
                      and full["token_ids"][:len(cut["token_ids"])] == cut["token_ids"])

        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        metrics = dict(line.split(" ", 1) for line in resp.read().decode().strip().splitlines())
        conn.close()
        ok["metrics"] = (resp.status == 200
                         and int(metrics["grasp_requests_total"]) == counted["requests"]
                         and int(metrics["grasp_completions_total"]) == counted["requests"]
                         and int(metrics["grasp_tokens_generated_total"]) == counted["tokens"]
                         and int(metrics["grasp_live_requests"]) == 0)
        launches, steps = paged_attention.launches, engine.decode_steps
        ok["K3 launches"] = steps > 0 and launches == engine.config.num_hidden_layers * steps
        gap, match, total = check_against_plain(torch, engine.params, engine.config, engine.plan,
                                                served, dev)
        ok["greedy tokens against the plain forward"] = gap <= GAP_TOL
        print(f"phi3 endpoints: --chat_template phi3 on the export, tokenizer "
              f"{type(tok).__name__}; chat of {len(prompt)} prompt tokens -> {len(chat_ids)} "
              f"tokens ({c0['finish_reason']}), streamed the same; n=2 at seed 7 "
              f"{[len(ids(c)) for c in pair['choices']]} tokens; logprobs=5: chosen against "
              f"top-1 max gap {worst_lp:.2e}; stop {stop!r}: {len(cut['token_ids'])} of "
              f"{len(full['token_ids'])} tokens, text cut at {len(cut['text'])} chars; /metrics "
              f"requests {metrics['grasp_requests_total']}, completions "
              f"{metrics['grasp_completions_total']}, tokens "
              f"{metrics['grasp_tokens_generated_total']} (served {counted}); K3 launches "
              f"{launches} = {engine.config.num_hidden_layers} x {steps} decode steps; greedy "
              f"tokens against the plain forward: argmax agrees at {match}/{total}, max logit gap "
              f"{gap:.4f} (tol {GAP_TOL}); card {card}")
        print(f"phi3 endpoints: {ok}")
        if not all(ok.values()):
            raise AssertionError(f"phi3 endpoints failed: {[k for k, v in ok.items() if not v]}")
    return launches


def phase_phi3(torch, card, dev, layers=None):
    """Phi-3-mini-4k (32 layers, hidden 3072, 32 heads of 96) at full width
    and depth through an HF directory: the preset's random weights (bf16,
    seed PHI3_SEED) written with fused qkv_proj / gate_up_proj in two shards,
    imported (every leaf torch.equal to the unfused weights), compressed by
    ``grasp-compress-torch`` with 16 rows of 2047 tokens through K1f, K1k and
    K1q at head_dim 96 (launches against the dispatch rules, ranks against
    preserve_rank, one round's gradients by route against fp32), exported
    merged in bf16 as a Phi-3 checkpoint, re-imported, and evaluated:
    ``windowed_perplexity`` over 8 windows of 2048 tokens with the flash
    route and the plain route, each window's mean CE within EVAL_CE_TOL.
    The compressed checkpoint is served by ``grasp-serve-torch`` before it
    is removed (K3 at head_dim 96, then ``--speculative int8 --gamma 4``
    through K4), and the export with ``--chat_template phi3``
    (serve_phi3_endpoints). Returns the flash kernels' launches and the
    paged kernels' ({"paged": K3, "chunk": K4})."""
    import dataclasses

    from grasp_tpu_torch import ModelConfig
    from grasp_tpu_torch.checkpoints import load_checkpoint
    from grasp_tpu_torch.cli import compress_main, load_model
    from grasp_tpu_torch.data.loader import get_calibration_batches, get_evaluation_corpus
    from grasp_tpu_torch.data.tokenizer import load_tokenizer
    from grasp_tpu_torch.eval.ppl import windowed_mean_ce, windowed_perplexity
    from grasp_tpu_torch.models.hf_io import load_hf_checkpoint, save_hf_checkpoint
    from grasp_tpu_torch.models.llama import init_params

    root = tempfile.mkdtemp(prefix="smoke_phi3_", dir=os.path.join(ROOT, "build"))
    total = {"fwd": 0, "dkv": 0, "dq": 0}

    def add(got):
        for name in total:
            total[name] += got[name]

    try:
        hf_dir, ck, export = (os.path.join(root, name) for name in ("hf", "ck", "export"))
        config = dataclasses.replace(ModelConfig.phi3_mini_4k(), dtype="bfloat16")
        if layers:  # the whole smoke's depth (its time limit); --only phi3serve|hf: 32
            config = dataclasses.replace(config, num_hidden_layers=layers)
        params = init_params(torch.Generator(device=dev).manual_seed(PHI3_SEED), config,
                             device=dev)
        # the input directory and the port checkpoint at once, then the
        # checkpoint and the export
        _free_disk(root, 2.5 * _param_count(params) * 2, "phi3")
        secs, nbytes = _write_hf_dir(torch, params, config, hf_dir, "phi3")
        print(f"phi3: Phi-3-mini-4k's preset weights (seed {PHI3_SEED}) written as {HF_SHARDS} "
              f"bf16 safetensors files with fused qkv_proj / gate_up_proj, {nbytes} bytes in "
              f"{secs:.2f} s; card {card}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got_config, got, got_plan, tokenizer = load_model(hf_dir, device=dev, dtype="bfloat16")
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
        differ = _same_tree(torch, got, params)
        print(f"phi3: imported in {import_s:.2f} s (tokenizer {type(tokenizer).__name__}); "
              f"config equal {got_config == config}, q/k/v split from qkv_proj, gate/up from "
              f"gate_up_proj and every other leaf torch.equal to the unfused weights: "
              f"{not differ}")
        if differ or got_config != config or got_plan != tuple(
                ("dense",) * 7 for _ in range(config.num_hidden_layers)):
            raise AssertionError(f"phi3: the import differs from the written weights "
                                 f"({differ[:4]})")
        del got

        cli = PHI3_ARGS + ["--model_name_or_path", hf_dir, "--save_path", ck, "--device",
                           str(dev)]
        print(f"phi3: grasp-compress-torch {' '.join(cli)}")
        launches = _eval_counts(reset=True)
        t0 = time.perf_counter()
        rc = compress_main(cli)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _eval_counts()
        if rc != 0:
            raise AssertionError(f"phi3: compress_main returned {rc}")
        shutil.rmtree(hf_dir)
        meta, _ = _check_checkpoint(torch, ck, dev, "phi3")
        summary = meta["extra"]["summary"]
        layers = meta["redundant_layers"]
        print(f"phi3: {wall:.1f} s end to end (summary {summary['wall_clock_s']:.2f} s), stage "
              f"seconds {summary['stage_times_s']}, prefix {summary['prefix']}; card {card}")
        batches = get_calibration_batches("synthetic", load_tokenizer(None), num_samples=16,
                                          seq_len=2048, seed=42)
        rounds = [(li, attn) for li in sorted(layers, reverse=True) for attn in (False, True)]
        want = _want_flash(config.num_hidden_layers, len(batches), rounds, min(layers),
                           summary["prefix"])
        _hold_launches("phi3", {k: launches[k] for k in total}, want)
        add(launches)
        _route_gradients(torch, dev, config, params, batches[:2], min(layers), "phi3")
        del params
        torch.cuda.empty_cache()

        # the compressed checkpoint served: decode through K3, then under
        # --speculative int8 the verify step through K4
        served = {"paged": _serve_main_path(torch, card, dev, ck, config, time.perf_counter(),
                                            tag="phi3 serve", route="kernel")}
        # agreement reported, not gated: the top logits of these random
        # weights lie within the served path's rounding of each other at many
        # positions, so two correct engines part early; each token is held to
        # the target's forward within GAP_TOL instead
        served["chunk"] = serve_speculative(torch, card, dev, ck, tag="phi3 serve",
                                            agreement=None, route="kernel")["chunk"]

        # the export: merged, fused, bf16; re-imported
        ck_params, ck_config, ck_plan, _ = load_checkpoint(ck, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_hf_checkpoint(ck_params, ck_config, export, merge=True, model_type="phi3",
                           dtype=torch.bfloat16)
        export_s = time.perf_counter() - t0
        shutil.rmtree(ck)
        t0 = time.perf_counter()
        ex_config, ex_params = load_hf_checkpoint(export, dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        reimport_s = time.perf_counter() - t0
        merged = dict(ck_params, layers=[
            {group: ({proj: ({"kernel": (p["in_kernel"].float() @ p["out_kernel"].float())
                              .bfloat16()} if "in_kernel" in p else p)
                      for proj, p in sub.items()} if group in ("self_attn", "mlp") else sub)
             for group, sub in layer.items()} for layer in ck_params["layers"]])
        differ = _same_tree(torch, ex_params, merged)
        size = os.path.getsize(os.path.join(export, "model.safetensors"))
        print(f"phi3: export (merged, fused, bf16) {size} bytes in {export_s:.2f} s, re-imported "
              f"in {reimport_s:.2f} s; every leaf torch.equal to the checkpoint's, low-rank "
              f"pairs to bf16(in_kernel @ out_kernel in fp32): {not differ}; card {card}")
        if differ:
            raise AssertionError(f"phi3: the re-imported export differs ({differ[:4]})")
        del ck_params, merged

        # perplexity of the export: flash route against plain, window by window
        ex_config = dataclasses.replace(ex_config, dtype="bfloat16")
        configs = {"plain": ex_config,
                   "flash": dataclasses.replace(ex_config, use_flash_attention=True)}
        corpus = get_evaluation_corpus("synthetic", load_tokenizer(None))
        ces, ppls, ms = {}, {}, {}
        for label, cfg in configs.items():
            _eval_counts(reset=True)
            ces[label] = windowed_mean_ce(ex_params, cfg, corpus)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ppls[label] = windowed_perplexity(ex_params, cfg, corpus)
            torch.cuda.synchronize()
            ms[label] = (time.perf_counter() - t0) * 1e3 / EVAL_WINDOWS
            got = _eval_counts()
            _hold_eval_counts(f"phi3, windowed_perplexity {label}", got,
                              0 if label == "plain" else 2 * config.num_hidden_layers
                              * EVAL_WINDOWS, 0)
            add(got)
            if len(ces[label]) != EVAL_WINDOWS or not all(map(math.isfinite, ces[label])):
                raise AssertionError(f"phi3: {label}: window CEs {ces[label]}")
        gap = float(max(abs(a - b) for a, b in zip(ces["flash"], ces["plain"])))
        print(f"phi3: synthetic PPL of the export plain {ppls['plain']:.4f}, flash "
              f"{ppls['flash']:.4f}; window mean CE max |diff| flash against plain {gap:.2e} "
              f"(tol {EVAL_CE_TOL}); PPL ms a window of 2048 tokens (B=1): plain "
              f"{ms['plain']:.3f}, flash {ms['flash']:.3f}; card {card}")
        if gap > EVAL_CE_TOL:
            raise AssertionError("phi3: the flash route's perplexity left the plain route's")
        del ex_params
        torch.cuda.empty_cache()
        served["paged"] += serve_phi3_endpoints(torch, card, dev, export)
        print(f"phi3: flash launches {total}, paged launches {served} in the Phi-3 slice")
        return total, served
    finally:
        shutil.rmtree(root, ignore_errors=True)


# of 32: about 6.3 GB in bf16 at full width, and as much again on disk (4
# layers until the whole smoke outgrew its time limit)
MIXTRAL_LAYERS = 2
MIXTRAL_SEED = 42
MIXTRAL_RATIO = 0.9
MIXTRAL_ROWS, MIXTRAL_ROWS_A_BATCH = 8, 2
MIXTRAL_ARGS = ["--dataset_name", "synthetic", "--num_prune_layers", "1", "--compression_ratio",
                str(MIXTRAL_RATIO), "--num_samples", str(MIXTRAL_ROWS), "--seq_len", "2048",
                "--batch_size", str(MIXTRAL_ROWS_A_BATCH), "--dtype", "bfloat16"]


def _check_mixtral_checkpoint(torch, ckpt_root, dev, label):
    """The saved compression of the MoE model: one layer; each attention
    projection and each stacked expert part at preserve_rank(in, out, ratio),
    one rank for all experts (w1_a [E, hidden, k], w1_b [E, k, intermediate]);
    the plan (the layer's attention low-rank, the expert slots dense-marked:
    the experts are keyed by name); fewer parameters; a finite forward.
    Returns (meta, config, dense parameter count, saved count)."""
    import numpy as np

    from grasp_tpu_torch.checkpoints import load_checkpoint
    from grasp_tpu_torch.core.engine import module_name
    from grasp_tpu_torch.models.llama import ATTN_PROJS, _proj_shapes, forward
    from grasp_tpu_torch.models.moe import MOE_PARTS
    from grasp_tpu_torch.ops.saliency import preserve_rank

    params, config, plan, meta = load_checkpoint(ckpt_root, dev)
    layers = meta["redundant_layers"]
    if len(layers) != 1 or not 0 <= layers[0] < config.num_hidden_layers:
        raise AssertionError(f"{label}: block influence chose {layers}, not one layer")
    (li,) = layers
    d, f, e = config.hidden_size, config.intermediate_size, config.num_local_experts
    shapes = dict(_proj_shapes(config), w1=(d, f), w3=(d, f), w2=(f, d))
    want_ranks = {module_name(li, p): preserve_rank(*shapes[p], MIXTRAL_RATIO)
                  for p in ATTN_PROJS + MOE_PARTS}
    if meta["rank_dict"] != want_ranks:
        raise AssertionError(f"{label}: rank_dict {meta['rank_dict']} != {want_ranks}")
    want_plan = tuple(("lowrank",) * 4 + ("dense",) * 3 if i == li else ("dense",) * 7
                      for i in range(config.num_hidden_layers))
    if plan != want_plan or any("mlp" in layer for layer in params["layers"]):
        raise AssertionError(f"{label}: plan {plan}")
    ex = params["layers"][li]["moe"]["experts"]
    for p in MOE_PARTS:
        in_f, out_f = shapes[p]
        k = want_ranks[module_name(li, p)]
        if (tuple(ex[p + "_a"].shape), tuple(ex[p + "_b"].shape)) != ((e, in_f, k), (e, k, out_f)):
            raise AssertionError(f"{label}: expert part {p}: factors of the wrong shape")
    per_layer = (sum(shapes[p][0] * shapes[p][1] for p in ATTN_PROJS) + 3 * e * d * f + d * e
                 + 2 * d)
    dense_count = per_layer * config.num_hidden_layers + d + 2 * config.vocab_size * d
    count = _param_count(params)
    if not count < dense_count:
        raise AssertionError(f"{label}: parameter count {count} did not fall below {dense_count}")
    with torch.no_grad():
        ids = torch.tensor(np.random.default_rng(5).integers(0, config.vocab_size, (1, 512)),
                           device=dev)
        logits = forward(params, ids, config=config, plan=plan)["logits"]
    if tuple(logits.shape) != (1, 512, config.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"{label}: the saved checkpoint's forward is not finite")
    print(f"{label}: layer {li}: attention ranks "
          f"{[want_ranks[module_name(li, p)] for p in ATTN_PROJS]}, expert parts w1_a "
          f"{list(ex['w1_a'].shape)}, w2_a {list(ex['w2_a'].shape)}, w3_b "
          f"{list(ex['w3_b'].shape)} (preserve_rank at {MIXTRAL_RATIO}); parameters "
          f"{dense_count} -> {count}; the saved checkpoint loads and its forward is finite")
    del params, logits
    torch.cuda.empty_cache()
    return meta, config, dense_count, count


def phase_mixtral(torch, card, dev):
    """Mixtral-8x7B at full width (hidden 4096, 8 experts of 14336 with top-2
    routing, 32 query heads over 8 KV heads of 128, vocab 32000), depth cut
    to MIXTRAL_LAYERS, through an HF directory: the preset's random weights
    (bf16, seed MIXTRAL_SEED) written as a ``model_type: mixtral`` directory
    with one tensor per expert, imported (every leaf torch.equal), and
    compressed by ``grasp-compress-torch`` (one layer, default targets: the
    MoE round and the attention round) with 8 rows of 2047 tokens, 2 a batch,
    through K1f, K1k and K1q at head_dim 128: launches against the dispatch
    rules, ranks against preserve_rank per expert part, the attention
    round's gradients by route against fp32 (K1k and K1q at head_dim 128),
    stage times and peak memory. The compressed checkpoint is served by
    ``grasp-serve-torch`` (K3, 4 launches a decode step; bf16 tokens held to
    the teacher-forced forward by hold_to_plain, whose router witness
    explains each token beyond GAP_TOL); then exported merged in bf16
    (low-rank experts do not quantize, in either package), re-imported, and
    the export served in fp32 (every token within GAP_TOL), with
    ``--speculative int8 --gamma 4`` (K4), ``--quantize int8`` and
    ``--quantize int4`` (K5, then K5d). Returns the flash kernels' launches
    and the paged and int4 kernels'."""
    import dataclasses

    from grasp_tpu_torch import ModelConfig
    from grasp_tpu_torch.checkpoints import load_checkpoint
    from grasp_tpu_torch.cli import compress_main, load_model
    from grasp_tpu_torch.data.loader import get_calibration_batches
    from grasp_tpu_torch.data.tokenizer import load_tokenizer
    from grasp_tpu_torch.models.convert import map_params
    from grasp_tpu_torch.models.hf_io import load_hf_checkpoint, save_hf_checkpoint
    from grasp_tpu_torch.models.llama import init_params
    from grasp_tpu_torch.models.moe import MOE_PARTS

    # engines and servers of the earlier phases hold the card's memory in
    # reference cycles until a full collection
    gc.collect()
    torch.cuda.empty_cache()
    print(f"mixtral: {torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB allocated on the card "
          f"before the phase")
    root = tempfile.mkdtemp(prefix="smoke_mixtral_", dir=os.path.join(ROOT, "build"))
    try:
        hf_dir, ck, export = (os.path.join(root, name) for name in ("hf", "ck", "export"))
        config = dataclasses.replace(ModelConfig.mixtral_8x7b(), num_hidden_layers=MIXTRAL_LAYERS,
                                     dtype="bfloat16")
        if config.head_dim_ != 128:
            raise AssertionError(f"mixtral: head_dim {config.head_dim_}")
        params = init_params(torch.Generator(device=dev).manual_seed(MIXTRAL_SEED), config,
                             device=dev)
        n_params = _param_count(params)
        # the input directory and the port checkpoint at once, then the
        # checkpoint and the export
        _free_disk(root, 2.2 * n_params * 2, "mixtral")
        secs, nbytes = _write_hf_dir(torch, params, config, hf_dir, "mixtral")
        print(f"mixtral: Mixtral-8x7B's preset weights at {MIXTRAL_LAYERS} layers (seed "
              f"{MIXTRAL_SEED}, {n_params} parameters) written as {HF_SHARDS} bf16 safetensors "
              f"files, one tensor per expert, {nbytes} bytes in {secs:.2f} s; card {card}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got_config, got, got_plan, tokenizer = load_model(hf_dir, device=dev, dtype="bfloat16")
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
        differ = _same_tree(torch, got, params)
        print(f"mixtral: imported in {import_s:.2f} s (tokenizer {type(tokenizer).__name__}); "
              f"config equal {got_config == config}, experts stacked [8, ...] and every leaf "
              f"torch.equal to the written weights: {not differ}")
        if differ or got_config != config or got_plan != tuple(
                ("dense",) * 7 for _ in range(config.num_hidden_layers)):
            raise AssertionError(f"mixtral: the import differs from the written weights "
                                 f"({differ[:4]})")
        del got
        # off the card while the CLI runs, so that the peak is the CLI's own
        params = map_params(params, lambda t: t.cpu())
        torch.cuda.empty_cache()

        cli = MIXTRAL_ARGS + ["--model_name_or_path", hf_dir, "--save_path", ck, "--device",
                              str(dev)]
        print(f"mixtral: grasp-compress-torch {' '.join(cli)}")
        torch.cuda.reset_peak_memory_stats(dev)
        launches = _eval_counts(reset=True)
        t0 = time.perf_counter()
        rc = compress_main(cli)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        launches = _eval_counts()
        if rc != 0:
            raise AssertionError(f"mixtral: compress_main returned {rc}")
        shutil.rmtree(hf_dir)
        meta, ck_config, dense_count, count = _check_mixtral_checkpoint(torch, ck, dev, "mixtral")
        summary = meta["extra"]["summary"]
        layers = meta["redundant_layers"]
        print(f"mixtral: {wall:.1f} s end to end (summary {summary['wall_clock_s']:.2f} s), "
              f"stage seconds {summary['stage_times_s']}, prefix {summary['prefix']}; peak "
              f"{peak / 2**30:.3f} GiB allocated on the card; card {card}")
        tok = load_tokenizer(None)
        batches = get_calibration_batches("synthetic", tok, num_samples=MIXTRAL_ROWS,
                                          seq_len=2048, batch_size=MIXTRAL_ROWS_A_BATCH, seed=42)
        rounds = [(li, attn) for li in sorted(layers, reverse=True) for attn in (False, True)]
        want = _want_flash(config.num_hidden_layers, len(batches), rounds, min(layers),
                           summary["prefix"])
        total = {k: launches[k] for k in ("fwd", "dkv", "dq")}
        _hold_launches("mixtral", total, want)
        del batches
        params = map_params(params, lambda t: t.to(dev))
        route_batches = get_calibration_batches("synthetic", tok, num_samples=2, seq_len=2048,
                                                seed=42)
        _route_gradients(torch, dev, config, params, route_batches, min(layers), "mixtral")
        del params
        torch.cuda.empty_cache()

        # the compressed checkpoint served: decode through K3
        served = {"paged": _serve_main_path(torch, card, dev, ck, ck_config, time.perf_counter(),
                                            tag="mixtral serve", route="kernel")}

        # the export: merged, bf16; re-imported
        ck_params, ck_config, _, _ = load_checkpoint(ck, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_hf_checkpoint(ck_params, ck_config, export, merge=True, model_type="mixtral",
                           dtype=torch.bfloat16)
        export_s = time.perf_counter() - t0
        shutil.rmtree(ck)
        t0 = time.perf_counter()
        ex_config, ex_params = load_hf_checkpoint(export, dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        reimport_s = time.perf_counter() - t0

        def merged_pair(a, b):
            return (a.float() @ b.float()).bfloat16()

        merged = dict(ck_params, layers=[])
        for layer in ck_params["layers"]:
            ex = layer["moe"]["experts"]
            merged["layers"].append(dict(
                layer,
                self_attn={proj: ({"kernel": merged_pair(p["in_kernel"], p["out_kernel"])}
                                  if "in_kernel" in p else p)
                           for proj, p in layer["self_attn"].items()},
                moe={"gate": layer["moe"]["gate"],
                     "experts": {w: (merged_pair(ex[w + "_a"], ex[w + "_b"]) if w + "_a" in ex
                                     else ex[w]) for w in MOE_PARTS}}))
        differ = _same_tree(torch, ex_params, merged)
        size = os.path.getsize(os.path.join(export, "model.safetensors"))
        print(f"mixtral: export (merged, bf16, model_type mixtral) {size} bytes in "
              f"{export_s:.2f} s, re-imported in {reimport_s:.2f} s; every leaf torch.equal to "
              f"the checkpoint's, low-rank pairs and stacked expert factors to bf16(a @ b in "
              f"fp32): {not differ}; num_local_experts {ex_config.num_local_experts}")
        if differ or ex_config.num_local_experts != config.num_local_experts:
            raise AssertionError(f"mixtral: the re-imported export differs ({differ[:4]})")
        del ck_params, merged, ex_params
        torch.cuda.empty_cache()

        # the export served in fp32 (K3's fp32 body), where the routing is
        # not left to rounding: every token within GAP_TOL of the
        # teacher-forced forward; then --speculative int8 (the verify step
        # through K4) and quantized (int8; int4 through K5, then K5d)
        served["paged"] += serve_variant(torch, dev, export, "mixtral export fp32",
                                         ["--dtype", "float32"], route="kernel")["paged"]
        served["chunk"] = serve_speculative(torch, card, dev, export, tag="mixtral export",
                                            agreement=None, route="kernel")["chunk"]
        int8 = serve_variant(torch, dev, export, "mixtral export --quantize int8",
                             ["--quantize", "int8"], route="kernel")
        int4 = serve_variant(torch, dev, export, "mixtral export --quantize int4",
                             ["--quantize", "int4"], dma_round=True, route="kernel")
        served["paged"] += int8["paged"] + int4["paged"]
        served["int4"] = {"grid": int4["grid"], "dma": int4["dma"]}
        print(f"mixtral: flash launches {total} at head_dim 128, paged and int4 launches "
              f"{served} in the Mixtral slice; parameters {dense_count} -> {count}")
        return total, served
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phase 16: the model families of P9 (Gemma-1, Mistral's window, Gemma-2),
# random weights from FAMILY_SEED written as an HF directory of each family
FAMILY_SEED = 42
# Mistral-7B runs at full depth (32 layers, 14.5 GB in bf16) under --only
# families; Gemma-2-9B's
# depth cut: 4 of 42 layers (2 sliding, 2 full)
GEMMA2_LAYERS = 4
# Mistral's window-covered table (32 pages of 128 = its window of 4096: the
# kernels) and the longer one (64 pages: the gather route), with one prompt of
# 6000 tokens and 256 new ones; Gemma-2's long prompt passes its window
MISTRAL_KERNEL_PAGES = 32
# Mistral-7B's depth in the whole smoke (its time limit; --only families runs 32)
MISTRAL_LAYERS = 4
MISTRAL_LONG = (64, 6000, 256)
GEMMA2_LONG = (40, 4500, 32)


def _want_family_flash(config, n_rows, rounds, prefix_layer, prefix, s=2047):
    """K1 launches of a run by the flash rule (models.llama.flash_layer_ok):
    every layer at a calibration length no window cuts, none under an
    attention softcap (Gemma-2)."""
    from grasp_tpu_torch.models.llama import flash_layer_ok

    ok = [flash_layer_ok(config, li, s, False) for li in range(config.num_hidden_layers)]
    if not any(ok):
        return 0, 0
    if not all(ok):
        raise AssertionError("a model whose layers take both routes is not counted here")
    return _want_flash(config.num_hidden_layers, n_rows, rounds, prefix_layer, prefix)


def _family_compressed(torch, card, dev, root, label, config, model_type):
    """The preset's random weights (bf16, FAMILY_SEED) written as an HF
    directory of ``model_type``, imported (every leaf torch.equal) and
    compressed by ``grasp-compress-torch`` with TinyLlama's flags (2 layers,
    ratio 0.9, 16 rows of 2047), K1's launches held to the flash rule.
    Returns (dense params on the host, checkpoint, meta, K1 launches)."""
    from grasp_tpu_torch.cli import compress_main, load_model
    from grasp_tpu_torch.data.loader import get_calibration_batches
    from grasp_tpu_torch.data.tokenizer import load_tokenizer
    from grasp_tpu_torch.models.convert import map_params
    from grasp_tpu_torch.models.llama import init_params

    hf_dir, ck = os.path.join(root, "hf"), os.path.join(root, "ck")
    params = init_params(torch.Generator(device=dev).manual_seed(FAMILY_SEED), config,
                         device=dev)
    n_params = _param_count(params)
    _free_disk(root, 2.5 * n_params * 2, label)
    secs, nbytes = _write_hf_dir(torch, params, config, hf_dir, model_type)
    print(f"{label}: the preset's weights ({config.num_hidden_layers} layers, hidden "
          f"{config.hidden_size}, {config.num_attention_heads} query heads over "
          f"{config.num_key_value_heads} of {config.head_dim_}, {n_params} parameters, seed "
          f"{FAMILY_SEED}) written as a model_type {model_type} directory, {nbytes} bytes in "
          f"{secs:.2f} s; card {card}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got_config, got, _, _ = load_model(hf_dir, device=dev, dtype="bfloat16")
    torch.cuda.synchronize()
    differ = _same_tree(torch, got, params)
    print(f"{label}: imported in {time.perf_counter() - t0:.2f} s; config equal "
          f"{got_config == config}, every leaf torch.equal: {not differ}")
    if differ or got_config != config:
        raise AssertionError(f"{label}: the import differs from the written weights")
    del got
    params = map_params(params, lambda t: t.cpu())  # the CLI's peak is its own
    torch.cuda.empty_cache()
    cli = PHI3_ARGS + ["--model_name_or_path", hf_dir, "--save_path", ck, "--device", str(dev)]
    print(f"{label}: grasp-compress-torch {' '.join(cli)}")
    torch.cuda.reset_peak_memory_stats(dev)
    _eval_counts(reset=True)
    t0 = time.perf_counter()
    if compress_main(cli) != 0:
        raise AssertionError(f"{label}: compress_main failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _eval_counts().items() if k != "fused"}
    shutil.rmtree(hf_dir)
    meta, _ = _check_checkpoint(torch, ck, dev, label)
    summary = meta["extra"]["summary"]
    layers = meta["redundant_layers"]
    print(f"{label}: compressed in {wall:.1f} s end to end (engine "
          f"{summary['wall_clock_s']:.2f} s), stage seconds {summary['stage_times_s']}, prefix "
          f"{summary['prefix']}, peak {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB; "
          f"card {card}")
    n_rows = len(get_calibration_batches("synthetic", load_tokenizer(None), num_samples=16,
                                         seq_len=2048, seed=42))
    rounds = [(li, attn) for li in sorted(layers, reverse=True) for attn in (False, True)]
    _hold_launches(label, launches, _want_family_flash(config, n_rows, rounds, min(layers),
                                                       summary["prefix"]))
    return params, ck, meta, launches


def _serve_long(torch, card, dev, label, params, config, plan, table_pages, prompt_len, new,
                live_bound=None, *, route):
    """One long request through a ServingEngine over a table of
    ``table_pages`` pages of 128, stepped here so that a windowed row's live
    pages are read after every step: at most ``live_bound`` once decoding
    starts. The tokens are held to a teacher-forced plain forward
    (hold_to_plain), K3 to ``route``, the attention route expected. Returns
    (tokens, the largest live page count while decoding)."""
    import numpy as np

    from grasp_tpu_torch.ops.paged_attention import paged_attention
    from grasp_tpu_torch.serving.paged import ServingEngine

    prompt = np.random.default_rng(31).integers(3, config.vocab_size, size=prompt_len).tolist()
    eng = ServingEngine(params, config, plan, device=dev, num_pages=2 * table_pages, page_size=128,
                        max_batch=1, max_pages_per_seq=table_pages)
    paged_attention.launches = 0
    rid = eng.submit(prompt, new)
    max_live, t0 = 0, time.perf_counter()
    with torch.no_grad():
        while eng.has_work():
            eng.step()
            r = eng._live[0]
            if r is not None and r.pos > prompt_len:
                max_live = max(max_live, sum(1 for p in r.pages if p > 0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = eng.collect()[rid]
    want_k3 = _route_layers(eng, config, route) * eng.decode_steps
    print(f"{label}: one prompt of {prompt_len} tokens, {len(out)} new, a table of "
          f"{table_pages} pages ({table_pages * 128} slots); route {eng.route[0]} "
          f"({eng.route[1]}); {eng.decode_steps} decode steps, "
          f"{eng.decode_seconds / max(eng.decode_steps, 1) * 1e3:.2f} ms each, {wall:.2f} s with "
          f"the prefill; K3 launches {paged_attention.launches} (want {want_k3}); live pages "
          f"while decoding at most {max_live} (bound {live_bound}); card {card}")
    if len(out) != new or paged_attention.launches != want_k3 or (
            live_bound is not None and not 0 < max_live <= live_bound):
        raise AssertionError(f"{label}: the long request broke the route or its pages")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    bad, report = hold_to_plain(torch, params, config, plan, [(prompt, out)], dev)
    print(f"{label}: served vs the teacher-forced windowed forward: {report}")
    if bad:
        raise AssertionError(f"{label}: served tokens disagree with the plain forward")
    return out, max_live


def phase_families(torch, card, dev, mistral_layers=None):
    """Phase 16: the families of P9 at full width, through HF directories of
    their ``model_type`` and the entry points.

    (a) Gemma-2B (18 layers, hidden 2048, 8 query heads over 1 kv head of
    256, vocab 256000, tied head): compressed with TinyLlama's flags through
    K1f, K1k and K1q at head_dim 256 (launches by the flash rule), one
    attention round's gradients by route against fp32, served through K3 at
    head_dim 256 (18 launches a decode step) plain and under ``--quantize
    int4``, exported merged in bf16, re-imported and its perplexity taken
    over windows of 2048 tokens, flash (K1f at hd 256) against plain.
    (b) Mistral-7B (32 layers, hidden 4096, 32 over 8 heads of 128, window
    4096): compressed (2047 <= 4096: K1 at hd 128); served in bf16 over a
    table its window covers (K3 a decode step a layer, K4 under
    ``--speculative int8``; with ``--quantized_kv`` K3's and K4's int8
    bodies at head_dim 128), the same requests over a table of 8192 slots
    (the gather route), and one prompt of 6000 tokens over that table (live
    pages bounded by the window); then its export served in fp32, the same
    requests through K3's fp32 body and the long row. bf16 tokens beyond
    GAP_TOL of the bf16 forward are held to its fp32 twin (hold_to_plain).
    ``mistral_layers``: Mistral's depth where the whole smoke cuts it.
    (c) Gemma-2-9B (GEMMA2_LAYERS layers, hidden 3584, 16 over 8 heads of 256,
    softcaps 50 and 30, query_pre_attn_scalar 256): compressed (no K1: the
    softcap), and one prompt longer than its window served plain and
    speculatively through the gather route.
    Returns the flash kernels' launches and the paged and int4 kernels'."""
    import dataclasses

    from grasp_tpu_torch import ModelConfig
    from grasp_tpu_torch.checkpoints import load_checkpoint
    from grasp_tpu_torch.data.loader import get_calibration_batches, get_evaluation_corpus
    from grasp_tpu_torch.data.tokenizer import load_tokenizer
    from grasp_tpu_torch.eval.ppl import windowed_mean_ce
    from grasp_tpu_torch.models.convert import map_params
    from grasp_tpu_torch.models.hf_io import load_hf_checkpoint, save_hf_checkpoint
    from grasp_tpu_torch.ops.paged_attention import paged_attention, paged_attention_chunk

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    gc.collect()
    torch.cuda.empty_cache()
    total = {"fwd": 0, "dkv": 0, "dq": 0}
    served = {"paged": 0, "chunk": 0, "int4": {"grid": 0, "dma": 0}}

    def add(got):
        for name in total:
            total[name] += got[name]

    def merged(ck_params):
        return dict(ck_params, layers=[
            {group: ({proj: ({"kernel": (p["in_kernel"].float() @ p["out_kernel"].float())
                              .bfloat16()} if "in_kernel" in p else p)
                      for proj, p in sub.items()} if group in ("self_attn", "mlp") else sub)
             for group, sub in layer.items()} for layer in ck_params["layers"]])

    # (a) Gemma-2B
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="smoke_gemma_", dir=os.path.join(ROOT, "build"))
    try:
        config = dataclasses.replace(ModelConfig.gemma_2b(), dtype="bfloat16")
        params, ck, meta, launches = _family_compressed(torch, card, dev, root, "gemma-2b",
                                                        config, "gemma")
        add(launches)
        batches = get_calibration_batches("synthetic", load_tokenizer(None), num_samples=2,
                                          seq_len=2048, seed=42)
        _route_gradients(torch, dev, config, map_params(params, lambda t: t.to(dev)), batches,
                         min(meta["redundant_layers"]), "gemma-2b")
        del params
        torch.cuda.empty_cache()
        served["paged"] += _serve_main_path(torch, card, dev, ck, config, time.perf_counter(),
                                            tag="gemma-2b serve", route="kernel")
        int4 = serve_variant(torch, dev, ck, "gemma-2b --quantize int4", ["--quantize", "int4"],
                             route="kernel")
        served["paged"] += int4["paged"]
        served["int4"] = {"grid": int4["grid"], "dma": int4["dma"]}
        ck_params, ck_config, _, _ = load_checkpoint(ck, dev)
        export = os.path.join(root, "export")
        t0 = time.perf_counter()
        save_hf_checkpoint(ck_params, ck_config, export, merge=True, model_type="gemma",
                           dtype=torch.bfloat16)
        export_s = time.perf_counter() - t0
        shutil.rmtree(ck)
        t0 = time.perf_counter()
        ex_config, ex_params = load_hf_checkpoint(export, dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        differ = _same_tree(torch, ex_params, merged(ck_params))
        print(f"gemma-2b: export (merged, bf16, model_type gemma, tied head) in {export_s:.2f} s, "
              f"re-imported in {time.perf_counter() - t0:.2f} s; every leaf torch.equal to the "
              f"checkpoint's merged: {not differ}; lm_head absent: {'lm_head' not in ex_params}")
        if differ or "lm_head" in ex_params:
            raise AssertionError("gemma-2b: the re-imported export differs")
        del ck_params
        ex_config = dataclasses.replace(ex_config, dtype="bfloat16")
        corpus = get_evaluation_corpus("synthetic", load_tokenizer(None))
        ces, ms = {}, {}
        for label, cfg in (("plain", ex_config),
                           ("flash", dataclasses.replace(ex_config, use_flash_attention=True))):
            _eval_counts(reset=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ces[label] = windowed_mean_ce(ex_params, cfg, corpus)
            torch.cuda.synchronize()
            ms[label] = (time.perf_counter() - t0) * 1e3 / EVAL_WINDOWS
            got = _eval_counts()
            _hold_eval_counts(f"gemma-2b, windowed perplexity {label}", got,
                              0 if label == "plain" else config.num_hidden_layers * EVAL_WINDOWS,
                              0)
            add(got)
        gap = float(max(abs(a - b) for a, b in zip(ces["flash"], ces["plain"])))
        ppl = {k: math.exp(sum(v) / len(v)) for k, v in ces.items()}
        print(f"gemma-2b: synthetic PPL of the export plain {ppl['plain']:.4f}, flash "
              f"{ppl['flash']:.4f} (K1f at head_dim 256); window mean CE max |diff| {gap:.2e} "
              f"(tol {EVAL_CE_TOL}); ms a window of 2048 tokens: plain {ms['plain']:.3f}, flash "
              f"{ms['flash']:.3f}; card {card}")
        if gap > EVAL_CE_TOL or not all(map(math.isfinite, ces["flash"] + ces["plain"])):
            raise AssertionError("gemma-2b: the flash route's perplexity left the plain route's")
        del ex_params
        print(f"gemma-2b: phase {time.perf_counter() - t_phase:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # (b) Mistral-7B
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="smoke_mistral_", dir=os.path.join(ROOT, "build"))
    try:
        config = dataclasses.replace(ModelConfig.mistral_7b(), dtype="bfloat16")
        if mistral_layers:  # the whole smoke's depth (its time limit); --only families: 32
            config = dataclasses.replace(config, num_hidden_layers=mistral_layers)
        params, ck, meta, launches = _family_compressed(torch, card, dev, root, "mistral-7b",
                                                        config, "mistral")
        add(launches)
        del params
        covered = ["--max_pages_per_seq", str(MISTRAL_KERNEL_PAGES)]
        pages, prompt_len, new = MISTRAL_LONG
        bound = -(-config.sliding_window // 128) + 2
        export = os.path.join(root, "export")

        def long_row(label):
            """The long row over the weights the server loaded (one load of
            the 14.5 GB, not two)."""
            return lambda engine: _serve_long(torch, card, dev, label, engine.params,
                                              engine.config, engine.plan, pages, prompt_len,
                                              new, live_bound=bound, route="gather")

        def long_row_and_export(engine):
            long_row("mistral-7b long, bf16")(engine)
            t0 = time.perf_counter()
            save_hf_checkpoint(engine.params, engine.config, export, merge=True,
                               model_type="mistral", dtype=torch.bfloat16)
            print(f"mistral-7b: export (merged, bf16) written in {time.perf_counter() - t0:.2f} s")

        # in bf16: through K3 over a table the window covers, then the long
        # row and the export; the same requests through the gather route over
        # a table the window does not cover; speculation through K4
        served["paged"] += _serve_main_path(torch, card, dev, ck, config, time.perf_counter(),
                                            tag="mistral-7b serve", extra=covered,
                                            route="kernel", then=long_row_and_export)
        _serve_main_path(torch, card, dev, ck, config, time.perf_counter(),
                         tag="mistral-7b serve, gather route",
                         extra=["--max_pages_per_seq", str(pages)], route="gather")
        spec = serve_speculative(torch, card, dev, ck, tag="mistral-7b serve", agreement=None,
                                 extra=covered, route="kernel")
        served["chunk"] += spec["chunk"]
        # int8 pages at head_dim 128: K3's and K4's int8 bodies
        for speculative in (False, True):
            q8 = serve_quantized_kv(torch, dev, ck, speculative, route="kernel", extra=covered,
                                    tag="mistral-7b serve")
            served["paged"] += q8["paged"]
            served["chunk"] += q8["chunk"]
        shutil.rmtree(ck)
        # the export served in fp32 (written in bf16: its 29 GB in fp32 took
        # 17 to 25 s to write and 42 to 55 to load on an H100's host): the
        # main path's requests through K3's fp32 body, every token within
        # GAP_TOL, then the long row
        served["paged"] += _serve_main_path(
            torch, card, dev, export, config, time.perf_counter(),
            tag="mistral-7b export fp32 serve", extra=covered + ["--dtype", "float32"],
            route="kernel", then=long_row("mistral-7b long, export in fp32"))
        print(f"mistral-7b: phase {time.perf_counter() - t_phase:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # (c) Gemma-2-9B
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="smoke_gemma2_", dir=os.path.join(ROOT, "build"))
    try:
        full = ModelConfig.gemma2_9b()
        config = dataclasses.replace(full, num_hidden_layers=GEMMA2_LAYERS, dtype="bfloat16",
                                     layer_types=full.layer_types[:GEMMA2_LAYERS])
        params, ck, meta, launches = _family_compressed(torch, card, dev, root, "gemma2-9b",
                                                        config, "gemma2")
        add(launches)
        del params
        ck_params, ck_config, ck_plan, _ = load_checkpoint(ck, dev)
        pages, prompt_len, new = GEMMA2_LONG
        plain_out, _ = _serve_long(torch, card, dev, "gemma2-9b long", ck_params, ck_config,
                                   ck_plan, pages, prompt_len, new, route="gather")
        del ck_params
        torch.cuda.empty_cache()
        # speculation through the server, the same prompt
        import numpy as np

        prompt = np.random.default_rng(31).integers(3, config.vocab_size,
                                                    size=prompt_len).tolist()
        with _served(torch, dev, ck, ["--speculative", "int8", "--gamma", str(SPEC_GAMMA),
                                      "--max_pages_per_seq", str(pages)]) as (engine, port):
            _reset_paged_counts(engine)
            out = _full_length([_post(port, {"prompt": prompt, "max_tokens": new})], [prompt],
                               new, "gemma2-9b --speculative")[0]
            steps = engine.macro_steps
            got = {"chunk": paged_attention_chunk.launches, "decode": paged_attention.launches}
            agree = sum(a == b for a, b in zip(out, plain_out))
            print(f"gemma2-9b --speculative int8 --gamma {SPEC_GAMMA}: routes verify "
                  f"{engine.route} draft {engine.draft_route[0]}; {steps} macro-steps, "
                  f"{engine.decode_seconds / max(steps, 1) * 1e3:.2f} ms each; launches {got} "
                  f"(want 0: the gather route); acceptance {engine.acceptance_rate:.3f}; "
                  f"agrees with the plain engine at {agree}/{new} positions; card {card}")
            if (steps == 0 or got != {"chunk": 0, "decode": 0} or engine.route[0] != "gather"
                    or engine.draft_route[0] != "gather"):
                raise AssertionError("gemma2-9b: speculation left the gather route")
            bad, report = hold_to_plain(torch, engine.params, engine.config, engine.plan,
                                        [(prompt, out)], dev)
            print(f"gemma2-9b --speculative: served vs the teacher-forced forward: {report}")
            if bad:
                raise AssertionError("gemma2-9b: speculative tokens disagree with the forward")
        print(f"gemma2-9b: phase {time.perf_counter() - t_phase:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"families: flash launches {total} (head_dim 256 in Gemma-2B, 128 in Mistral-7B, "
          f"none in Gemma-2-9B), paged launches {served}")
    return total, served


# phase 20: Gemma-7B served at full width; its depth in the whole smoke (the
# time limit: 4 of 28 layers, the last two low-rank); --only gemma7b runs all 28
GEMMA7B_LAYERS = 4
# its pools: 64 pages of 128 hold the main path's nine requests (51 pages) and
# keep the 16 MHA heads of 256 at 3.7 GB over 28 layers (256 pages: 15 GB,
# then twice under speculation beside the plain engine's and an fp32 twin)
GEMMA7B_SERVE = ["--num_pages", "64"]


def phase_gemma7b(torch, card, dev, layers=None):
    """Phase 20: Gemma-7B at full width (hidden 3072, 16 MHA heads of 256,
    intermediate 24576, vocab 256000, tied head; 28 layers, 8.5 B parameters,
    17 GB in bf16; random weights from a seed) with the serving slice's
    recipe (the last two layers' projections low-rank at ratio 0.9), saved as
    a port checkpoint and served by ``grasp-serve-torch``: the main path (1
    streamed and 8 concurrent requests) through K3 at head_dim 256 (a launch
    a layer a decode step), ``--quantized_kv`` through K3's int8 body at
    head_dim 256, and ``--speculative int8 --gamma 4`` through K4 at head_dim
    256 (a launch a layer a macro-step, the draft's decode through K3), every
    token held to the teacher-forced forward (hold_to_plain). ``layers``: the
    depth where the whole smoke cuts it. Returns K3's and K4's launches."""
    import dataclasses

    from grasp_tpu_torch import ModelConfig
    from grasp_tpu_torch.checkpoints import save_checkpoint
    from grasp_tpu_torch.models.convert import flatten_params

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    config = ModelConfig.gemma_7b()
    if layers:
        config = dataclasses.replace(config, num_hidden_layers=layers)
    config, params, plan = build_flagship(torch, dev, config)
    n_params = sum(t.numel() for t in flatten_params(params).values())
    print(f"gemma-7b: {config.num_hidden_layers} layers, hidden {config.hidden_size}, "
          f"{config.num_attention_heads} MHA heads of {config.head_dim_}, intermediate "
          f"{config.intermediate_size}, vocab {config.vocab_size}, low-rank layers "
          f"{[i for i, lp in enumerate(plan) if 'lowrank' in lp]}, {n_params} parameters in bf16;"
          f" card {card}")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_gemma7b_", dir=os.path.join(ROOT, "build"))
    try:
        _free_disk(root, 2.5 * n_params * 2, "gemma-7b")
        t0 = time.perf_counter()
        save_checkpoint(root, params, config, plan)
        print(f"gemma-7b: checkpoint written in {time.perf_counter() - t0:.1f} s")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        served = {"paged": _serve_main_path(torch, card, dev, root, config, time.perf_counter(),
                                            tag="gemma-7b serve", extra=GEMMA7B_SERVE,
                                            route="kernel"), "chunk": 0}
        q8 = serve_quantized_kv(torch, dev, root, False, route="kernel", extra=GEMMA7B_SERVE,
                                tag="gemma-7b serve")
        spec = serve_speculative(torch, card, dev, root, tag="gemma-7b serve", agreement=None,
                                 extra=GEMMA7B_SERVE, route="kernel")
        served["paged"] += q8["paged"] + spec["decode"]
        served["chunk"] += spec["chunk"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"gemma-7b: phase {time.perf_counter() - t_phase:.1f} s; paged launches {served}")
    return served


# phase 17, the device mesh: TinyLlama-1.1B compressed with phase_compress's
# flags on 2 x 2 ranks that share the card (gloo), two calibration rows a
# batch so that each data rank runs one; its single-process twin takes the
# same flags on one rank
MESH_SHAPE = (2, 2)
MESH_COMPRESS = ["--batch_size", "2"]
# the fp32 recovery on the mesh: its losses against one process's, relative
# (the sharded products sum in another order: measured 1e-7 at the CPU
# tests' size, tests/test_torch_parallel_train.py holds rtol 1e-5 there)
MESH_LOSS_RTOL = 1e-4
MESH_RECOVER_MICRO = 6  # micro-batches of 4 rows of up to 256 tokens, accumulation 2
MESH_PROMPT_LENS = (70, 130, 300, 600)
MESH_MAX_TOKENS = 16
MESH_TIMEOUT_S = 900


def _mesh_compress_rank(mesh, argv):
    """One rank of ``grasp-compress-torch --dp --tp`` (the CLI's rank
    function, which its launcher runs), with this rank's flash launches:
    the counters live in each rank's process and start at 0 there."""
    from grasp_tpu_torch.cli import _compress_parser, _compress_rank
    from grasp_tpu_torch.ops.flash_attention import flash_attention

    record = _compress_rank(mesh, _compress_parser().parse_args(argv), None)
    return {**record, "rank": mesh.rank, "flash": dict(flash_attention.launches)}


def _mesh_kernels_at_local_shapes(torch, dev):
    """K1f/K1k/K1q, K3 and K4 at a rank's shapes under --tp 2 (16 query
    heads over 2 KV heads of TinyLlama's 32 over 4) against their plain
    versions: returns the worst errors."""
    from grasp_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference
    from grasp_tpu_torch.ops.paged_attention import paged_attention, paged_attention_reference

    gen = torch.Generator(device=dev).manual_seed(1717)
    nh, nkv, hd = 16, 2, 64
    q, k, v = _flash_inputs(torch, gen, dev, torch.bfloat16, 1, nh, nkv, 2047, hd)
    got = _fwd_bwd(flash_attention, q, k, v, nh // nkv, hd ** -0.5)
    want = _fwd_bwd(flash_attention_reference, q, k, v, nh // nkv, hd ** -0.5)
    errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
    rel = [e / max(w.float().abs().max().item(), 1e-30) for e, w in zip(errs[1:], want[1:])]
    pq, pk, pv, lens, tables = _pages_case(torch, gen, dev, torch.bfloat16, 8, nh, nkv, hd, 128,
                                           16, 160, [70, 130, 300, 600, 1000, 1500, 2047, 0])
    paged = paged_attention(pq, pk[0], pv[0], lens, tables, hd ** -0.5)
    paged_err = (paged.float() - paged_attention_reference(
        pq, pk[0], pv[0], lens, tables, hd ** -0.5).float()).abs().max().item()
    cq = torch.randn(8, SPEC_GAMMA + 1, nh, hd, generator=gen, device=dev).bfloat16()
    chunk_err, unequal, _ = _chunk_compare(torch, cq, pk[0], pv[0], lens - 1, tables,
                                           hd ** -0.5)
    print(f"mesh: kernels at a rank's shapes (bf16, {nh} query heads over {nkv} KV heads of "
          f"{hd}): flash fwd max_abs_err {errs[0]:.3e} (tol {TOL['bfloat16']}), dq/dk/dv over "
          f"the plain gradient's max {[f'{r:.3e}' for r in rel]} (tol {FLASH_GRAD_RTOL}); paged "
          f"decode {paged_err:.3e}, chunk {chunk_err:.3e} (tol {TOL['bfloat16']}), chunk rows "
          f"unlike the decode kernel's {unequal}")
    if (errs[0] > TOL["bfloat16"] or max(rel) > FLASH_GRAD_RTOL or paged_err > TOL["bfloat16"]
            or chunk_err > TOL["bfloat16"] or unequal):
        raise AssertionError("mesh: a kernel disagrees with its plain version at a rank's shape")
    return {"fwd": errs[0], "dq": errs[1], "dkv": max(errs[2:]), "paged": paged_err,
            "chunk": chunk_err}


def _hold_selection(one, mesh):
    """The mesh run's selection against the single process's, module by
    module. The kept set must be equal, or each index kept by one run alone
    a near tie with one kept by the other alone: their saliencies in the
    single run no further apart than the largest saliency difference between
    the two runs on that matrix. Indices kept by both in another order keep
    the same singular directions (the factors' columns are permuted) and are
    counted. Returns (swaps across the boundary, order differences), printed."""
    import numpy as np

    swaps, reordered = [], 0
    if set(one["indices"]) != set(mesh["indices"]):
        raise AssertionError("mesh: another set of modules was selected")
    for name, want in one["indices"].items():
        got, want = np.asarray(mesh["indices"][name]), np.asarray(want)
        imp, imp_mesh = one["importances"][name], mesh["importances"][name]
        drift = float(np.abs(imp - imp_mesh).max())
        dropped = sorted(set(want.tolist()) - set(got.tolist()), key=lambda i: -imp[i])
        added = sorted(set(got.tolist()) - set(want.tolist()), key=lambda i: -imp[i])
        if not dropped:
            reordered += int((got != want).sum())
        for a, b in zip(dropped, added):
            gap = abs(float(imp[a] - imp[b]))
            swaps.append((name, a, b, gap, drift))
            print(f"mesh: near tie in {name}: {a} kept by the single run, {b} by the mesh, "
                  f"saliencies {gap:.3e} apart in the single run, the runs' largest "
                  f"difference {drift:.3e}")
            if gap > drift:
                raise AssertionError(f"mesh: {name}: {b} kept for {a}, beyond a near tie")
    print(f"mesh: selection: {len(swaps)} indices kept by one run alone (near ties), "
          f"{reordered} positions that hold another kept index (the same set, reordered)")
    return swaps, reordered


def phase_mesh(torch, card, dev):
    """Phase 17: the device mesh. The kernels at a rank's shapes; then
    TinyLlama-1.1B at full width and depth compressed by ``grasp-compress-torch
    --dp 2 --tp 2`` on four ranks that share the card (K1f, K1k, K1q on each
    rank's heads) against the same flags on one rank: layers, ranks, indices
    (near ties explained), each rank's flash launches as derived, the gathered
    checkpoint's dense tensors bit-equal; recovery in fp32 on the same mesh
    against one process (losses, replicated tensors bit-equal across ranks);
    TP-2 serving of the compressed checkpoint through the engine API (K3 per
    decode step, K4 per macro-step, on each rank), held to the single-process
    teacher-forced forward. Returns the kernels' errors and the launches
    summed over the ranks."""
    import dataclasses

    import numpy as np

    from grasp_tpu_torch.checkpoints import load_checkpoint
    from grasp_tpu_torch.cli import _compress_parser, compress_run, recovery_batches
    from grasp_tpu_torch.data.loader import get_calibration_batches
    from grasp_tpu_torch.data.tokenizer import load_tokenizer
    from grasp_tpu_torch.models.convert import flatten_params, map_params
    from grasp_tpu_torch.ops.flash_attention import flash_attention
    from grasp_tpu_torch.parallel import launch
    from grasp_tpu_torch.parallel.workers import run_cases
    from grasp_tpu_torch.train.recover import recovery_train

    t_phase = time.perf_counter()
    errs = _mesh_kernels_at_local_shapes(torch, dev)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_mesh_", dir=os.path.join(ROOT, "build"))
    try:
        argv = COMPRESS_ARGS + MESH_COMPRESS
        one_root, mesh_root = os.path.join(root, "one"), os.path.join(root, "mesh")
        for name in flash_attention.launches:
            flash_attention.launches[name] = 0
        t0 = time.perf_counter()
        one = compress_run(argv + ["--save_path", one_root, "--device", str(dev)])
        one_wall = time.perf_counter() - t0
        one_flash = dict(flash_attention.launches)
        torch.cuda.empty_cache()
        dp, tp = MESH_SHAPE
        print(f"mesh: grasp-compress-torch {' '.join(argv)} --dp {dp} --tp {tp} "
              f"(single-process twin: {one_wall:.1f} s, flash launches {one_flash})")
        t0 = time.perf_counter()
        ranks = launch(_mesh_compress_rank, dp, tp, argv + ["--save_path", mesh_root],
                       device="cuda", timeout_s=MESH_TIMEOUT_S)
        mesh_wall = time.perf_counter() - t0
        mesh = ranks[0]
        layers = one["summary"]["redundant_layers"]
        print(f"mesh: compression on {dp * tp} ranks in {mesh_wall:.1f} s (4 ranks share the "
              f"card; no speed-up is claimed), stage seconds of rank 0 "
              f"{mesh['summary']['stage_times_s']}, prefix {mesh['summary']['prefix']}; "
              f"layers {mesh['summary']['redundant_layers']} (single {layers}); card {card}")
        if (mesh["summary"]["redundant_layers"] != layers
                or mesh["summary"]["rank_dict"] != one["summary"]["rank_dict"]):
            raise AssertionError("mesh: layers or ranks differ from the single process's")
        swaps, _ = _hold_selection(one, mesh)
        got, config, plan, meta = load_checkpoint(mesh_root, "cpu")
        n_layers = config.num_hidden_layers
        n_batches = len(get_calibration_batches("synthetic", load_tokenizer(None),
                                                num_samples=16, seq_len=2048, seed=42,
                                                batch_size=2))
        rounds = [(li, attn) for li in sorted(layers, reverse=True) for attn in (False, True)]
        want = _want_flash(n_layers, n_batches, rounds, min(layers), mesh["summary"]["prefix"])
        for r in ranks:
            _hold_launches(f"mesh, rank {r['rank']}", r["flash"], want)
        if mesh["summary"]["prefix"] == one["summary"]["prefix"]:
            _hold_launches("mesh, single-process twin", one_flash, want)
        ref, _, ref_plan, ref_meta = load_checkpoint(one_root, "cpu")
        got, ref = flatten_params(got), flatten_params(ref)
        trained = [k for k in ref if k.split(".")[:2] in [["layers", str(li)] for li in layers]]
        dense_equal = all(torch.equal(got[k], ref[k]) for k in ref if k not in trained)
        factor_gap = max(float((got[k].float() - ref[k].float()).abs().max()) for k in trained)
        print(f"mesh: the gathered checkpoint: plan equal {plan == ref_plan}, "
              f"{len(ref) - len(trained)} dense tensors bit-equal {dense_equal}, "
              f"{len(trained)} factors of the two low-rank layers within "
              f"{factor_gap:.3e} of the single process's ({len(swaps)} near ties)")
        if plan != ref_plan or not dense_equal or got.keys() != ref.keys():
            raise AssertionError("mesh: the gathered checkpoint differs from the single one")
        del got, ref

        # recovery in fp32 and TP-2 serving, one launch of the same mesh
        rows = _alpaca_rows(7, 64)
        rargs = _compress_parser().parse_args(
            ["--model_name_or_path", "x", "--max_length", "256", "--micro_batch_size", "4",
             "--train_on_inputs"])
        train = recovery_batches(rows, load_tokenizer(None), rargs)[0][:MESH_RECOVER_MICRO]
        rkw = dict(accum_steps=2, steps_per_epoch=len(train), log_every=1, warmup_steps=0,
                   learning_rate=1e-3)
        rng = np.random.default_rng(17)
        prompts = [rng.integers(3, 32000, size=n).tolist() for n in MESH_PROMPT_LENS]
        cases = [("recover", "recover_run", dict(
                     params_np=one_root, config_json=None, plan=None, layers=layers,
                     train_batches=train, val_batches=None, kwargs=rkw, dtype="float32")),
                 ("serve", "serve_checkpoint", dict(path=one_root, prompts=prompts,
                                                     max_new=MESH_MAX_TOKENS,
                                                     gamma=SPEC_GAMMA))]
        t0 = time.perf_counter()
        out = launch(run_cases, dp, tp, cases, device="cuda", timeout_s=MESH_TIMEOUT_S)
        run_wall = time.perf_counter() - t0
        params, config, plan, _ = load_checkpoint(one_root, dev)
        f32 = map_params(params, lambda t: t.float())
        _, want_hist = recovery_train(f32, dataclasses.replace(config, dtype="float32"), plan,
                                      layers, train, **rkw)
        del f32
        torch.cuda.empty_cache()
        want_loss = np.array([v for _, v in want_hist["train_loss"]])
        worst, reps = 0.0, out[0]["recover"]["replicated"]
        for rank, r in enumerate(out):
            got_loss = np.array([v for _, v in r["recover"]["history"]["train_loss"]])
            if got_loss.shape != want_loss.shape:
                raise AssertionError("mesh: the recovery ran another number of steps")
            worst = max(worst, float(np.max(np.abs(got_loss / want_loss - 1))))
            if r["recover"]["replicated"].keys() != reps.keys() or not all(
                    np.array_equal(v, reps[k]) for k, v in r["recover"]["replicated"].items()):
                raise AssertionError(f"mesh: rank {rank}'s replicated tensors drifted")
        print(f"mesh: recovery in fp32 on {dp * tp} ranks, {len(train)} micro-batches of 4 rows, "
              f"{len(want_loss)} optimizer steps: losses "
              f"{[v for _, v in out[0]['recover']['history']['train_loss']]} against one "
              f"process's {want_loss.tolist()}, max relative diff {worst:.3e} (tol "
              f"{MESH_LOSS_RTOL}); {len(reps)} replicated tensors bit-equal on every rank")
        if worst > MESH_LOSS_RTOL:
            raise AssertionError("mesh: the recovery's losses left the single process's")

        n_route = config.num_hidden_layers
        launches = {"paged": 0, "chunk": 0}
        for rank, r in enumerate(out):
            srv = r["serve"]
            for label in ("plain", "speculative"):
                e = srv[label]
                want_dec = n_route * (e["decode_steps"])
                want_chunk = n_route * e["macro_steps"]
                if (e["decode"], e["chunk"]) != (want_dec, want_chunk) or e["route"] != "kernel" \
                        or e["pool_kv_heads"] != config.num_key_value_heads // tp:
                    raise AssertionError(f"mesh: rank {rank} {label}: launches "
                                         f"{(e['decode'], e['chunk'])} not {(want_dec, want_chunk)}"
                                         f" or the route {e['route']}")
                launches["paged"] += e["decode"]
                launches["chunk"] += e["chunk"]
                if e["streams"] != out[0]["serve"][label]["streams"]:
                    raise AssertionError(f"mesh: rank {rank} served other {label} tokens")
        for label in ("plain", "speculative"):
            e = out[0]["serve"][label]
            bad, report = hold_to_plain(torch, params, config, plan,
                                        list(zip(prompts, e["streams"])), dev)
            steps = e["macro_steps"] or e["decode_steps"]
            print(f"mesh: TP-{tp} serving, {label}: {len(prompts)} requests of "
                  f"{MESH_MAX_TOKENS} tokens in {e['seconds']:.2f} s ({e['decode_steps']} decode "
                  f"steps, {e['macro_steps']} macro-steps, "
                  f"{e['decode_seconds'] * 1e3 / max(steps, 1):.1f} ms a "
                  f"{'macro-step' if e['macro_steps'] else 'decode step'}; "
                  f"{n_route} K3 launches a decode step "
                  f"and {n_route} K4 a macro-step on each rank, {e['pool_kv_heads']} KV heads a "
                  f"rank's pool; 4 ranks share the card); tokens against the single-process "
                  f"teacher-forced forward: {report}")
            if bad:
                raise AssertionError(f"mesh: TP serving ({label}) left the plain forward")
        del params
        torch.cuda.empty_cache()
        # the mesh's ranks and the single-process twin, both the CLI's path
        flash = {k: one_flash[k] + sum(r["flash"][k] for r in ranks) for k in ("fwd", "dkv", "dq")}
        print(f"mesh: backend gloo, world {dp * tp}; per-rank launches: "
              f"{[(r['rank'], r['flash']) for r in ranks]} (K1f, K1k, K1q), "
              f"{[(i, r['serve']['plain']['decode'] + r['serve']['speculative']['decode'], r['serve']['speculative']['chunk']) for i, r in enumerate(out)]} "
              f"(K3, K4); recovery and serving launch {run_wall:.1f} s; phase "
              f"{time.perf_counter() - t_phase:.1f} s; card {card}")
        return errs, {**flash, **launches}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# Phase 18: ring attention, sequence parallelism, the pipeline and TP int4 /
# fused serving on ranks that share the card (gloo)
RING_SHAPE = (1, 32, 4, 8192, 64)  # TinyLlama's attention heads over 8192 tokens, 4 ranks
SEQ_LEN = 4096  # seq_parallel_logits: TinyLlama-1.1B at full depth over 4 ranks
SEQ_GRAD_LAYERS = 4  # the gradient check and the train step: the first 4 of 22 layers
SEQ_GRAD_RTOL = 1e-3  # fp32 gradients, max |diff| over the leaf's max |grad|
SEQ_LR = 1e-3
PIPE_STAGES, PIPE_MICRO, PIPE_ROWS = 2, 4, (4, 256)  # 4 microbatches of 1 row of 256 tokens
PIPE_LOSS_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
PIPE_GRAD_RTOL = 1e-3
SEQPIPE_PROMPT_LENS = (70, 130, 300, 600)
SEQPIPE_MAX_TOKENS = 16
SEQPIPE_TIMEOUT_S = 900


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _plain_attention(torch, q, k, v):
    """One rank's causal attention over the whole sequence, eight query
    heads at a time (the scores of all 32 at 8192 tokens take 8.6 GB)."""
    from grasp_tpu_torch.models.llama import _attention, _causal_mask

    groups = q.shape[1] // k.shape[1]
    mask = _causal_mask(q.shape[2], q.shape[2], 0, q.device)
    outs = []
    with torch.no_grad():
        for h0 in range(0, q.shape[1], 8):
            kv = slice(h0 // groups, (h0 + 8) // groups)
            outs.append(_attention(q[:, h0:h0 + 8], k[:, kv], v[:, kv], mask, groups))
    return torch.cat(outs, dim=1)


def _leaf_rel(torch, got, want):
    """max |got - want| over max |want| (0 for an all-zero want and got)."""
    d = (got.float() - want.float()).abs().max().item()
    m = want.float().abs().max().item()
    return d / m if m else d


def _seqpipe_ring_and_seq(mesh, ids_np, labels_np):
    """One rank of phase 18 (a) and (b) on a 4 x 1 mesh, the sequence over
    the data axis: ring attention at TinyLlama's heads over RING_SHAPE's
    8192 tokens in fp32 and bf16; seq_parallel_logits of TinyLlama-1.1B at
    full depth over SEQ_LEN tokens in fp32 and bf16; seq_parallel_loss and
    its gradients with remat and two train steps at SEQ_GRAD_LAYERS layers
    in fp32. Rank 0 holds each against one rank's plain run in its own
    process. Every kernel's launches over the sequence-parallel calls
    (none: JAX's sequence-parallel layer runs no Pallas kernel either)."""
    import dataclasses

    import numpy as np
    import torch

    from grasp_tpu_torch import ModelConfig
    from grasp_tpu_torch.models.convert import map_params
    from grasp_tpu_torch.models.llama import forward, hf_causal_lm_loss, init_params
    from grasp_tpu_torch.ops.flash_attention import flash_attention
    from grasp_tpu_torch.ops.lowrank import fused_lowrank
    from grasp_tpu_torch.parallel.ring_attention import context_parallel_attention
    from grasp_tpu_torch.parallel.seq_parallel import (make_seq_parallel_train_step,
                                                       seq_parallel_logits, seq_parallel_loss)
    from grasp_tpu_torch.train.recover import Optimizer, _leaf_paths, _value_and_grad

    dev, lead = mesh.device, mesh.rank == 0
    out = {"rank": mesh.rank, "launches": 0}

    def timed(fn):
        mesh.barrier()
        _sync(torch, dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            y = fn()
        _sync(torch, dev)
        return y, time.perf_counter() - t0

    def counted(fn):
        fused_lowrank.launches = 0
        for name in flash_attention.launches:
            flash_attention.launches[name] = 0
        y = fn()
        out["launches"] += fused_lowrank.launches + sum(flash_attention.launches.values())
        return y

    # (a) ring attention
    b, nh, nkv, s, hd = RING_SHAPE
    gen = torch.Generator(device=dev).manual_seed(1818)
    q, k, v = (torch.randn(b, n, s, hd, generator=gen, device=dev) for n in (nh, nkv, nkv))
    rings = {}
    for dt in ("float32", "bfloat16"):
        qd, kd, vd = (t.to(getattr(torch, dt)) for t in (q, k, v))
        rings[dt], out[f"ring_{dt}_s"] = counted(lambda: timed(
            lambda: context_parallel_attention(qd, kd, vd, mesh, num_kv_groups=nh // nkv)))
        if not lead:
            del rings[dt]
    if lead:
        want = _plain_attention(torch, q, k, v)
        want16 = _plain_attention(torch, *(t.bfloat16() for t in (q, k, v)))
        out["ring"] = {"fp32": (rings["float32"] - want).abs().max().item(),
                       "bf16": (rings["bfloat16"].float() - want).abs().max().item(),
                       "drift": (want16.float() - want).abs().max().item(),
                       "finite": all(torch.isfinite(t).all().item() for t in rings.values())}
        del want, want16
    del q, k, v, rings
    torch.cuda.empty_cache()

    # (b) sequence-parallel logits at full depth
    config = dataclasses.replace(ModelConfig.tinyllama_1_1b(), dtype="float32")
    params = init_params(torch.Generator(device=dev).manual_seed(18), config, device=dev)
    ids = torch.as_tensor(ids_np, device=dev)
    labels = torch.as_tensor(labels_np, device=dev)
    single32 = None
    for dt in ("float32", "bfloat16"):
        c = dataclasses.replace(config, dtype=dt)
        p = params if dt == "float32" else map_params(params, lambda t: t.bfloat16())
        logits, out[f"seq_{dt}_s"] = counted(lambda: timed(
            lambda: seq_parallel_logits(p, ids, mesh, c)))
        if lead:
            with torch.no_grad():
                single = forward(p, ids, config=c)["logits"].float()
            if single32 is None:
                single32 = single
            out[f"seq_{dt}"] = {"err": (logits.float() - single32).abs().max().item(),
                                "drift": (single - single32).abs().max().item(),
                                "finite": torch.isfinite(logits).all().item(),
                                "shape": tuple(logits.shape)}
            del single
        del logits, p
        torch.cuda.empty_cache()
    del single32

    # (b) the loss and its gradients with remat, then train steps, cut in depth
    gc_ = dataclasses.replace(config, num_hidden_layers=SEQ_GRAD_LAYERS)
    gp = {**params, "layers": params["layers"][:SEQ_GRAD_LAYERS]}
    del params
    paths = [p for p, _ in _leaf_paths(gp)]
    mesh.barrier()
    t0 = time.perf_counter()
    loss, grads = counted(lambda: _value_and_grad(
        lambda t: seq_parallel_loss(t, ids, labels, mesh, gc_, remat=True), gp, paths))
    _sync(torch, dev)
    out["grad_s"] = time.perf_counter() - t0
    out["loss"] = float(loss)
    if lead:
        want_loss, want = _value_and_grad(
            lambda t: hf_causal_lm_loss(forward(t, ids, config=gc_)["logits"], labels), gp, paths)
        out["grads"] = {"loss_rel": abs(float(loss) / float(want_loss) - 1),
                        "worst": max((_leaf_rel(torch, grads[p], want[p]), p) for p in paths),
                        "leaves": len(paths)}
        del want
    del grads
    torch.cuda.empty_cache()
    opt = Optimizer(lambda _: np.float32(SEQ_LR), clip=None)
    step = make_seq_parallel_train_step(gc_, None, opt, mesh, remat=True)
    state, losses = opt.init(gp), []
    for _ in range(2):
        gp, state, l_ = counted(lambda: step(gp, state, ids, labels))
        losses.append(float(l_))
    out["train_losses"] = losses
    return out


def _int4_products_tp(params, config, tp):
    """(group size, output width) of every int4 product a tensor-parallel
    rank's forward runs (models.llama._tp_proj_apply at this rank's
    shapes): column-parallel kernels and factors as held, a row-parallel
    kernel at the whole contraction's group size, the lm_head's columns."""
    from grasp_tpu_torch.parallel.mesh import COLUMN_PROJS, int4_in_features, proj_span

    def geometry(packed, scale):
        return 2 * packed.shape[0] // scale.shape[0], packed.shape[1]

    out = []
    for layer in params["layers"]:
        for group in ("self_attn", "mlp"):
            for name, p in layer.get(group, {}).items():
                col, (r0, r1) = name in COLUMN_PROJS, proj_span(name, config, tp)
                if "kernel_q4" in p:
                    packed, scale = p["kernel_q4"], p["kernel_scale"]
                    if col:
                        out.append(geometry(packed, scale))
                    else:
                        rows = int4_in_features(name, config) + 2 * packed.shape[0] - (r1 - r0)
                        out.append((rows // scale.shape[0], packed.shape[1]))
                if "in_kernel_q4" in p:
                    out.append(geometry(p["in_kernel_q4"], p["in_kernel_scale"]))
                    b, b_s = p["out_kernel_q4"], p["out_kernel_scale"]
                    out.append((geometry(b, b_s)[0], r1 - r0 if col else b.shape[1]))
    head = params.get("lm_head", {})
    if "kernel_q4" in head:
        out.append(geometry(head["kernel_q4"], head["kernel_scale"]))
    return out


def _seqpipe_pipe_and_serve(mesh, ckpt, prompts):
    """One rank of phase 18 (c) and (d) on a one-axis "pipe" mesh of
    PIPE_STAGES ranks: the smoke's compressed TinyLlama-1.1B hybridized and
    laid out in stages, its loss over PIPE_MICRO microbatches in bf16 with
    use_pallas_lowrank (K2) and with plain products, in fp32 with its
    gradients (against one rank's forward in this process, the rank's own
    stage and the replicated leaves) and one masked AdamW step; then, on a
    1 x 2 tensor-parallel mesh of the same ranks, ``ckpt`` served through
    the engine API with int4 weights (K5, then K5d under
    GRASP_INT4_KERNEL=dma; K3) and with use_pallas_lowrank (K2 in prefill).
    Each kernel's launches beside the count derived from its rule."""
    import dataclasses

    import numpy as np
    import torch

    from grasp_tpu_torch.checkpoints import load_checkpoint
    from grasp_tpu_torch.models.convert import flatten_params, map_params
    from grasp_tpu_torch.models.llama import (ATTN_PROJS, DENSE, PROJ_ORDER, forward,
                                              hf_causal_lm_loss)
    from grasp_tpu_torch.ops.int4_matmul import int4_matmul
    from grasp_tpu_torch.ops.lowrank import FUSED_MIN_ROWS, fused_lowrank, rank_chunks
    from grasp_tpu_torch.ops.paged_attention import paged_attention
    from grasp_tpu_torch.ops.quant import quantize_model_weights, takes_int4_kernel
    from grasp_tpu_torch.parallel.mesh import make_mesh, shard_params
    from grasp_tpu_torch.parallel.pipeline import (dehybridize_layers, hybrid_grad_mask,
                                                   hybridize_layers, make_pipeline_loss,
                                                   make_pp_train_step, shard_pipeline_params,
                                                   to_pipeline_params)
    from grasp_tpu_torch.serving.paged import ServingEngine
    from grasp_tpu_torch.train.recover import (Optimizer, _leaf_paths, _value_and_grad,
                                               _with_leaves)

    dev, lead = mesh.device, mesh.rank == 0
    stage = mesh.axis_index("pipe")
    out = {"rank": mesh.rank, "stage": stage}

    # (c) the pipeline
    config, params, plan = build_flagship(torch, dev)
    hp, layer_plan, spec = hybridize_layers(params, plan)
    if lead:
        back, orig = flatten_params(dehybridize_layers(hp, spec)), flatten_params(params)
        out["dehybridized_equal"] = back.keys() == orig.keys() and all(
            torch.equal(back[k], orig[k]) for k in orig)
    del params
    n_layers = config.num_hidden_layers
    depth = n_layers // PIPE_STAGES
    rng = np.random.default_rng(180)
    ids = torch.as_tensor(rng.integers(3, config.vocab_size, PIPE_ROWS), device=dev)
    labels = torch.as_tensor(rng.integers(3, config.vocab_size, PIPE_ROWS), device=dev)
    labels[:, :8] = -100
    rows = PIPE_ROWS[0] // PIPE_MICRO * PIPE_ROWS[1]
    pairs = [hp["layers"][0]["self_attn" if p in ATTN_PROJS else "mlp"][p] for p in PROJ_ORDER]
    per_forward = depth * sum(len(rank_chunks(m["in_kernel"].shape[1])) for m in pairs
                              if "in_kernel" in m) * (rows >= FUSED_MIN_ROWS)
    out["derived_k2"] = PIPE_MICRO * per_forward
    out["layer_plan"] = layer_plan
    k2 = dataclasses.replace(config, use_pallas_lowrank=True)
    pp = shard_pipeline_params(to_pipeline_params(hp, PIPE_STAGES), mesh)
    losses, launches = {}, {}
    for label, c in (("bf16_k2", k2), ("bf16_plain", config)):
        fused_lowrank.launches = 0
        losses[label] = float(make_pipeline_loss(c, layer_plan, mesh, PIPE_MICRO)(
            pp, ids, labels))
        launches[label] = fused_lowrank.launches
    del pp
    hp32 = map_params(hp, lambda t: t.float())
    del hp
    torch.cuda.empty_cache()
    c32 = dataclasses.replace(k2, dtype="float32")
    pp = shard_pipeline_params(to_pipeline_params(hp32, PIPE_STAGES), mesh)
    fused_lowrank.launches = 0
    mesh.barrier()
    t0 = time.perf_counter()
    loss32, grads = make_pipeline_loss(c32, layer_plan, mesh, PIPE_MICRO).value_and_grad(
        pp, ids, labels)
    _sync(torch, dev)
    out["grad_s"] = time.perf_counter() - t0
    launches["fp32_grads"] = fused_lowrank.launches
    losses["fp32"] = float(loss32)
    hplan = (layer_plan,) * n_layers
    lpaths = [p for p, _ in _leaf_paths(hp32)]
    want_loss, want = _value_and_grad(
        lambda t: hf_causal_lm_loss(forward(t, ids, config=c32, plan=hplan)["logits"], labels),
        hp32, lpaths)
    losses["fp32_one_rank"] = float(want_loss)
    local = flatten_params(shard_pipeline_params(
        to_pipeline_params(_with_leaves(hp32, lambda p, x: want[p]), PIPE_STAGES), mesh))
    del want
    got = flatten_params(grads)
    out["grads"] = {"worst": max((_leaf_rel(torch, got[p], local[p]), p) for p in local),
                    "leaves": len(local), "same_keys": got.keys() == local.keys()}
    del grads, got, local
    torch.cuda.empty_cache()
    opt = Optimizer(lambda _: np.float32(1e-3), clip=None, weight_decay=1e-4)
    mask = to_pipeline_params(hybrid_grad_mask(hp32, spec), PIPE_STAGES)
    step = make_pp_train_step(c32, layer_plan, opt, mesh, PIPE_MICRO, grad_mask=mask)
    fused_lowrank.launches = 0
    stepped, _, step_loss = step(pp, opt.init(pp), ids, labels)
    launches["step"] = fused_lowrank.launches
    losses["step"] = float(step_loss)
    zeros, moved = True, False
    for j in range(depth):
        for pi, (kind, r) in enumerate(spec[stage * depth + j]):
            proj = PROJ_ORDER[pi]
            grp = "self_attn" if proj in ATTN_PROJS else "mlp"
            new, old = stepped["stages"][grp][proj], pp["stages"][grp][proj]
            if kind == DENSE:
                zeros &= not new["in_kernel"][0, j].any() and not new["out_kernel"][0, j].any()
                moved |= not torch.equal(new["kernel"][0, j], old["kernel"][0, j])
            else:
                zeros &= not new["kernel"][0, j].any()
                zeros &= not new["in_kernel"][0, j][:, r:].any()
                zeros &= not new["out_kernel"][0, j][r:].any()
                moved |= not torch.equal(new["in_kernel"][0, j], old["in_kernel"][0, j])
    out["step_zeros_kept"], out["step_moved"] = bool(zeros), bool(moved)
    out["losses"], out["launches"] = losses, launches
    del pp, stepped, hp32, mask, opt
    torch.cuda.empty_cache()

    # (d) TP-2 serving of the checkpoint through the engine API
    tp = make_mesh((1, PIPE_STAGES), device=dev, timeout_s=SEQPIPE_TIMEOUT_S)
    params, config, plan, _ = load_checkpoint(ckpt, dev)
    q4 = shard_params(quantize_model_weights(params, bits=4), tp, config)
    local = shard_params(params, tp, config)
    kw = dict(device=dev, num_pages=256, page_size=128, max_batch=8, max_pages_per_seq=16,
              mesh=tp)
    serve = {}
    for label, weights, cfg, env in (
            ("int4", q4, config, None), ("int4_dma", q4, config, "dma"),
            ("fused", local, dataclasses.replace(config, use_pallas_lowrank=True), None)):
        if env:
            os.environ["GRASP_INT4_KERNEL"] = env
        try:
            eng = ServingEngine(weights, cfg, plan, **kw)
            int4_matmul.launches.update(grid=0, dma=0)
            paged_attention.launches = fused_lowrank.launches = 0
            rids = [eng.submit(p, SEQPIPE_MAX_TOKENS) for p in prompts]
            t0 = time.perf_counter()
            with torch.no_grad():
                res = eng.run()
            _sync(torch, dev)
            secs = time.perf_counter() - t0
        finally:
            os.environ.pop("GRASP_INT4_KERNEL", None)
        steps = eng.decode_steps
        got = {"grid": int4_matmul.launches["grid"], "dma": int4_matmul.launches["dma"],
               "paged": paged_attention.launches, "fused": fused_lowrank.launches}
        want = {"grid": 0, "dma": 0, "paged": config.num_hidden_layers * steps, "fused": 0}
        for gs, out_f in _int4_products_tp(weights, cfg, tp):
            if takes_int4_kernel(kw["max_batch"], gs):
                want["dma" if env == "dma" and out_f % 128 == 0 else "grid"] += steps
        if cfg.use_pallas_lowrank:
            n_pairs = sum("in_kernel" in p for layer in weights["layers"]
                          for group in ("self_attn", "mlp") for p in layer[group].values())
            want["fused"] = n_pairs * sum(-(-len(p) // kw["page_size"]) * kw["page_size"]
                                          >= FUSED_MIN_ROWS for p in prompts)
        serve[label] = {"streams": [res[r] for r in rids], "got": got, "want": want,
                        "steps": steps, "seconds": secs, "route": eng.route[0],
                        "decode_seconds": eng.decode_seconds}
        del eng
    out["serve"] = serve
    return out


def _seqpipe_kernels_at_local_shapes(torch, dev):
    """K2 at a TP-2 rank's shapes under use_pallas_lowrank (a column-parallel
    gate/up pair on its 2816 output columns, a row-parallel down pair on its
    2816 input rows; 256 rows, rank 150) and K5/K5d at a rank's decode
    shapes (q_proj's 1024 columns, down_proj's 2816 rows in 22 groups, the
    lm_head's 16000 columns; 8 rows), against their plain versions in fp32
    and bf16. Returns the worst absolute errors."""
    from grasp_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_plain
    from grasp_tpu_torch.ops.lowrank import fused_lowrank, fused_lowrank_plain

    gen = torch.Generator(device=dev).manual_seed(1819)
    worst = {"fused": 0.0, "grid": 0.0, "dma": 0.0}
    lines = []
    for m, k, r, n in ((256, 2048, 150, 2816), (256, 2816, 150, 2048)):
        for name in ("float32", "bfloat16"):
            dt = getattr(torch, name)
            x = torch.randn(m, k, generator=gen, device=dev).to(dt)
            a = (torch.randn(k, r, generator=gen, device=dev) * k ** -0.5).to(dt)
            b = (torch.randn(r, n, generator=gen, device=dev) * r ** -0.5).to(dt)
            with torch.no_grad():
                got, want = fused_lowrank(x, a, b), fused_lowrank_plain(x, a, b)
            rel = _rel_err(got, want)
            worst["fused"] = max(worst["fused"], (got.float() - want.float()).abs().max().item())
            lines.append(f"K2 {m}x{k}x{r}x{n} {name} {rel:.2e}")
            if rel > LOWRANK_RTOL[name]:
                raise AssertionError(f"seqpipe: K2 disagrees at a rank's shape {(m, k, r, n)}")
    for in_f, out_f in ((2048, 1024), (2816, 2048), (2048, 16000)):
        packed, scale = _int4_weight(torch, gen, dev, in_f, out_f)
        for name in ("float32", "bfloat16"):
            rtol, atol, atol_rel = INT4_TOL[name]
            x = torch.randn(8, in_f, generator=gen, device=dev).to(getattr(torch, name))
            want = int4_matmul_plain(x, packed, scale)
            bound = atol + atol_rel * want.float().abs().max().item() + rtol * want.float().abs()
            for variant in ("grid", "dma"):
                got = int4_matmul(x, packed, scale, kernel=variant)
                diff = (got.float() - want.float()).abs()
                worst[variant] = max(worst[variant], diff.max().item())
                if not bool((diff <= bound).all().item()):
                    raise AssertionError(f"seqpipe: int4 {variant} disagrees at a rank's shape "
                                         f"{(in_f, out_f)} {name}")
            lines.append(f"K5/K5d {in_f}x{out_f} {name} ok")
    print(f"seqpipe: kernels at a TP-2 rank's shapes against their plain versions: "
          f"{'; '.join(lines)}; worst abs {worst}")
    return worst


def phase_seqpipe(torch, card, dev):
    """Phase 18: the rest of parallel/ on ranks that share the card (gloo).
    (a) ring attention and (b) sequence parallelism on 4 ranks against one
    rank's plain run; (c) the pipeline of the smoke's compressed TinyLlama
    (hybridized, 2 stages of 11 layers, 4 microbatches of 256 rows) through
    K2, and (d) TP-2 serving with int4 weights (K5, K5d, K3) and with
    use_pallas_lowrank (K2 in prefill), on 2 ranks, held to the
    single-process teacher-forced forward. Returns the kernels' errors at a
    rank's shapes and the launches summed over the ranks."""
    import numpy as np

    from grasp_tpu_torch.checkpoints import load_checkpoint, save_checkpoint
    from grasp_tpu_torch.ops.quant import quantize_model_weights
    from grasp_tpu_torch.parallel import launch

    t_phase = time.perf_counter()
    errs = _seqpipe_kernels_at_local_shapes(torch, dev)
    rng = np.random.default_rng(18)
    ids = rng.integers(3, 32000, (1, SEQ_LEN))
    labels = rng.integers(3, 32000, (1, SEQ_LEN))
    labels[:, :16] = -100
    t0 = time.perf_counter()
    ranks = launch(_seqpipe_ring_and_seq, 4, 1, ids, labels, device="cuda",
                   timeout_s=SEQPIPE_TIMEOUT_S)
    lead = ranks[0]
    ring, tol_bf16 = lead["ring"], max(TOL["bfloat16"], lead["ring"]["drift"])
    print(f"seqpipe (a): ring attention, {RING_SHAPE[1]} query heads over {RING_SHAPE[2]} KV "
          f"heads of {RING_SHAPE[4]}, {RING_SHAPE[3]} tokens over 4 ranks, against one rank's "
          f"plain attention in fp32: fp32 max abs {ring['fp32']:.3e} (tol {TOL['float32']}), "
          f"bf16 {ring['bf16']:.3e} (tol {tol_bf16:.3e}: the larger of {TOL['bfloat16']} and "
          f"the plain bf16 attention's own drift {ring['drift']:.3e}); seconds a call (rank 0) "
          f"fp32 {lead['ring_float32_s']:.3f}, bf16 {lead['ring_bfloat16_s']:.3f}")
    if not ring["finite"] or ring["fp32"] > TOL["float32"] or ring["bf16"] > tol_bf16:
        raise AssertionError("seqpipe: ring attention disagrees with the plain attention")
    for dt in ("float32", "bfloat16"):
        sp = lead[f"seq_{dt}"]
        tol = TOL[dt] if dt == "float32" else max(TOL[dt], 2 * sp["drift"])
        print(f"seqpipe (b): seq_parallel_logits of TinyLlama-1.1B (22 layers) over "
              f"{SEQ_LEN} tokens on 4 ranks, {dt}: logits {sp['shape']} against one rank's "
              f"fp32 forward max abs {sp['err']:.3e} (tol {tol:.3e}"
              + ("" if dt == "float32" else f": the larger of {TOL[dt]} and twice one rank's "
                 f"bf16 forward's drift {sp['drift']:.3e}") + f"), {lead[f'seq_{dt}_s']:.2f} s")
        if not sp["finite"] or sp["err"] > tol or sp["shape"] != (1, SEQ_LEN, 32000):
            raise AssertionError(f"seqpipe: seq_parallel_logits ({dt}) left the forward")
    g = lead["grads"]
    train = [r["train_losses"] for r in ranks]
    print(f"seqpipe (b): seq_parallel_loss with remat at {SEQ_GRAD_LAYERS} of 22 layers (the "
          f"gradients' traffic through the host), fp32: loss {lead['loss']:.6f}, relative to "
          f"one rank's {g['loss_rel']:.2e} (tol {MESH_LOSS_RTOL}); {g['leaves']} gradients, "
          f"worst max|diff| over max|grad| {g['worst'][0]:.2e} at {g['worst'][1]} (tol "
          f"{SEQ_GRAD_RTOL}), {lead['grad_s']:.2f} s; two train steps (Adam {SEQ_LR}): losses "
          f"{train[0]}, equal on every rank {all(t == train[0] for t in train)}; kernel "
          f"launches on the sequence-parallel calls {[r['launches'] for r in ranks]} (none, "
          f"as in JAX); launch {time.perf_counter() - t0:.1f} s")
    if (g["loss_rel"] > MESH_LOSS_RTOL or g["worst"][0] > SEQ_GRAD_RTOL
            or any(t != train[0] for t in train) or not train[0][1] < train[0][0]
            or any(r["launches"] for r in ranks)):
        raise AssertionError("seqpipe: sequence-parallel loss, gradients or steps failed")

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_seqpipe_", dir=os.path.join(ROOT, "build"))
    try:
        config, params, plan = build_flagship(torch, dev)
        save_checkpoint(root, params, config, plan)
        del params
        torch.cuda.empty_cache()
        prng = np.random.default_rng(1800)
        prompts = [prng.integers(3, 32000, size=n).tolist() for n in SEQPIPE_PROMPT_LENS]
        t0 = time.perf_counter()
        ranks = launch(_seqpipe_pipe_and_serve, PIPE_STAGES, 1, root, prompts, device="cuda",
                       timeout_s=SEQPIPE_TIMEOUT_S, axis_names=("pipe",))
        wall = time.perf_counter() - t0
        lead = ranks[0]
        launches = {"fused": 0, "paged": 0, "grid": 0, "dma": 0}
        for r in ranks:
            ls, la = r["losses"], r["launches"]
            rel16 = abs(ls["bf16_k2"] / ls["bf16_plain"] - 1)
            rel32 = abs(ls["fp32"] / ls["fp32_one_rank"] - 1)
            print(f"seqpipe (c), stage {r['stage']}: layer plan {r['layer_plan']}; loss bf16 "
                  f"through K2 {ls['bf16_k2']:.6f} against the plain products "
                  f"{ls['bf16_plain']:.6f} (relative {rel16:.2e}, tol "
                  f"{PIPE_LOSS_RTOL['bfloat16']}); fp32 {ls['fp32']:.6f} against one rank's "
                  f"{ls['fp32_one_rank']:.6f} ({rel32:.2e}, tol {PIPE_LOSS_RTOL['float32']}); "
                  f"{r['grads']['leaves']} gradients of its part, worst "
                  f"{r['grads']['worst'][0]:.2e} at {r['grads']['worst'][1]} (tol "
                  f"{PIPE_GRAD_RTOL}), {r['grad_s']:.2f} s; "
                  f"masked AdamW step: loss {ls['step']:.6f}, structural zeros kept "
                  f"{r['step_zeros_kept']}, params moved {r['step_moved']}; K2 launches {la}, "
                  f"derived {r['derived_k2']} a forward (bf16 plain 0)")
            want = {"bf16_k2": r["derived_k2"], "bf16_plain": 0, "fp32_grads": r["derived_k2"],
                    "step": r["derived_k2"]}
            if (la != want or rel16 > PIPE_LOSS_RTOL["bfloat16"]
                    or rel32 > PIPE_LOSS_RTOL["float32"] or r["grads"]["worst"][0] > PIPE_GRAD_RTOL
                    or not r["grads"]["same_keys"] or not r["step_zeros_kept"]
                    or not r["step_moved"] or ls["fp32"] != ranks[0]["losses"]["fp32"]):
                raise AssertionError(f"seqpipe: the pipeline failed on stage {r['stage']}")
            launches["fused"] += sum(la.values())
        if not lead["dehybridized_equal"]:
            raise AssertionError("seqpipe: dehybridize_layers did not give the tree back")
        params, config, plan, _ = load_checkpoint(root, dev)
        held = {"int4": quantize_model_weights(params, bits=4), "fused": params}
        for label in ("int4", "int4_dma", "fused"):
            for r in ranks:
                e = r["serve"][label]
                print(f"seqpipe (d), TP-2 rank {r['rank']}, {label}: {len(prompts)} requests of "
                      f"{SEQPIPE_MAX_TOKENS} tokens, {e['steps']} decode steps in "
                      f"{e['seconds']:.2f} s ({e['decode_seconds'] * 1e3 / max(e['steps'], 1):.1f}"
                      f" ms a step), route {e['route']}; launches {e['got']}, derived {e['want']}")
                if (e["got"] != e["want"] or e["route"] != "kernel" or not e["steps"]
                        or e["streams"] != lead["serve"][label]["streams"]):
                    raise AssertionError(f"seqpipe: TP-2 {label} serving: launches or streams")
                for key in launches:
                    launches[key] += e["got"][key]
            bad, report = hold_to_plain(torch, held["fused" if label == "fused" else "int4"],
                                        config, plan, list(zip(prompts,
                                                               lead["serve"][label]["streams"])),
                                        dev)
            print(f"seqpipe (d), {label}: served tokens against the single-process "
                  f"teacher-forced forward: {report}")
            if bad:
                raise AssertionError(f"seqpipe: TP-2 {label} serving left the plain forward")
        if not launches["grid"] or not launches["dma"] or not launches["fused"]:
            raise AssertionError("seqpipe: a kernel of the path never launched")
        del params, held
        torch.cuda.empty_cache()
        print(f"seqpipe: pipeline and serving launch {wall:.1f} s; launches over the ranks "
              f"{launches}; phase 18 {time.perf_counter() - t_phase:.1f} s; card {card}")
        return errs, launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


PERF_FWD = (8, 2047)  # the forward's rows and tokens: the compression's calibration batch
PERF_DECODE = {"cache_len": 512, "prefill_len": 64, "k_small": 32, "k_large": 96}
# the decode batches of each weight form: K5d (GRASP_INT4_KERNEL=dma) at the
# serving batch only, the phase's time limit
PERF_BATCHES = {"bf16": (1, 8), "int4": (1, 8), "int4 dma": (8,)}
PERF_REPS = 3  # rounds of graph replays, each length in turns
PERF_EAGER_REPS = 1  # rounds of the eager chains: host-bound, seconds each
PERF_LONGROPE_STEPS = 32  # the longrope chain: half its steps past the original context
PERF_GEN = {"prompt_len": 256, "gen_len": 64, "warmup": 1, "iters": 2}
# TinyLlama-1.1B: 22 layers of 44,044,288, two tables of 65,536,000, the final norm
TINYLLAMA_PARAMS = 22 * 44_044_288 + 2 * 65_536_000 + 2_048
# a captured chain's fp32 sum against the same chain run eagerly (the same
# kernels on the same inputs; the relative slack covers a library product
# that picks another algorithm inside a capture)
GRAPH_EAGER_RTOL = 1e-3
BF16_PEAK = 989e12  # FLOP/s, NVIDIA's data sheet (H100 SXM, dense)
# one caching-allocator block: the peak right after a reset is the bytes in use
ALLOC_BLOCK = 2 << 20


def _perf_zero():
    """Set the launch counts of the kernels phase 19 reaches to 0."""
    from grasp_tpu_torch.ops.flash_attention import flash_attention
    from grasp_tpu_torch.ops.int4_matmul import int4_matmul
    from grasp_tpu_torch.ops.lowrank import fused_lowrank

    flash_attention.launches["fwd"] = fused_lowrank.launches = 0
    int4_matmul.launches.update(grid=0, dma=0)


def _perf_counts():
    from grasp_tpu_torch.ops.flash_attention import flash_attention
    from grasp_tpu_torch.ops.int4_matmul import int4_matmul
    from grasp_tpu_torch.ops.lowrank import fused_lowrank

    return {"fwd": flash_attention.launches["fwd"], "fused": fused_lowrank.launches,
            "grid": int4_matmul.launches["grid"], "dma": int4_matmul.launches["dma"]}


def _perf_flops(config, lowrank_layers, s):
    """The forward's FLOPs over ``s`` tokens from the shapes alone: each
    projection in x out multiply-adds a token (r x (in + out) in the
    ``lowrank_layers``, at build_flagship's ranks), the scores and values
    over the causal half (nh x hd x s a token a layer), the lm head."""
    from grasp_tpu_torch.ops.saliency import preserve_rank

    d, f, q = config.hidden_size, config.intermediate_size, config.q_dim
    kv = config.kv_dim
    shapes = ((d, q), (d, kv), (d, kv), (q, d), (d, f), (d, f), (f, d))
    macs = config.hidden_size * config.vocab_size
    for li in range(config.num_hidden_layers):
        for in_f, out_f in shapes:
            if li in lowrank_layers:
                macs += max(preserve_rank(in_f, out_f, 0.9), 8) * (in_f + out_f)
            else:
                macs += in_f * out_f
        macs += q * s
    return 2 * macs * s


def _graph_runs(got, captured, reps):
    """Launches that ran in a chain_seconds call of graphs: the counts moved
    at each length's eager step and capture, but a capture runs nothing and
    each of the reps + 1 replays runs what was captured (the counters count
    Python calls, so a replay moves none)."""
    return {k: got[k] - captured[k] + captured[k] * (reps + 1) for k in got}


def _add(total, more):
    for k in total:
        total[k] += more[k]


def _trace_kernels(path, names):
    """Kernel events in a profiler trace whose name holds each of ``names``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if str(e.get("cat", "")).lower() == "kernel"]
    return len(kernels), {n: sum(n in k for k in kernels) for n in names}


def _hold_graph_to_eager(torch, perf, chain, k, label):
    """One capture of ``chain.run(k)`` replayed once against the same chain
    run eagerly: the graph computes what the eager chain computes."""
    graph, out = perf.capture_chain(chain, k)
    graph.replay()
    torch.cuda.synchronize()
    got, want = float(out), float(chain.run(k))
    rel = abs(got - want) / max(abs(want), 1e-30)
    print(f"perf {label}: the {k}-step chain captured and replayed {got:.6e}, run eagerly "
          f"{want:.6e} (relative {rel:.2e}, tol {GRAPH_EAGER_RTOL})")
    if not math.isfinite(got) or rel > GRAPH_EAGER_RTOL:
        raise AssertionError(f"perf {label}: the CUDA graph left the eager chain")


def phase_perf(torch, card, dev):
    """Phase 19: grasp_tpu_torch.perf at TinyLlama-1.1B's full width and
    depth in bf16 (random weights from a seed): (a) the parameter count and
    the forward's FLOPs, dense and in the serving slice's compressed form,
    against the shapes; (b) device memory against the params' bytes and the
    peak's reset; (c) forward_device_benchmark at 8 x 2047 with labels through
    K1f, the chain captured as one CUDA graph, beside the same chain run
    eagerly; (d) decode_device_benchmark at batch 1 and 8 on bf16 weights
    and on int4 weights (K5; K5d under GRASP_INT4_KERNEL=dma at batch 8),
    beside the eager chain, and a longrope decode chain across its original
    context captured as one CUDA graph, bit-equal to the chain run eagerly;
    (e) generation_benchmark on the fused compressed model
    (K2 in prefill); (f) trace around an eager int4 decode step and a flash
    forward, read back against the launch counts, and around one graph
    replay. Launch counts held to counts derived from the dispatch rules;
    returns the launches that ran (graph replays included)."""
    import dataclasses

    import numpy as np

    from grasp_tpu_torch import ModelConfig, perf
    from grasp_tpu_torch.eval.generate import Generator
    from grasp_tpu_torch.models.convert import flatten_params
    from grasp_tpu_torch.models.llama import init_params
    from grasp_tpu_torch.ops.lowrank import FUSED_MIN_ROWS
    from grasp_tpu_torch.ops.quant import quantize_model_weights, takes_int4_kernel

    t_phase = time.perf_counter()
    ran = {"fwd": 0, "fused": 0, "grid": 0, "dma": 0}
    base = dataclasses.replace(ModelConfig.tinyllama_1_1b(), dtype="bfloat16")
    flash_config = dataclasses.replace(base, use_flash_attention=True)
    dense = init_params(torch.Generator(device=dev).manual_seed(19), base, device=dev)
    config, params, plan = build_flagship(torch, dev)
    n_layers = config.num_hidden_layers
    lowrank_layers = {n_layers - 2, n_layers - 1}

    # (a) counts
    s = PERF_FWD[1]
    n_dense = perf.count_params(dense)
    est_dense = perf.estimate_forward_flops(dense, base, seq_len=s)
    est_comp = perf.estimate_forward_flops(params, config, plan, seq_len=s)
    want_dense, want_comp = _perf_flops(base, set(), s), _perf_flops(config, lowrank_layers, s)
    print(f"perf (a): count_params {n_dense:,} (want {TINYLLAMA_PARAMS:,}); forward FLOPs at "
          f"{s} tokens dense {est_dense['flops']:.6e} (from the shapes {want_dense:.6e}), "
          f"compressed {est_comp['flops']:.6e} ({want_comp:.6e}), params "
          f"{est_comp['params']:,}")
    if (n_dense != TINYLLAMA_PARAMS or est_dense["params"] != n_dense
            or est_dense["flops"] != want_dense or est_comp["flops"] != want_comp):
        raise AssertionError("perf: the counts differ from the shapes")

    # (b) memory
    dense_bytes = sum(t.numel() * t.element_size() for t in flatten_params(dense).values())
    mem = perf.device_memory()
    perf.reset_hbm_peak()
    after = perf.device_memory()
    print(f"perf (b): device_memory {mem} with the dense params' {dense_bytes:,} bytes live; "
          f"after reset_hbm_peak {after}")
    if (mem["bytes_in_use"] < dense_bytes or mem["peak_bytes_in_use"] < mem["bytes_in_use"]
            or abs(after["peak_bytes_in_use"] - after["bytes_in_use"]) > ALLOC_BLOCK
            or mem["bytes_limit"] < mem["peak_bytes_in_use"]):
        raise AssertionError("perf: device memory out of order")

    # (c) the forward through K1f, one CUDA graph against the eager chain
    rng = np.random.default_rng(19)
    ids = torch.as_tensor(rng.integers(3, base.vocab_size, PERF_FWD), device=dev)
    labels = torch.as_tensor(rng.integers(3, base.vocab_size, PERF_FWD), device=dev)
    ks = (1, 5)
    _perf_zero()
    fwd = perf.forward_device_benchmark(dense, flash_config, ids, labels=labels,
                                        k_small=ks[0], k_large=ks[1], reps=PERF_REPS)
    got = _perf_counts()
    captured = {"fwd": n_layers * sum(ks), "fused": 0, "grid": 0, "dma": 0}
    want = dict(captured, fwd=n_layers * (len(ks) + sum(ks)))  # an eager step, the capture
    if got != want:
        raise AssertionError(f"perf (c): launches {got}, derived {want} (22 a forward)")
    _add(ran, _graph_runs(got, captured, PERF_REPS))
    chain = perf.forward_chain(dense, flash_config, ids, labels=labels)
    _perf_zero()
    eager = perf.chain_seconds(chain, ks, PERF_EAGER_REPS, graph=False)
    _hold_graph_to_eager(torch, perf, chain, 1, "(c) forward")
    got = _perf_counts()
    # an eager step, the eager chains, then the check's eager step, capture and
    # eager chain: its capture counted and ran nothing, its replay the reverse
    want_fwd = n_layers * (1 + PERF_EAGER_REPS * sum(ks) + 3)
    if got["fwd"] != want_fwd:
        raise AssertionError(f"perf (c): eager launches {got}, derived {want_fwd}")
    _add(ran, got)
    eager_fwd = (eager[1] - eager[0]) / (ks[1] - ks[0])
    flops = est_dense["flops"] * PERF_FWD[0]
    print(f"perf (c): forward of {PERF_FWD[0]} x {s} with labels through K1f (22 a forward, "
          f"as derived): one CUDA graph {fwd['fwd_s_device'] * 1e3:.2f} ms a forward "
          f"({flops / fwd['fwd_s_device'] / 1e12:.1f} TFLOP/s, "
          f"{flops / fwd['fwd_s_device'] / BF16_PEAK:.1%} of {BF16_PEAK / 1e12:.0f}; "
          f"overhead {fwd['per_call_overhead_ms']:.3f} ms a call); eager "
          f"{eager_fwd * 1e3:.2f} ms ({eager[0] * 1e3:.2f} and {eager[1] * 1e3:.2f} ms at k "
          f"{ks}); bound {flops / BF16_PEAK * 1e3:.2f} ms by operations; card {card}")
    del chain

    print(f"perf (a) to (c): {time.perf_counter() - t_phase:.1f} s")

    # (d) decode, bf16 and int4, one CUDA graph against the eager chain
    t0 = time.perf_counter()
    int4 = quantize_model_weights(params, bits=4)
    pd = PERF_DECODE
    steps = pd["k_small"] + pd["k_large"]
    for label, weights, dma in (("bf16", params, False), ("int4", int4, False),
                                ("int4 dma", int4, True)):
        if dma:
            os.environ["GRASP_INT4_KERNEL"] = "dma"
        try:
            for batch in PERF_BATCHES[label]:
                def per_call(rows):
                    """int4 launches of one forward of ``rows`` rows, by the
                    dispatch rule (at most 64 rows and a group size that is a
                    multiple of 128; dma for output widths that are multiples
                    of 128 under GRASP_INT4_KERNEL=dma)."""
                    out = {"fwd": 0, "fused": 0, "grid": 0, "dma": 0}
                    for gs, out_f in _int4_projections(weights):
                        if takes_int4_kernel(rows, gs):
                            out["dma" if dma and out_f % 128 == 0 else "grid"] += 1
                    return out

                step, pre = per_call(batch), per_call(batch * pd["prefill_len"])
                _perf_zero()
                res = perf.decode_device_benchmark(weights, config, plan, reps=PERF_REPS,
                                                   batch=batch, **pd)
                got = _perf_counts()
                captured = {k: v * steps for k, v in step.items()}
                want = {k: pre[k] + 2 * step[k] + captured[k] for k in step}
                if got != want:
                    raise AssertionError(f"perf (d) {label} batch {batch}: launches {got}, "
                                         f"derived {want}")
                _add(ran, _graph_runs({k: got[k] - pre[k] for k in got}, captured, PERF_REPS))
                _add(ran, pre)
                _perf_zero()
                chain = perf.decode_chain(weights, config, plan, cache_len=pd["cache_len"],
                                          prefill_len=pd["prefill_len"], batch=batch)
                eager = perf.chain_seconds(chain, (pd["k_small"], pd["k_large"]),
                                           PERF_EAGER_REPS, graph=False)
                _hold_graph_to_eager(torch, perf, chain, 4, f"(d) {label} batch {batch}")
                got = _perf_counts()
                # the prefill, an eager step, the eager chains, the check's eager
                # step, capture (counted, ran nothing; its replay the reverse) and chain
                want = {k: pre[k] + step[k] * (1 + PERF_EAGER_REPS * steps + 1 + 2 * 4)
                        for k in step}
                if got != want:
                    raise AssertionError(f"perf (d) {label} batch {batch}: eager launches "
                                         f"{got}, derived {want}")
                _add(ran, got)
                eager_tok = (eager[1] - eager[0]) / (pd["k_large"] - pd["k_small"])
                graph_tok = res["decode_ms_per_token_device"] / 1e3
                print(f"perf (d) {label}, batch {batch}: one CUDA graph "
                      f"{graph_tok * 1e3:.3f} ms a step ({res['decode_tokens_per_s_aggregate']:.0f}"
                      f" tokens/s over the batch, overhead {res['per_call_overhead_ms']:.3f} ms a "
                      f"call), eager {eager_tok * 1e3:.3f} ms a step ({eager[0] * 1e3:.1f} and "
                      f"{eager[1] * 1e3:.1f} ms at k {pd['k_small']} and {pd['k_large']}): the "
                      f"graph takes {graph_tok / eager_tok:.1%} of the eager time; int4 launches "
                      f"a step {dict((k, step[k]) for k in ('grid', 'dma'))}, as derived")
                del chain
        finally:
            if dma:
                del os.environ["GRASP_INT4_KERNEL"]

    print(f"perf (d): {time.perf_counter() - t0:.1f} s")

    # (d) longrope: the factors are chosen on the device, so a chain whose
    # steps cross original_max_position_embeddings captures
    t0 = time.perf_counter()
    k = PERF_LONGROPE_STEPS
    rng = np.random.default_rng(19)
    half = config.head_dim_ // 2
    longrope = {"rope_type": "longrope", "short_factor": (1 + rng.random(half)).tolist(),
                "long_factor": (2 + rng.random(half)).tolist(),
                "original_max_position_embeddings": pd["prefill_len"] + k // 2,
                "max_position_embeddings": config.max_position_embeddings}
    chain = perf.decode_chain(params, dataclasses.replace(config, rope_scaling=longrope), plan,
                              cache_len=pd["cache_len"], prefill_len=pd["prefill_len"])
    graph, out = perf.capture_chain(chain, k)
    graph.replay()
    torch.cuda.synchronize()
    replayed = out.clone()
    eager = chain.run(k)
    torch.cuda.synchronize()
    short = perf.decode_chain(params, config, plan, cache_len=pd["cache_len"],
                              prefill_len=pd["prefill_len"]).run(k)
    same = torch.equal(replayed, eager)
    print(f"perf (d) longrope: a decode chain of {k} steps from position {pd['prefill_len']} "
          f"across original_max_position_embeddings {longrope['original_max_position_embeddings']}"
          f" captured as one CUDA graph: replayed {float(replayed):.8e}, eager "
          f"{float(eager):.8e}, bit for bit equal: {same}; the chain without longrope "
          f"{float(short):.8e}; {time.perf_counter() - t0:.1f} s")
    if not same or not math.isfinite(float(eager)) or float(short) == float(eager):
        raise AssertionError("perf (d) longrope: the captured chain left the eager one")
    del chain, graph

    # (e) generation through K2 in prefill
    t0 = time.perf_counter()
    fused_config = dataclasses.replace(config, use_pallas_lowrank=True)
    pairs = sum("in_kernel" in p for layer in params["layers"]
                for group in ("self_attn", "mlp") for p in layer[group].values())
    _perf_zero()
    gen = perf.generation_benchmark(params, fused_config, plan, **PERF_GEN)
    got = _perf_counts()
    n_gen = PERF_GEN["warmup"] + PERF_GEN["iters"]
    prompt = np.random.default_rng(0).integers(0, config.vocab_size, size=(PERF_GEN["prompt_len"],))
    plain = Generator(params, config, plan).greedy(prompt, PERF_GEN["gen_len"])
    want_fused = pairs * n_gen if PERF_GEN["prompt_len"] >= FUSED_MIN_ROWS else 0
    print(f"perf (e): generation_benchmark on the fused compressed model: {gen}; K2 launches "
          f"{got['fused']} (derived {want_fused}: {pairs} a prefill x {n_gen}); tokens "
          f"{gen['tokens_generated']} against the plain greedy stream's {len(plain)} x "
          f"{PERF_GEN['iters']}; {time.perf_counter() - t0:.1f} s")
    if (got != {"fwd": 0, "fused": want_fused, "grid": 0, "dma": 0}
            or gen["tokens_generated"] != len(plain) * PERF_GEN["iters"]
            or not gen["decode_tokens_per_s"] > 0 or not gen["peak_hbm_gib"] > 0):
        raise AssertionError("perf (e): generation launches or tokens")
    _add(ran, got)

    # (f) traces, read back
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_perf_", dir=os.path.join(ROOT, "build"))
    try:
        _perf_zero()
        chain4 = perf.decode_chain(int4, config, plan, batch=1)  # a prefill of 64 rows: K5
        fwd_chain = perf.forward_chain(dense, flash_config, ids[:1])
        _add(ran, _perf_counts())
        names = ("int4_grid_mma_kernel", "flash_fwd_mma_kernel")
        _perf_zero()
        with perf.trace(os.path.join(root, "eager")) as log_dir:
            chain4.run(1)
            fwd_chain.run(1)
            torch.cuda.synchronize()
        got = _perf_counts()
        (path,) = [os.path.join(log_dir, f) for f in os.listdir(log_dir)]
        total, seen = _trace_kernels(path, names)
        want = {"int4_grid_mma_kernel": got["grid"], "flash_fwd_mma_kernel": got["fwd"]}
        print(f"perf (f): trace of one eager int4 decode step and one flash forward: "
              f"{total} kernels, by name {seen}, launch counts {want}; "
              f"{os.path.getsize(path):,} bytes")
        if seen != want or not got["grid"] or not got["fwd"]:
            raise AssertionError("perf (f): the trace does not show the kernels launched")
        _add(ran, got)
        _perf_zero()
        graph, _ = perf.capture_chain(chain4, 2)  # its eager step and capture: not traced
        with perf.trace(os.path.join(root, "graph")) as log_dir:
            graph.replay()
            torch.cuda.synchronize()
        got = _perf_counts()
        (path,) = [os.path.join(log_dir, f) for f in os.listdir(log_dir)]
        total, seen = _trace_kernels(path, names)
        step = sum(takes_int4_kernel(1, gs) for gs, _ in _int4_projections(int4))
        if got["grid"] != 3 * step:
            raise AssertionError(f"perf (f): graph launches {got}, derived {3 * step}")
        _add(ran, got)  # the capture counted and ran nothing, the replay the reverse
        print(f"perf (f): trace of one replay of a 2-step int4 decode graph: {total} kernels, "
              f"int4_grid_mma_kernel {seen['int4_grid_mma_kernel']} of the {2 * step} the "
              f"graph holds (the profiler shows a replay "
              f"{'kernel by kernel' if seen['int4_grid_mma_kernel'] == 2 * step else 'otherwise'})")
        del graph, chain4, fwd_chain
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del dense, params, int4
    torch.cuda.empty_cache()
    print(f"perf: launches that ran in phase 19 (graph replays included) {ran}; phase 19 "
          f"{time.perf_counter() - t_phase:.1f} s; card {card}")
    return ran


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
                                           "evaluate", "recover", "hf", "phi3serve",
                                           "features", "mixtral", "families", "gemma7b",
                                           "mesh", "seqpipe", "perf", "paged"],
                        default=None,
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
        print({hd: phase_flash_timing(torch, shape) for hd, shape in FLASH_TIMING_SHAPES.items()})
        return 0
    if args.only == "kernels":
        print(phase_lowrank(torch), phase_int4(torch), phase_quantizer(torch))
        print(phase_lowrank_timing(torch), phase_int4_timing(torch), phase_quantizer_timing(torch))
        return 0
    dev = torch.device("cuda", 0)
    if args.only == "compress":
        print(phase_compress(torch, card, dev))
        return 0
    if args.only in ("evaluate", "recover"):
        print(phase_compress(torch, card, dev, only=args.only))
        return 0
    if args.only == "hf":
        print(phase_compress(torch, card, dev, only="hf"), phase_phi3(torch, card, dev))
        return 0
    if args.only == "features":
        print(phase_slice(torch, card, dev, only="features"))
        return 0
    if args.only == "phi3serve":
        print(phase_kernel(torch, hds=(96,), int8_hds=()), phase_kernel_timing(torch, *PHI3_TIMING))
        print(phase_chunk(torch, hds=(96,), int8_hds=()), phase_chunk_timing(torch, *PHI3_TIMING))
        print(phase_phi3(torch, card, dev))
        return 0
    if args.only == "families":
        print(phase_flash_timing(torch, FLASH_TIMING_SHAPES[256]))
        print(phase_families(torch, card, dev))
        return 0
    if args.only == "gemma7b":
        print(phase_kernel(torch, hds=(256,), int8_hds=(256,)),
              phase_k7_timing(torch, phase_kernel_timing, gemma2b=False))
        print(phase_chunk(torch, hds=(256,), int8_hds=(256,)),
              phase_k7_timing(torch, phase_chunk_timing, gemma2b=False))
        print(phase_gemma7b(torch, card, dev))
        return 0
    if args.only == "mesh":
        print(phase_mesh(torch, card, dev))
        return 0
    if args.only == "seqpipe":
        print(phase_seqpipe(torch, card, dev))
        return 0
    if args.only == "perf":
        print(phase_perf(torch, card, dev))
        return 0
    if args.only == "mixtral":
        print(phase_kernel(torch, hds=(128,), int8_hds=()),
              phase_kernel_timing(torch, *MIXTRAL_TIMING))
        print(phase_chunk(torch, hds=(128,), int8_hds=()),
              phase_chunk_timing(torch, *MIXTRAL_TIMING))
        print(phase_flash_timing(torch, FLASH_TIMING_SHAPES[128]))
        print(phase_mixtral(torch, card, dev))
        return 0
    parts, t_part = {}, [time.perf_counter()]

    def part(label):
        """Seconds since the previous part, printed before the record: what
        the next phase has to budget against the time limit."""
        now = time.perf_counter()
        parts[label], t_part[0] = round(now - t_part[0], 1), now

    paged_err = phase_kernel(torch)
    paged = phase_kernel_timing(torch, *TINYLLAMA_TIMING)
    paged96 = phase_kernel_timing(torch, *PHI3_TIMING)
    paged128 = phase_kernel_timing(torch, *MIXTRAL_TIMING)
    paged_k7 = phase_k7_timing(torch, phase_kernel_timing)
    chunk_err = phase_chunk(torch)
    chunk = phase_chunk_timing(torch, *TINYLLAMA_TIMING)
    chunk96 = phase_chunk_timing(torch, *PHI3_TIMING)
    chunk128 = phase_chunk_timing(torch, *MIXTRAL_TIMING)
    chunk_k7 = phase_k7_timing(torch, phase_chunk_timing)
    if args.only == "paged":
        print(json.dumps({"decode": [paged, paged96, paged128, paged_k7],
                          "chunk": [chunk, chunk96, chunk128, chunk_k7]}))
        return 0
    if args.only == "spec":
        print(chunk, phase_slice(torch, card, dev, only="spec"))
        return 0
    if args.only == "serve":
        print(phase_slice(torch, card, dev))
        print(drive_quantizer(torch, dev))
        return 0
    flash_err = phase_flash(torch)
    flash = phase_flash_timing(torch)
    flash96 = phase_flash_timing(torch, FLASH_TIMING_SHAPES[96])
    flash128 = phase_flash_timing(torch, FLASH_TIMING_SHAPES[128])
    flash256 = phase_flash_timing(torch, FLASH_TIMING_SHAPES[256])
    lowrank_err, int4_err, quant_err = phase_lowrank(torch), phase_int4(torch), phase_quantizer(torch)
    lowrank, int4, quant = (phase_lowrank_timing(torch), phase_int4_timing(torch),
                            phase_quantizer_timing(torch))
    part("kernels")
    paged_launches, spec_launches, served, features = phase_slice(torch, card, dev)
    part("serving")
    flash_launches, fused_compress_launches, evaluated, recovered, from_hf = phase_compress(
        torch, card, dev)
    part("compress, evaluate, recover, hf")
    phi3, phi3_served = phase_phi3(torch, card, dev, layers=PHI3_LAYERS)
    part("phi3")
    mixtral, mixtral_served = phase_mixtral(torch, card, dev)
    part("mixtral")
    families, families_served = phase_families(torch, card, dev, mistral_layers=MISTRAL_LAYERS)
    part("families")
    gemma7b_served = phase_gemma7b(torch, card, dev, layers=GEMMA7B_LAYERS)
    part("gemma7b")
    mesh_err, mesh = phase_mesh(torch, card, dev)
    part("mesh")
    seqpipe_err, seqpipe = phase_seqpipe(torch, card, dev)
    part("seqpipe")
    # phase 19's launches that ran: a CUDA graph's captured launches once for
    # every replay (the .launches counters count Python calls, so a replay
    # moves none; phase_perf adds them)
    perf_ran = phase_perf(torch, card, dev)
    quant_launches = drive_quantizer(torch, dev)
    part("perf, quantizer")
    print(f"smoke: seconds by part after the build {parts}, {sum(parts.values()):.1f} in all")
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "grasp_tpu", "safetensors"))
    if bad:
        raise AssertionError(f"the port imported {bad}")
    flash_src = "grasp_tpu_torch/csrc/flash_attention.cu"
    int4_src = "grasp_tpu_torch/csrc/int4_matmul.cu"
    record = {"kernels": [
        {"name": "paged_attention_decode", "route": "cuda",
         "source": "grasp_tpu_torch/csrc/paged_attention.cu",
         "replaces": "grasp_tpu/ops/pallas_paged64.py:122",
         "also_replaces": K7_SITE,
         "launches": paged_launches + from_hf["paged"] + phi3_served["paged"]
         + features["paged"] + mixtral_served["paged"] + families_served["paged"]
         + gemma7b_served["paged"] + mesh["paged"] + seqpipe["paged"],
         "max_abs_err": max(paged_err, mesh_err["paged"]), **paged, "hd96": paged96,
         "hd128": paged128, **paged_k7},
        # library_ms: no single PyTorch call reads a page table; the timing line
        # above has one decode launch per chunk position beside it
        {"name": "paged_attention_chunk", "route": "cuda",
         "source": "grasp_tpu_torch/csrc/paged_attention.cu",
         "replaces": "grasp_tpu/ops/pallas_paged64.py:251",
         "also_replaces": K7_SITE,
         "launches": spec_launches["chunk"] + phi3_served["chunk"] + features["chunk"]
         + mixtral_served["chunk"] + families_served["chunk"] + gemma7b_served["chunk"]
         + mesh["chunk"],
         "max_abs_err": max(chunk_err, mesh_err["chunk"]),
         **chunk, "hd96": chunk96, "hd128": chunk128, **chunk_k7},
        # the bf16 forward's body (the fp32 inputs of phase_flash take flash_fwd_kernel)
        # launches: the two compressions, the evaluation slice, the HF route,
        # the Phi-3 slice (head_dim 96: its compression and perplexity) and
        # the Mixtral slice's compression (head_dim 128); times at TinyLlama's
        # shape, "hd96" at Phi-3's, "hd128" at Mixtral's
        {"name": "flash_fwd_mma_kernel", "route": "cuda", "source": flash_src,
         "replaces": "grasp_tpu/ops/pallas_attention.py:138",
         "launches": flash_launches["fwd"] + evaluated["fwd"] + from_hf["fwd"] + phi3["fwd"]
         + mixtral["fwd"] + families["fwd"] + mesh["fwd"] + perf_ran["fwd"],
         "max_abs_err": max(flash_err["fwd"], mesh_err["fwd"]), **flash["fwd"], "hd96": flash96["fwd"],
         "hd128": flash128["fwd"], "hd256": flash256["fwd"]},
        # the bf16 backward's bodies: a launch is flash_dkv_mma_kernel and its
        # group sum flash_dkv_reduce_kernel; library_ms is the whole SDPA backward
        {"name": "flash_dkv_mma_kernel", "route": "cuda", "source": flash_src,
         "replaces": "grasp_tpu/ops/pallas_attention.py:305",
         "launches": flash_launches["dkv"] + from_hf["dkv"] + phi3["dkv"] + mixtral["dkv"]
         + families["dkv"] + mesh["dkv"],
         "max_abs_err": max(flash_err["dkv"], mesh_err["dkv"]), **flash["dkv"], "hd96": flash96["dkv"],
         "hd128": flash128["dkv"], "hd256": flash256["dkv"]},
        {"name": "flash_dq_mma_kernel", "route": "cuda", "source": flash_src,
         "replaces": "grasp_tpu/ops/pallas_attention.py:344",
         "launches": flash_launches["dq"] + from_hf["dq"] + phi3["dq"] + mixtral["dq"]
         + families["dq"] + mesh["dq"],
         "max_abs_err": max(flash_err["dq"], mesh_err["dq"]), **flash["dq"], "hd96": flash96["dq"],
         "hd128": flash128["dq"], "hd256": flash256["dq"]},
        # launches: prefill of the fused serving variant, the flagged compression,
        # the evaluation slice, the recovery slice's bf16 runs, phase 18's
        # pipeline stages and TP-2 prefill and phase 19's generation; the bf16
        # body (the fp32 inputs of phase_lowrank and phase 18's fp32 pipeline
        # take lowrank_fused_kernel)
        {"name": "lowrank_fused_mma_kernel", "route": "cuda",
         "source": "grasp_tpu_torch/csrc/lowrank_fused.cu",
         "replaces": "grasp_tpu/ops/pallas_lowrank.py:65",
         "launches": served["fused"]["fused"] + fused_compress_launches + evaluated["fused"]
         + recovered["fused"] + features["fused"] + seqpipe["fused"] + perf_ran["fused"],
         "max_abs_err": max(lowrank_err, seqpipe_err["fused"]), **lowrank},
        {"name": "int4_matmul_grid", "route": "cuda", "source": int4_src,
         "replaces": "grasp_tpu/ops/pallas_int4.py:198",
         "launches": served["int4"]["grid"] + mixtral_served["int4"]["grid"]
         + families_served["int4"]["grid"] + seqpipe["grid"] + perf_ran["grid"],
         "max_abs_err": max(int4_err["grid"], seqpipe_err["grid"]), **int4["grid"]},
        {"name": "int4_matmul_dma", "route": "cuda", "source": int4_src,
         "replaces": "grasp_tpu/ops/pallas_int4.py:139",
         "launches": served["int4"]["dma"] + mixtral_served["int4"]["dma"]
         + families_served["int4"]["dma"] + seqpipe["dma"] + perf_ran["dma"],
         "max_abs_err": max(int4_err["dma"], seqpipe_err["dma"]), **int4["dma"]},
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
