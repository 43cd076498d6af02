#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (grasp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. device: requires CUDA; prints the card's name and power limit.
2. build: compiles grasp_tpu_torch/csrc/*.cu with nvcc (sm_90a) into build/.
3. paged kernel: the paged-attention decode kernel against its plain PyTorch
   version on the same inputs, at TinyLlama's decode shape and at head_dim
   128, in float32 and bfloat16, within stated tolerances; then both timed
   with CUDA events at the decode shape.
4. flash kernels: the flash-attention forward, dK/dV and dQ kernels against
   the plain version (output and the gradients of sum(o ** 2)) at four
   shapes in float32 and bfloat16, dK/dV bit-equal over two runs; then each
   kernel, the plain version and scaled_dot_product_attention (a yardstick
   the port never calls) timed at the calibration shape.
5. serving slice: a GRASP-compressed TinyLlama-1.1B at full width (22 layers,
   random weights from a seed, the last two layers' projections low-rank at
   ratio 0.9) saved as a port checkpoint and served by ``grasp_tpu_torch.cli``
   over HTTP: one streamed completion, then 8 concurrent completions with
   prompts of 16 to 1500 tokens, and /v1/models. Checks every response, that
   the kernel ran once per layer per decode step, and that the served tokens
   agree with a teacher-forced plain forward of the same weights.
6. compression slice: ``grasp-compress-torch`` on a dense TinyLlama-1.1B at
   full width and depth with 16 synthetic calibration rows of 2047 tokens
   (2 layers, ratio 0.9). Checks the chosen layers, every rank, the plan, the
   parameter count, that the flash kernels ran as often as the sweeps imply,
   that the saved checkpoint loads and runs, and one round's gradients with
   the flash route and the plain route in bf16 against the plain route in
   fp32.

The third line from the end is a JSON record of each kernel (launches in its
slice's run, error against the plain version, times, bound); then the card's
line; the last line is ``{"ok": true, "device": {...}}``. Imports nothing of
JAX and nothing of grasp_tpu. ``--only flash|serve|compress`` runs one part
while developing and prints no result lines.
"""

import argparse
import functools
import http.client
import json
import os
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


def phase_build():
    from grasp_tpu_torch.ops._build import build, load_library

    t0 = time.perf_counter()
    so = build()
    load_library()
    secs = time.perf_counter() - t0
    print(f"build: {secs:.2f} s -> {os.path.relpath(so, ROOT)}")
    log = so.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}")


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


def phase_kernel(torch):
    from grasp_tpu_torch.ops.paged_attention import paged_attention, paged_attention_reference

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1234)
    lengths = [1, 127, 128, 129, 2048, 0, 1000, 2047]  # 0: dead row on null page 0
    worst = 0.0
    for hd, nh, nkv in ((64, 32, 4), (128, 32, 8)):
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            q, k, v, lens, tables = _pages_case(torch, gen, dev, dtype, 8, nh, nkv, hd,
                                                128, 16, 256, lengths)
            scale = hd ** -0.5
            got = paged_attention(q, k[0], v[0], lens, tables, scale)
            want = paged_attention_reference(q, k[0], v[0], lens, tables, scale)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.isfinite(got).all().item() and err <= TOL[dtype_name]
            print(f"kernel vs plain: hd={hd} nh={nh} nkv={nkv} {dtype_name}: "
                  f"max_abs_err={err:.3e} (tol {TOL[dtype_name]:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"paged attention kernel disagrees: hd={hd} {dtype_name}")
            worst = max(worst, err)
    return worst


def _time_ms(torch, fn, n_layers, iters):
    """Mean ms per call over ``iters`` rounds of one call per layer slice
    (the 22 layers' pools together exceed the L2 cache, as in decode)."""
    for li in range(n_layers):
        fn(li)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
    kernel, kernel, plain; reports the mean of each pair."""
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

    p1 = _time_ms(torch, plain, n_layers, 20)
    k1 = _time_ms(torch, kern, n_layers, 20)
    k2 = _time_ms(torch, kern, n_layers, 20)
    p2 = _time_ms(torch, plain, n_layers, 20)
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    print(f"kernel timing (B=8 nh=32 nkv=4 hd=64 bf16, lengths {lengths}): "
          f"kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms")
    # least time for this call: the live K and V rows, q and the output moved
    # once at 3.35 TB/s, against q.k and p.v (2 flops each per element) at the
    # bf16 tensor-core peak
    live = sum(lengths)
    nbytes = 2 * live * 4 * 64 * 2 + 2 * 8 * 32 * 64 * 2 + lens.numel() * 4 + tables.numel() * 4
    ops_ms = 4 * live * 32 * 64 / 989e12 * 1e3
    bytes_ms = nbytes / 3.35e12 * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "library_ms": None}


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
            same = torch.equal(got[2], again[2]) and torch.equal(got[3], again[3])
            ok = (finite and same and errs[0] <= TOL[dtype_name]
                  and max(rel) <= FLASH_GRAD_RTOL)
            print(f"flash vs plain: B={b} nh={nh} nkv={nkv} S={s} hd={hd} scale={scale:.4f} "
                  f"{dtype_name}: fwd max_abs_err={errs[0]:.3e} (tol {TOL[dtype_name]:g}), grad "
                  f"max_abs_err dq={errs[1]:.3e} dk={errs[2]:.3e} dv={errs[3]:.3e}, over the "
                  f"plain gradient's max dq={rel[0]:.3e} dk={rel[1]:.3e} dv={rel[2]:.3e} (tol "
                  f"{FLASH_GRAD_RTOL:g}), dK/dV bit-equal over two runs: {same} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash attention kernels disagree: S={s} hd={hd} "
                                     f"{dtype_name}")
            worst["fwd"] = max(worst["fwd"], errs[0])
            worst["dq"] = max(worst["dq"], errs[1])
            worst["dkv"] = max(worst["dkv"], errs[2], errs[3])
    return worst


def _event_ms(torch, fn, iters):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
    and dQ the plain version and the library call are autograd's gradient
    with respect to (k, v) or to q of an already computed forward. The bound is
    the larger of bytes moved over 3.35 TB/s and operations over 989 TFLOP/s
    (causal: half of the S x S products)."""
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
    di = (o.float() * dout.float()).sum(-1).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda *ts: [t.data_ptr() for t in ts]  # noqa: E731
    dims = (b, nh, nkv, s, hd, 1, float(scale), stream)

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"kernel launch failed: cudaError {rc}")

    kernels = {
        "fwd": lambda: fa._forward_cuda(q, k, v, scale),
        "dkv": lambda: check(lib.grasp_flash_attention_bwd_dkv(
            *ptr(q, k, v, dout, lse, di, dk, dv), *dims)),
        "dq": lambda: check(lib.grasp_flash_attention_bwd_dq(
            *ptr(q, k, v, dout, lse, di, dq), *dims)),
    }
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))

    def sdpa(q_, k_, v_, gqa=True):
        if gqa:
            return F.scaled_dot_product_attention(q_, k_, v_, is_causal=True, scale=scale,
                                                  enable_gqa=True)
        return F.scaled_dot_product_attention(
            q_, k_.repeat_interleave(groups, dim=1), v_.repeat_interleave(groups, dim=1),
            is_causal=True, scale=scale)

    # the plain version and the library call of each kernel's function: the
    # forward, and autograd's gradient with respect to (k, v) or to q alone
    def runners(attn):
        def fwd():
            with torch.no_grad():
                attn(q, k, v)
        o_graph = attn(qg, kg, vg)
        return {"fwd": fwd,
                "dkv": lambda: torch.autograd.grad(o_graph, (kg, vg), dout, retain_graph=True),
                "dq": lambda: torch.autograd.grad(o_graph, (qg,), dout, retain_graph=True)}

    try:
        sdpa(q, k, v)
    except TypeError:  # a PyTorch without enable_gqa: repeat the kv heads for the yardstick
        sdpa = functools.partial(sdpa, gqa=False)
    turns = {"kernel": kernels,
             "plain": runners(lambda *ts: fa.flash_attention_reference(*ts, groups, scale)),
             "library": runners(sdpa)}
    t = {}
    for turn in ("plain", "kernel", "library", "library", "kernel", "plain"):
        for name, fn in turns[turn].items():
            t.setdefault((turn, name), []).append(_event_ms(torch, fn, 10))
    mean = {key: sum(xs) / len(xs) for key, xs in t.items()}
    print("flash timing (B=1 nh=32 nkv=4 S=2047 hd=64 bf16), ms per call, two turns each: "
          + ", ".join(f"{turn} {name} {xs[0]:.4f}/{xs[1]:.4f}" for (turn, name), xs in t.items()))

    pairs = b * nh * s * (s + 1) / 2          # live (query, key) pairs
    qo_bytes, kv_bytes = b * nh * s * hd * 2, b * nkv * s * hd * 2
    row_bytes = b * nh * s * 4                # lse or di, fp32
    # (products of 2 * hd flops per pair, bytes read + written)
    work = {"fwd": (2, 2 * qo_bytes + 2 * kv_bytes + row_bytes),
            "dkv": (4, 2 * qo_bytes + 4 * kv_bytes + 2 * row_bytes),
            "dq": (3, 3 * qo_bytes + 2 * kv_bytes + 2 * row_bytes)}
    out = {}
    for name, (products, nbytes) in work.items():
        ops_ms = products * 2 * hd * pairs / 989e12 * 1e3
        bytes_ms = nbytes / 3.35e12 * 1e3
        out[name] = {"ms": mean["kernel", name], "plain_ms": mean["plain", name],
                     "library_ms": mean["library", name], "bound_ms": max(ops_ms, bytes_ms),
                     "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
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


def check_against_plain(torch, params, config, plan, served, dev):
    """Teacher-forced plain forward (no pages, no kernel) of prompt + served
    tokens: at every generated position the served token's logit must be
    within GAP_TOL of the largest logit. Returns (max gap, argmax matches,
    positions)."""
    from grasp_tpu_torch.models.llama import forward

    worst, match, total = 0.0, 0, 0
    with torch.no_grad():
        for prompt, out in served:
            ids = torch.tensor([list(prompt) + out[:-1]], device=dev)
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


def phase_slice(torch, card, dev):
    import numpy as np

    from grasp_tpu_torch.checkpoints import save_checkpoint
    from grasp_tpu_torch.cli import serve_main
    from grasp_tpu_torch.models.convert import flatten_params
    from grasp_tpu_torch.ops.paged_attention import paged_attention

    config, params, plan = build_flagship(torch, dev)
    n_params = sum(t.numel() for t in flatten_params(params).values())
    print(f"slice: TinyLlama-1.1B bf16, {config.num_hidden_layers} layers, "
          f"low-rank layers {[i for i, lp in enumerate(plan) if 'lowrank' in lp]}, "
          f"{n_params} parameters")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt_root = tempfile.mkdtemp(prefix="smoke_ckpt_", dir=os.path.join(ROOT, "build"))
    handles = None
    try:
        t0 = time.perf_counter()
        save_checkpoint(ckpt_root, params, config, plan)
        del params
        torch.cuda.empty_cache()
        handles = serve_main(["--model_path", ckpt_root, "--host", "127.0.0.1", "--port", "0",
                              "--device", str(dev), "--max_batch", "8", "--page_size", "128",
                              "--num_pages", "256", "--max_pages_per_seq", "16"], block=False)
        gserver, httpd, _ = handles
        port = httpd.server_address[1]
        engine = gserver.engine
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
    finally:
        if handles is not None:
            handles[1].shutdown()
            handles[1].server_close()
            handles[0].close()
        shutil.rmtree(ckpt_root, ignore_errors=True)


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


def _param_count(params):
    from grasp_tpu_torch.models.convert import flatten_params

    return sum(t.numel() for t in flatten_params(params).values())


def phase_compress(torch, card, dev):
    """``grasp-compress-torch`` on the card, then checks of what it saved.
    Returns the launch counts of the three flash kernels in that run."""
    import dataclasses

    import numpy as np

    from grasp_tpu_torch import GraspConfig
    from grasp_tpu_torch.checkpoints import load_checkpoint
    from grasp_tpu_torch.cli import compress_main, load_model
    from grasp_tpu_torch.core.engine import GraspEngine, module_name, parse_module_name
    from grasp_tpu_torch.data.loader import get_calibration_batches
    from grasp_tpu_torch.data.tokenizer import load_tokenizer
    from grasp_tpu_torch.models.convert import map_params
    from grasp_tpu_torch.models.llama import ATTN_PROJS, PROJ_ORDER, _proj_shapes, forward
    from grasp_tpu_torch.ops.flash_attention import flash_attention
    from grasp_tpu_torch.ops.saliency import preserve_rank

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt_root = tempfile.mkdtemp(prefix="smoke_grasp_", dir=os.path.join(ROOT, "build"))
    try:
        print(f"compress: grasp-compress-torch {' '.join(COMPRESS_ARGS)} --device {dev}")
        for name in flash_attention.launches:
            flash_attention.launches[name] = 0
        t0 = time.perf_counter()
        rc = compress_main(COMPRESS_ARGS + ["--save_path", ckpt_root, "--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(flash_attention.launches)
        if rc != 0:
            raise AssertionError(f"compress_main returned {rc}")

        params, config, plan, meta = load_checkpoint(ckpt_root, dev)
        layers = meta["redundant_layers"]
        n_layers = config.num_hidden_layers
        if len(set(layers)) != 2 or not all(0 <= li < n_layers for li in layers):
            raise AssertionError(f"block influence chose {layers}, not 2 distinct layers")
        shapes = _proj_shapes(config)
        want_ranks = {module_name(li, proj): preserve_rank(*shapes[proj], 0.9)
                      for li in layers for proj in PROJ_ORDER}
        if meta["rank_dict"] != want_ranks:
            raise AssertionError(f"rank_dict {meta['rank_dict']} != {want_ranks}")
        for li, layer_plan in enumerate(plan):
            want_kind = "lowrank" if li in layers else "dense"
            if any(kind != want_kind for kind in layer_plan):
                raise AssertionError(f"plan of layer {li} is {layer_plan}, want all {want_kind}")
        for name, rank in want_ranks.items():
            li, group, proj = parse_module_name(name)
            got = params["layers"][li][group][proj]
            in_f, out_f = shapes[proj]
            if (tuple(got["in_kernel"].shape), tuple(got["out_kernel"].shape)) != (
                    (in_f, rank), (rank, out_f)):
                raise AssertionError(f"{name}: factors of the wrong shape")
        dense_count = (sum(i * o for i, o in shapes.values()) * n_layers
                       + (2 * n_layers + 1) * config.hidden_size
                       + config.vocab_size * config.hidden_size
                       * (1 if config.tie_word_embeddings else 2))
        count = _param_count(params)
        if not count < dense_count:
            raise AssertionError(f"parameter count {count} did not fall below {dense_count}")

        # every forward runs the forward kernel once per layer; a gradient sweep
        # of an mlp round on layer L runs the backward kernels in the layers
        # above L, of an attention round in layer L as well
        n_batches = len(get_calibration_batches("synthetic", load_tokenizer(None),
                                                num_samples=16, seq_len=2048, seed=42))
        forwards = n_batches * (1 + 2 * len(layers))
        want_fwd = n_layers * forwards
        want_bwd = n_batches * sum((n_layers - 1 - li) + (n_layers - li) for li in layers)
        stages = meta["extra"]["summary"]["stage_times_s"]
        print(f"compress: layers {layers}, importances "
              f"{[round(x, 4) for x in meta['layer_importances']]}")
        print(f"compress: {len(want_ranks)} projections low-rank, ranks "
              f"{sorted(set(want_ranks.values()))}, parameters {dense_count} -> {count}")
        print(f"compress: {n_batches} calibration rows of 2047 tokens, {forwards} forwards; "
              f"flash launches fwd {launches['fwd']} (want {n_layers} x {forwards} = "
              f"{want_fwd}), dkv {launches['dkv']} and dq {launches['dq']} (want {want_bwd})")
        print(f"compress: {wall:.1f} s end to end, stage seconds {stages}; card {card}")
        if launches != {"fwd": want_fwd, "dkv": want_bwd, "dq": want_bwd}:
            raise AssertionError("the sweeps did not run the flash kernels as counted")

        with torch.no_grad():
            ids = torch.tensor(np.random.default_rng(5).integers(0, config.vocab_size, (1, 512)),
                               device=dev)
            logits = forward(params, ids, config=config, plan=plan)["logits"]
        if tuple(logits.shape) != (1, 512, config.vocab_size) or not torch.isfinite(logits).all():
            raise AssertionError("the saved checkpoint's forward is not finite")
        print("compress: the saved checkpoint loads and its forward is finite")
        del params, logits

        # one attention round on the uncompressed model, so that the backward
        # kernels take part: the summed gradients of the flash route and of
        # the plain route (GRASP_FLASH_SWEEP=0), both in bf16, against the
        # plain route in fp32, and the indices each bf16 route selects
        config, dense_params, _, tok = load_model("tinyllama-1.1b", device=dev, dtype="bfloat16",
                                                  seed=42)
        batches = get_calibration_batches("synthetic", tok, num_samples=16, seq_len=2048,
                                          seed=42)[:2]
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
        return launches
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", choices=["flash", "serve", "compress"], default=None,
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
    dev = torch.device("cuda", 0)
    if args.only == "compress":
        print(phase_compress(torch, card, dev))
        return 0
    paged_err = phase_kernel(torch)
    paged = phase_kernel_timing(torch, 22)
    if args.only == "serve":
        print(phase_slice(torch, card, dev))
        return 0
    flash_err = phase_flash(torch)
    flash = phase_flash_timing(torch)
    paged_launches = phase_slice(torch, card, dev)
    flash_launches = phase_compress(torch, card, dev)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "grasp_tpu"))
    if bad:
        raise AssertionError(f"the port imported {bad}")
    flash_src = "grasp_tpu_torch/csrc/flash_attention.cu"
    record = {"kernels": [
        {"name": "paged_attention_decode", "route": "cuda",
         "source": "grasp_tpu_torch/csrc/paged_attention.cu",
         "replaces": "grasp_tpu/ops/pallas_paged64.py:122",
         "launches": paged_launches, "max_abs_err": paged_err, **paged},
        {"name": "flash_attention_fwd", "route": "cuda", "source": flash_src,
         "replaces": "grasp_tpu/ops/pallas_attention.py:138",
         "launches": flash_launches["fwd"], "max_abs_err": flash_err["fwd"], **flash["fwd"]},
        {"name": "flash_attention_bwd_dkv", "route": "cuda", "source": flash_src,
         "replaces": "grasp_tpu/ops/pallas_attention.py:305",
         "launches": flash_launches["dkv"], "max_abs_err": flash_err["dkv"], **flash["dkv"]},
        {"name": "flash_attention_bwd_dq", "route": "cuda", "source": flash_src,
         "replaces": "grasp_tpu/ops/pallas_attention.py:344",
         "launches": flash_launches["dq"], "max_abs_err": flash_err["dq"], **flash["dq"]},
    ]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
