#!/usr/bin/env python3
"""Where a batched decode step of grasp_tpu_torch's serving engine spends its
time, on one NVIDIA GPU.

    python scripts/profile_serving_torch.py [--steps 20] [--quantize none|int8|int4]
                                            [--speculative none|int8] [--gamma 4]
                                            [--model tinyllama|phi3|gemma7b] [--quantized_kv]
                                            [--out build/serving_profile.json]

Builds chip_smoke.py's GRASP-compressed TinyLlama-1.1B, or with ``--model
phi3`` Phi-3-mini-4k (32 layers, 32 MHA heads of 96) or ``--model gemma7b``
Gemma-7B (28 layers, 16 MHA heads of 256) compressed the same way (bf16,
random weights from a seed, the last two layers low-rank), quantizes its weights if asked (as ``grasp-serve-torch
--quantize`` does), admits 8 requests with the smoke's prompt lengths into a
ServingEngine with the grasp-serve-torch defaults (``--quantized_kv``: int8
pages with their per-slot scales, as ``grasp-serve-torch --quantized_kv``),
and then

- times ``--steps`` decode steps on the host clock (each step ends with the
  sampled tokens on the host, so the clock covers the device work);
- profiles as many steps with torch.profiler: device time by kernel, kernel
  launches per step, and the device's busy and idle share of the window.

With ``--speculative int8`` the engine is the speculative one (an int8 copy of
the weights drafts ``--gamma`` tokens, the served weights verify) and a step
is a macro-step: the record then also splits host time, device time, idle
share and launches into the draft, verify and accept phases. For that split
each phase ends with a synchronisation, which the engine itself does not do:
the macro-step's own time is taken first, without them; then the phases' host
times, with them and without the profiler (which slows a host-bound loop
severalfold); then their device times and launches, under the profiler.
``device_idle_share`` is the idle share of the profiled window;
``device_idle_share_unprofiled`` holds the device time against the step's
host time without the profiler.

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


MODELS = {"tinyllama": "TinyLlama-1.1B", "phi3": "Phi-3-mini-4k", "gemma7b": "Gemma-7B"}


def _kind(name: str) -> str:
    if "paged_decode" in name:  # paged_decode_kernel (fp32), paged_decode_mma_kernel (bf16)
        return "paged_attention (K3)"
    if "paged_chunk" in name:
        return "paged_attention_chunk (K4)"
    if "int4_" in name:  # the grid or dma kernel (fp32: and the reduction of its splits)
        return "int4_matmul (K5)"
    low = name.lower()
    if any(s in low for s in ("gemm", "gemv", "cutlass", "xmma", "cublas", "nvjet")):
        return "matmul"
    return "other"


PHASES = ("draft", "verify", "accept")


def _label_phases(torch, engine, clock):
    """Make each phase of the speculative macro-step a labelled profiler range
    that ends synchronised, so that the kernels it launched lie inside it, and
    add its host seconds to ``clock[name]``."""
    from torch.profiler import record_function

    def labelled(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            with record_function(f"phase:{name}"):
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            clock[name] += time.perf_counter() - t0
            return out
        return run

    engine._dmulti = labelled("draft", engine._dmulti)
    engine._verify = labelled("verify", engine._verify)
    engine._accept = labelled("accept", engine._accept)


def _by_phase(torch, prof, kernels, host_s, steps):
    """Per macro-step and phase: host ms (``host_s``: seconds over ``steps``
    macro-steps without the profiler), device busy ms and launches (a kernel
    belongs to the phase whose profiled range on the host holds its start),
    and the idle share of the first against the second."""
    out = {}
    for name in PHASES:
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.name == f"phase:{name}"
                       and e.device_type == torch.autograd.DeviceType.CPU)
        inside = [k for k in kernels
                  if any(start <= k.time_range.start < end for start, end in spans)]
        busy_ms = sum(k.time_range.elapsed_us() for k in inside) / 1e3 / steps
        host_ms = host_s[name] * 1e3 / steps
        out[name] = {"host_ms": host_ms, "device_busy_ms": busy_ms,
                     "device_idle_share": 1.0 - busy_ms / max(host_ms, 1e-9),
                     "kernel_launches": len(inside) / steps}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--quantize", choices=["none", "int8", "int4"], default="none")
    p.add_argument("--speculative", choices=["none", "int8"], default="none")
    p.add_argument("--gamma", type=int, default=4)
    p.add_argument("--model", choices=["tinyllama", "phi3", "gemma7b"], default="tinyllama")
    p.add_argument("--quantized_kv", action="store_true")
    p.add_argument("--out", default=os.path.join(ROOT, "build", "serving_profile.json"))
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_serving_torch: needs a CUDA device")
    from chip_smoke import PROMPT_LENS, build_flagship, card_line
    from grasp_tpu_torch import ModelConfig
    from grasp_tpu_torch.ops._build import load_library
    from grasp_tpu_torch.ops.quant import quantize_model_weights, quantized_size_bytes
    from grasp_tpu_torch.serving.paged import ServingEngine
    from grasp_tpu_torch.serving.spec_paged import SpeculativeServingEngine

    load_library()  # build the kernels before anything is timed
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    config, params, plan = build_flagship(torch, dev, {
        "tinyllama": None, "phi3": ModelConfig.phi3_mini_4k(),
        "gemma7b": ModelConfig.gemma_7b()}[args.model])
    last = config.num_hidden_layers - 1
    speculative = args.speculative == "int8"
    draft = quantize_model_weights(params, bits=8) if speculative else None
    if args.quantize != "none":
        params = quantize_model_weights(params, bits=8 if args.quantize == "int8" else 4,
                                        consume=True)
        torch.cuda.empty_cache()
    weight_bytes = quantized_size_bytes(params)
    pool = dict(device=dev, num_pages=256, page_size=128, max_batch=8, max_pages_per_seq=16,
                quantized_kv=args.quantized_kv)
    if speculative:
        engine = SpeculativeServingEngine(params, config, draft, config, plan=plan,
                                          draft_plan=plan, gamma=args.gamma, **pool)
    else:
        engine = ServingEngine(params, config, plan, **pool)
    rng = np.random.default_rng(0)
    # every row stays live through both windows (a macro-step emits up to gamma + 1 tokens)
    max_new = (3 * args.steps + 10) * (args.gamma + 1 if speculative else 1)
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

    if speculative:
        clock = dict.fromkeys(PHASES, 0.0)
        _label_phases(torch, engine, clock)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            engine.step()
        phased_ms = (time.perf_counter() - t0) * 1e3 / args.steps
        phase_host_s = dict(clock)
        engine.last_stats.update(chunks=0, drafted=0, accepted=0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            engine.step()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    live = sum(r is not None for r in engine._live)

    # device-side copies of the phase labels are ranges, not kernels
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("phase:")]
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
        "config": f"{MODELS[args.model]} bf16, {last + 1} layers, layers {last - 1}-{last} "
                  f"low-rank (ratio 0.9), batch 8, page 128",
        "quantize": args.quantize,
        "kv_pages": "int8" if args.quantized_kv else "bf16",
        "param_bytes": weight_bytes,
        "live_rows": live,
        "first_step_s_admits_8_prompts": admit_s,
        "decode_step_ms_host": step_ms,
        "profiled_steps": args.steps,
        "profiled_window_ms": window_us / 1e3,
        "device_busy_ms_per_step": busy_us / 1e3 / args.steps,
        "device_idle_share": 1.0 - busy_us / window_us,
        "device_idle_share_unprofiled": 1.0 - busy_us / 1e3 / args.steps / step_ms,
        "kernel_launches_per_step": len(kernels) / args.steps,
        "device_ms_per_step_by_kind": {k: v / 1e3 / args.steps for k, v in by_kind.items()},
        "top_kernels_ms_per_step": [[n[:120], v / 1e3 / args.steps] for n, v in top],
    }
    if speculative:
        stats = engine.last_stats
        record.update({
            "speculative": f"int8 draft, gamma {args.gamma}",
            "note": "a step is a macro-step; decode_step_ms_host has no synchronisation inside "
                    "it, macro_step_ms_host_phased one after each phase",
            "macro_step_ms_host_phased": phased_ms,
            "acceptance_rate": engine.acceptance_rate,
            "tokens_per_row_per_macro_step": (stats["accepted"] + stats["chunks"])
            / max(stats["chunks"], 1),
            "phases_per_macro_step": _by_phase(torch, prof, kernels, phase_host_s, args.steps),
        })
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    prof.export_chrome_trace(os.path.splitext(args.out)[0] + "_trace.json")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
