#!/usr/bin/env python3
"""How far the speculative engine's greedy streams agree with the plain
engine's on one NVIDIA GPU, with bf16 reduced-precision reductions on
(PyTorch's default, which ``grasp-serve-torch`` leaves alone) and off.

    python scripts/spec_agreement_torch.py [--requests 8] [--max_tokens 64] [--gamma 4]

Builds chip_smoke.py's GRASP-compressed TinyLlama-1.1B (bf16, random weights
from a seed) and its int8 draft, and serves the same seeded prompts (70 to 600
tokens) through ServingEngine and SpeculativeServingEngine under each setting.
The chunk attention kernel is bit-equal to the decode kernel either way; the
setting could change whether the library products of the verify step
(batch x (gamma + 1) rows) and of the decode step (batch rows) round alike.
On an H100 it changed nothing in the streams (PERF.md), so the command line
does not touch it. Prints one JSON record. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--max_tokens", type=int, default=64)
    p.add_argument("--gamma", type=int, default=4)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("spec_agreement_torch: needs a CUDA device")
    from chip_smoke import build_flagship, card_line
    from grasp_tpu_torch.ops.quant import quantize_model_weights
    from grasp_tpu_torch.serving.paged import ServingEngine
    from grasp_tpu_torch.serving.spec_paged import SpeculativeServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    config, params, plan = build_flagship(torch, dev)
    draft = quantize_model_weights(params, bits=8)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(3, config.vocab_size, size=int(n))
               for n in np.linspace(70, 600, args.requests)]
    pool = dict(device=dev, num_pages=256, page_size=128, max_batch=8, max_pages_per_seq=16)

    def run(engine):
        rids = [engine.submit(q, args.max_tokens) for q in prompts]
        with torch.no_grad():
            outs = engine.run()
        return [outs[r] for r in rids]

    record = {"card": card_line(), "gamma": args.gamma, "requests": args.requests,
              "max_tokens": args.max_tokens,
              "config": "TinyLlama-1.1B bf16, layers 20-21 low-rank (ratio 0.9), int8 self-draft"}
    for label, allowed in (("reduced_precision_on", True), ("reduced_precision_off", False)):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = allowed
        plain = run(ServingEngine(params, config, plan, **pool))
        spec_engine = SpeculativeServingEngine(params, config, draft, config, plan=plan,
                                               draft_plan=plan, gamma=args.gamma, **pool)
        spec = run(spec_engine)
        agree = [sum(a == b for a, b in zip(s, w)) / len(w) for s, w in zip(spec, plain)]
        record[label] = {"streams_identical": sum(s == w for s, w in zip(spec, plain)),
                         "agreeing_share_per_stream": agree,
                         "mean_agreement": sum(agree) / len(agree),
                         "acceptance_rate": spec_engine.acceptance_rate}
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
