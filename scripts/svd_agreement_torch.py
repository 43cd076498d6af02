#!/usr/bin/env python3
"""How each SVD method of grasp_tpu_torch selects against an fp64 SVD, on
one NVIDIA GPU, at the compression smoke's cell.

    python scripts/svd_agreement_torch.py [--rows 16] [--out build/svd_agreement.json]

Builds chip_smoke.py's TinyLlama-1.1B (full width, bf16, random weights from
seed 42) and its synthetic calibration rows of 2047 tokens, sums the dense
gradients of the last two layers' fourteen projections in one sweep, and for
every projection factors the kernel with each of the port's methods
(``device``, ``host``, ``gram``, ``gram_device``, and the U-free selection on
the gram basis), with ``torch.linalg.svd`` in fp32 on the card as it runs
by default (``fp32-default``) and with cuSOLVER's gesvd (``fp32-gesvd``),
and in float64 (``fp64``, the reference). For each: the
share of the Taylor-selected indices at ratio 0.9 it shares with the fp64
selection and with ``device``, the largest relative error of its importances
against fp64 over the selected ones, its seconds, and the orthogonality
error of its small-side factor. Prints the card's line and one JSON record,
and writes it to ``--out``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows", type=int, default=16)
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "svd_agreement.json"))
    args = parser.parse_args(argv)
    import torch

    from grasp_tpu_torch.cli import load_model
    from grasp_tpu_torch.core.engine import GraspEngine, module_name
    from grasp_tpu_torch.data.loader import get_calibration_batches
    from grasp_tpu_torch.models.llama import PROJ_ORDER
    from grasp_tpu_torch.ops.saliency import preserve_rank, select_topk
    from grasp_tpu_torch.ops.svd import gram_basis, svd, ufree_sigma_saliency

    if not torch.cuda.is_available():
        raise SystemExit("svd_agreement_torch: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                           "-i", "0"], capture_output=True, text=True, check=True).stdout.strip()
    config, params, _, tok = load_model("tinyllama-1.1b", device=dev, dtype="bfloat16", seed=42)
    batches = get_calibration_batches("synthetic", tok, num_samples=args.rows, seq_len=2048,
                                      seed=42)
    engine = GraspEngine(params, config, device=dev)
    engine._maybe_enable_flash_sweep(batches)
    top_layers = (config.num_hidden_layers - 1, config.num_hidden_layers - 2)
    names = [module_name(li, p) for li in top_layers for p in PROJ_ORDER]
    grads = engine.get_dense_gradients(names, batches)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    record = {"card": card, "rows": args.rows, "modules": {}}
    for n in names:
        kernel = engine._get_proj(n)["kernel"]
        w, g = kernel.T.float(), grads[n].T.float()
        out_f, in_f = w.shape
        k = preserve_rank(in_f, out_f, 0.9)
        imps, secs, ortho = {}, {}, {}
        for method in ("fp64", "fp32-default", "fp32-gesvd", "device", "host", "gram",
                       "gram_device"):
            if method == "fp64":
                (u, s, vh), dt = timed(lambda: torch.linalg.svd(w.double(), full_matrices=False))
            elif method == "fp32-default":
                (u, s, vh), dt = timed(lambda: torch.linalg.svd(w, full_matrices=False))
            elif method == "fp32-gesvd":
                (u, s, vh), dt = timed(lambda: torch.linalg.svd(w, full_matrices=False,
                                                                driver="gesvd"))
            else:
                (u, s, vh), dt = timed(lambda m=method: svd(w, method=m))
            # |s_i u_i^T G v_i| in fp64 from each method's factors
            u, s, vh = u.double(), s.double(), vh.double()
            imps[method] = (s * torch.sum(u * (g.double() @ vh.T), dim=-2)).abs()
            small = u if out_f <= in_f else vh.T
            eye = torch.eye(small.shape[-1], device=dev, dtype=torch.float64)
            ortho[method] = (small.double().T @ small.double() - eye).abs().max().item()
            secs[method] = dt
        (s, basis, side), dt = timed(lambda: gram_basis(w))
        imps["ufree"] = ufree_sigma_saliency(w, g, s, basis, side, "taylor").double()
        secs["ufree"] = dt
        ref = set(select_topk(imps["fp64"], k).tolist())
        dev_set = set(select_topk(imps["device"], k).tolist())
        row = {"shape": [out_f, in_f], "k": k}
        for method, imp in imps.items():
            got = set(select_topk(imp, k).tolist())
            top = torch.tensor(sorted(ref), device=dev)
            rel = ((imp[top] - imps["fp64"][top]).abs() / imps["fp64"][top]).max().item()
            row[method] = {"share_fp64": len(got & ref) / k, "share_device": len(got & dev_set) / k,
                           "importance_rel_err": rel, "seconds": secs[method],
                           "orthogonality_err": ortho.get(method)}
        record["modules"][n] = row
        print(n, json.dumps(row))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(card)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
