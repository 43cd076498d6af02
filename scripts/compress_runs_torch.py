#!/usr/bin/env python3
"""Wall time, stage seconds, flash launches and peak memory of
``grasp-compress-torch`` on one NVIDIA GPU, sequential and parallel, in turns.

    python scripts/compress_runs_torch.py [--parent DIR] [--rows 16]
                                          [--out build/compress_runs.json]

Each turn is one process that imports ``grasp_tpu_torch`` from one tree and
runs chip_smoke.py's compression (TinyLlama-1.1B at full width and depth,
bf16, random weights from a seed, 2 layers at ratio 0.9, ``--rows``
synthetic rows of 2047 tokens) with ``--sweep sequential`` and then
``--sweep parallel``, after an untimed one-row run that builds the kernels
and starts the libraries; a tree whose CLI refuses the parallel sweep
records that. With ``--parent`` (an unpacked ``git archive`` of another commit) the
turns are parent, change, change, parent; without it change, change. Prints
the card's line and one JSON record, and writes the record to ``--out``.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _turn(tree: str, rows: int) -> list:
    """Both runs in this process, from ``tree``'s package."""
    sys.path.insert(0, tree)
    import torch

    from grasp_tpu_torch.cli import compress_main
    from grasp_tpu_torch.ops.flash_attention import flash_attention

    if not torch.cuda.is_available():
        raise SystemExit("compress_runs_torch: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False

    def cli_args(n_rows):
        return ["--model_name_or_path", "tinyllama-1.1b", "--dataset_name", "synthetic",
                "--num_prune_layers", "2", "--compression_ratio", "0.9", "--num_samples",
                str(n_rows), "--seq_len", "2048", "--dtype", "bfloat16", "--device", "cuda"]

    out = []
    os.makedirs(os.path.join(tree, "build"), exist_ok=True)
    # untimed: build the kernels and start cuBLAS, cuSOLVER and the caching
    # allocator with a one-row compression, so that neither timed run pays them
    warm = tempfile.mkdtemp(prefix="compress_runs_", dir=os.path.join(tree, "build"))
    compress_main(cli_args(1) + ["--save_path", warm])
    for sweep in ("sequential", "parallel"):
        save = tempfile.mkdtemp(prefix="compress_runs_", dir=os.path.join(tree, "build"))
        for name in flash_attention.launches:
            flash_attention.launches[name] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            compress_main(cli_args(rows) + ["--sweep", sweep, "--save_path", save])
        except NotImplementedError as e:
            out.append({"sweep": sweep, "refused": str(e)})
            continue
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(os.path.join(save, "grasp_meta.json")) as f:
            meta = json.load(f)
        summary = meta["extra"]["summary"]
        out.append({"sweep": sweep, "wall_s": wall, "engine_wall_s": summary["wall_clock_s"],
                    "stage_times_s": summary["stage_times_s"],
                    "prefix": summary.get("prefix", "off"),
                    "layers": meta["redundant_layers"], "launches": dict(flash_attention.launches),
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        shutil.rmtree(save)
    shutil.rmtree(warm)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", default=None, help="another commit's tree, for turns")
    parser.add_argument("--rows", type=int, default=16)
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "compress_runs.json"))
    parser.add_argument("--tree", default=None, help=argparse.SUPPRESS)  # one turn
    args = parser.parse_args(argv)
    if args.tree:
        print(json.dumps(_turn(args.tree, args.rows)))
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                           "-i", "0"], capture_output=True, text=True, check=True).stdout.strip()
    turns = ([("parent", args.parent), ("change", ROOT), ("change", ROOT), ("parent", args.parent)]
             if args.parent else [("change", ROOT), ("change", ROOT)])
    record = {"card": card, "rows": args.rows, "turns": []}
    for label, tree in turns:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree",
                               os.path.abspath(tree), "--rows", str(args.rows)],
                              capture_output=True, text=True, cwd=tree)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"compress_runs_torch: the {label} turn failed")
        runs = json.loads(proc.stdout.strip().splitlines()[-1])
        record["turns"].append({"tree": label, "runs": runs})
        for run in runs:
            print(label, json.dumps(run))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(card)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
