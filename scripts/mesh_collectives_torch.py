#!/usr/bin/env python3
"""What torch.distributed offers ranks that share one NVIDIA GPU, and what
the mesh's collectives cost there.

    python scripts/mesh_collectives_torch.py [--world 4] [--out build/mesh_collectives.json]

Starts ``--world`` processes on ``cuda:0`` and asks, in this order:

1. whether NCCL initialises two ranks on one device and runs an all_reduce
   on it (its answer, or its error, is recorded; NCCL is then torn down);
2. which gloo collectives take CUDA tensors: broadcast, all_reduce,
   all_gather, reduce_scatter, each held to its expected value;
3. what gloo's all_reduce of a CUDA tensor costs at the sizes of a
   compression sweep on TinyLlama-1.1B under ``--dp 2 --tp 2`` (8 rows of
   2047 tokens of hidden 2048: 67 MB in bf16, 134 MB in fp32) and of a
   decode step (one row's hidden), median of 5 after one warm-up, over the
   whole world and over pairs of ranks (the model groups of a 2 x 2 mesh);
4. whether gloo's point-to-point ``isend``/``irecv`` take a CUDA tensor
   directly (two ranks; the answer, an error or a crash, is recorded);
5. what ``parallel.mesh.Mesh.ppermute`` (CUDA tensors staged through host
   buffers) costs for one step of the ring over the whole world at ring
   attention's K/V block of TinyLlama-1.1B (2 x 4 KV heads x 2048 tokens x
   64 in bf16 and fp32), and a pipeline stage's send and receive of 256 rows
   of hidden 2048 in fp32, median of 5 after one warm-up.

Prints the card's line and one JSON record, and writes it to ``--out``.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SIZES = {  # name -> (elements, dtype name)
    "sweep_bf16_8x2047x2048": (8 * 2047 * 2048, "bfloat16"),
    "sweep_fp32_8x2047x2048": (8 * 2047 * 2048, "float32"),
    "decode_bf16_8x2048": (8 * 2048, "bfloat16"),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _nccl_probe(rank: int, world: int, port: int, q) -> None:
    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=60),
                                device_id=torch.device("cuda", 0))
        x = torch.full((4,), float(rank + 1), device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        q.put((rank, "ok", float(x[0])))
        dist.destroy_process_group()
    except Exception as e:  # the answer is the error: record it
        q.put((rank, "error", f"{type(e).__name__}: {str(e)[:400]}"))


def _gloo_worker(rank: int, world: int, port: int, q) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    dev = torch.device("cuda", 0)
    out = {"rank": rank, "ops": {}, "ms": {}}

    def check(name, fn):
        try:
            ok = bool(fn())
            out["ops"][name] = "ok" if ok else "wrong value"
        except Exception as e:  # record what the backend refuses
            out["ops"][name] = f"{type(e).__name__}: {str(e)[:200]}"

    def bcast():
        x = torch.full((8,), float(rank), device=dev)
        dist.broadcast(x, 0)
        return float(x.sum()) == 0.0

    def allreduce():
        x = torch.full((8,), float(rank + 1), device=dev)
        dist.all_reduce(x)
        return float(x[0]) == world * (world + 1) / 2

    def allgather():
        x = torch.full((2,), float(rank), device=dev)
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        return [float(p[0]) for p in parts] == [float(r) for r in range(world)]

    def reducescatter():
        x = [torch.full((2,), float(rank + 1), device=dev) for _ in range(world)]
        y = torch.empty(2, device=dev)
        dist.reduce_scatter(y, x)
        return float(y[0]) == world * (world + 1) / 2

    for name, fn in (("broadcast", bcast), ("all_reduce", allreduce),
                     ("all_gather", allgather), ("reduce_scatter", reducescatter)):
        check(name, fn)
        dist.barrier()

    pairs = [dist.new_group([r, r + 1]) for r in range(0, world - 1, 2)] if world >= 2 else []
    mine = pairs[rank // 2] if rank // 2 < len(pairs) else None
    for label, group in (("world", None), ("pair", mine)):
        if label == "pair" and mine is None:
            continue
        for name, (n, dt) in SIZES.items():
            x = torch.ones(n, dtype=getattr(torch, dt), device=dev)
            times = []
            for i in range(6):
                dist.barrier()
                torch.cuda.synchronize()
                t = time.perf_counter()
                dist.all_reduce(x, group=group)
                torch.cuda.synchronize()
                if i:
                    times.append((time.perf_counter() - t) * 1e3)
            times.sort()
            out["ms"][f"{label}:{name}"] = {"median": times[len(times) // 2],
                                            "min": times[0], "max": times[-1],
                                            "bytes": n * x.element_size()}
    q.put(out)
    dist.barrier()
    dist.destroy_process_group()


def _p2p_probe(rank: int, world: int, port: int, q) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    x = torch.full((8,), float(rank + 1), device="cuda")
    try:
        req = dist.isend(x, 1) if rank == 0 else dist.irecv(x, 0)
        req.wait()
        torch.cuda.synchronize()
        q.put((rank, "ok" if float(x[0]) == 1.0 else "wrong value", float(x[0])))
    except Exception as e:  # the answer is the error: record it
        q.put((rank, "error", f"{type(e).__name__}: {str(e)[:300]}"))
    dist.destroy_process_group()


P2P_SIZES = {  # name -> (shape, dtype name)
    "ring_kv_bf16_2x1x4x2048x64": ((2, 1, 4, 2048, 64), "bfloat16"),
    "ring_kv_fp32_2x1x4x2048x64": ((2, 1, 4, 2048, 64), "float32"),
    "stage_fp32_256x2048": ((1, 256, 2048), "float32"),
}


def _ppermute_worker(rank: int, world: int, port: int, q) -> None:
    import torch

    from grasp_tpu_torch.parallel.mesh import distributed_init, make_mesh

    dev, _ = distributed_init(f"127.0.0.1:{port}", world, rank, device="cuda", timeout_s=120)
    mesh = make_mesh((world, 1), device=dev, timeout_s=120)
    ring = [(j, (j + 1) % world) for j in range(world)]
    out = {"rank": rank, "ms": {}}
    for name, (shape, dt) in P2P_SIZES.items():
        x = torch.full(shape, float(rank), dtype=getattr(torch, dt), device=dev)
        times = []
        for i in range(6):
            mesh.barrier()
            torch.cuda.synchronize()
            t = time.perf_counter()
            if name.startswith("stage"):  # rank r sends to r + 1, receives from r - 1
                sent = mesh.send(x, "data", rank + 1, tag=i) if rank + 1 < world else None
                if rank:
                    y = mesh.recv(x, "data", rank - 1, tag=i)
                if sent is not None:
                    sent.wait()
            else:
                y = mesh.ppermute(x, "data", ring)
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t) * 1e3)
        if rank:
            assert float(y.flatten()[0]) == float(rank - 1)
        times.sort()
        out["ms"][name] = {"median": times[len(times) // 2], "min": times[0],
                           "max": times[-1], "bytes": x.numel() * x.element_size()}
    q.put(out)
    mesh.barrier()
    import torch.distributed as dist

    dist.destroy_process_group()


def _run(target, world: int, timeout: float):
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=target, args=(r, world, port, q)) for r in range(world)]
    for p in procs:
        p.start()
    got, deadline = [], time.time() + timeout
    while len(got) < world and time.time() < deadline:
        try:
            got.append(q.get(timeout=max(deadline - time.time(), 0.1)))
        except Exception:  # queue.Empty: the deadline passed
            break
    for p in procs:
        p.join(timeout=10)
        if p.is_alive():
            p.kill()
            p.join()
    return got, [p.exitcode for p in procs]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--world", type=int, default=4)
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "mesh_collectives.json"))
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("mesh_collectives_torch: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                           "-i", "0"], capture_output=True, text=True, check=True).stdout.strip()
    record = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "world": args.world}
    nccl, codes = _run(_nccl_probe, 2, 120)
    record["nccl_two_ranks_one_device"] = {"answers": sorted(nccl), "exit_codes": codes}
    gloo, codes = _run(_gloo_worker, args.world, 600)
    record["gloo_exit_codes"] = codes
    record["gloo"] = sorted(gloo, key=lambda r: r["rank"])
    p2p, p2p_codes = _run(_p2p_probe, 2, 120)
    record["gloo_isend_irecv_cuda"] = {"answers": sorted(p2p), "exit_codes": p2p_codes}
    perm, perm_codes = _run(_ppermute_worker, args.world, 600)
    record["ppermute_exit_codes"] = perm_codes
    record["ppermute_staged"] = sorted(perm, key=lambda r: r["rank"])
    codes = codes + perm_codes
    ok = len(gloo) == args.world and len(perm) == args.world
    print(card)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))
    return 0 if all(c == 0 for c in codes) and ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
