"""Run one function on every rank of a ``dp x tp`` mesh.

The JAX package is one program over all its devices and needs no launcher.
Here each mesh position is a process: :func:`launch` runs ``fn(mesh, *args)``
on ``dp * tp`` ranks and returns each rank's result in rank order.

- Under ``torchrun`` (RANK and WORLD_SIZE in the environment) this process
  is one rank already: it joins the group from the environment, runs ``fn``
  and returns ``[its result]``.
- Otherwise it starts the ranks itself: ``spawn`` processes (the repository
  root on their PYTHONPATH), a free local port as the rendezvous, one PyTorch
  intra-op thread each (ranks share the host's cores). A rank that raises
  ends the run: the others are stopped and :func:`launch` raises with its
  traceback.

Each rank prints the backend rule's result (parallel.mesh.backend_for) once,
from rank 0.
"""

from __future__ import annotations

import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Tuple

from grasp_tpu_torch.parallel.mesh import (DATA_AXIS, DEFAULT_TIMEOUT_S, MODEL_AXIS, Mesh,
                                           distributed_init, make_mesh)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(dp: int, tp: int, device: str, timeout_s: float, address: Optional[str] = None,
           world: Optional[int] = None, rank: Optional[int] = None,
           axis_names: Tuple[str, ...] = (DATA_AXIS, MODEL_AXIS)) -> Mesh:
    dev, reason = distributed_init(address, world, rank, device=device, timeout_s=timeout_s)
    shape = (dp * tp,) if len(axis_names) == 1 else (dp, tp)
    mesh = make_mesh(shape, device=dev, timeout_s=timeout_s, axis_names=axis_names)
    if mesh.rank == 0:
        axes = " x ".join(f"{k} {v}" for k, v in mesh.shape.items())
        print(f"mesh: {axes} = {mesh.size} ranks, backend {mesh.backend} ({reason})",
              flush=True)
    return mesh


def _worker(rank: int, world: int, dp: int, tp: int, address: str, device: str,
            timeout_s: float, axis_names, fn: Callable, args, kwargs, out) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        mesh = _start(dp, tp, device, timeout_s, address, world, rank, axis_names)
        result = fn(mesh, *args, **kwargs)
        out.put((rank, "ok", result))
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable[..., Any], dp: int, tp: int, *args, device: str = "cuda",
           timeout_s: float = DEFAULT_TIMEOUT_S,
           axis_names: Tuple[str, ...] = (DATA_AXIS, MODEL_AXIS), **kwargs) -> List[Any]:
    """``fn(mesh, *args, **kwargs)`` on each of ``dp * tp`` ranks; their
    results in rank order (under torchrun: this rank's alone). ``fn`` and its
    arguments are pickled: a module-level function of an importable module.
    ``timeout_s`` bounds every collective and the whole run's wait.
    ``axis_names`` of one name (``("pipe",)``) makes a one-axis mesh of the
    ``dp * tp`` ranks."""
    axis_names = tuple(axis_names)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        mesh = _start(dp, tp, device, timeout_s, axis_names=axis_names)
        return [fn(mesh, *args, **kwargs)]
    import multiprocessing as mp

    world = dp * tp
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    address = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_worker, args=(r, world, dp, tp, address, device, timeout_s,
                                               axis_names, fn, args, kwargs, out))
             for r in range(world)]
    # the workers import the package from the repository root; a spawned
    # process takes the environment at its start, which is restored after
    path = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(x for x in (ROOT, path) if x)
    try:
        for p in procs:
            p.start()
    finally:
        if path is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = path
    results: List[Any] = [None] * world
    done: set = set()
    error = None
    deadline = time.time() + timeout_s
    try:
        while len(done) < world:
            try:
                rank, status, value = out.get(timeout=1.0)
            except queue.Empty:
                # a rank that died before it could report (it never reached
                # its device, say) ends the run now, not at the deadline
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if dead:
                    error = f"ranks exited before reporting: {dead}"
                elif time.time() > deadline:
                    error = f"the ranks did not finish within {timeout_s:g} s"
                if error is not None:
                    break
                continue
            if status != "ok":
                error = f"rank {rank} failed:\n{value}"
                break
            results[rank] = value
            done.add(rank)
    finally:
        for p in procs:
            if error is not None:
                p.kill()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if error is not None:
        raise RuntimeError(error)
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with {bad}")
    return results
