"""Readings of the host's state around the window, for the record on
standard error: what the process and the machine did while it ran (time
the main thread waited for a CPU, time the hypervisor took, the process's
CPU time, collections of Python's garbage collector), and the card's clocks
and limits once the window has closed. None of it is a metric."""

from __future__ import annotations

import gc
import os
import subprocess
import time
from typing import Dict


def _ints(path: str):
    try:
        with open(path) as f:
            return [int(x) for x in f.read().split()]
    except (OSError, ValueError):
        return []


def _cpu_jiffies() -> Dict[str, int]:
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()[1:]
    except OSError:
        return {}
    names = ("user", "nice", "system", "idle", "iowait", "irq", "softirq", "steal")
    return {n: int(v) for n, v in zip(names, fields)}


class HostProbe:
    """``probe()`` reads the counters whose differences describe a stretch
    of the run; between :meth:`start` and :meth:`stop` it also counts the
    garbage collector's passes and their seconds."""

    def __init__(self):
        self.gc_passes = 0
        self.gc_seconds = 0.0
        self._t = 0.0

    def _on_gc(self, phase, info) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.gc_passes += 1
            self.gc_seconds += time.perf_counter() - self._t

    def start(self) -> None:
        gc.callbacks.append(self._on_gc)

    def stop(self) -> None:
        if self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)

    def __call__(self) -> Dict[str, float]:
        sched = _ints("/proc/thread-self/schedstat")  # ns on a CPU, ns waiting, slices
        out = {"wall": time.perf_counter(), "thread_cpu": time.thread_time(),
               "process_cpu": time.process_time(), "gc_n": self.gc_passes,
               "gc_s": self.gc_seconds}
        if len(sched) >= 2:
            out["run_ns"], out["wait_ns"] = sched[0], sched[1]
        for k, v in _cpu_jiffies().items():
            out["jiffies_" + k] = v
        out["cpu"] = _cpu_now()
        return out


def _cpu_now() -> int:
    """The CPU the calling thread last ran on (field 39 of its stat line)."""
    try:
        with open("/proc/thread-self/stat") as f:
            return int(f.read().rsplit(")", 1)[1].split()[36])
    except (OSError, ValueError, IndexError):
        return -1


def describe(a: Dict[str, float], b: Dict[str, float]) -> str:
    """One line on the stretch from reading ``a`` to reading ``b``."""
    if not a or not b:
        return "not read"
    wall = b["wall"] - a["wall"]
    parts = [f"{wall:.3f} s",
             f"main thread on a CPU {(b['thread_cpu'] - a['thread_cpu']) / wall:.3f}",
             f"process CPU {(b['process_cpu'] - a['process_cpu']) / wall:.3f}"]
    if "wait_ns" in a and "wait_ns" in b:
        parts.append(f"main thread waited for a CPU {(b['wait_ns'] - a['wait_ns']) / 1e6:.1f} ms")
    jiff = {k[8:]: b[k] - a[k] for k in b if k.startswith("jiffies_") and k in a}
    total = sum(jiff.values())
    if total > 0:
        busy = total - jiff.get("idle", 0) - jiff.get("iowait", 0)
        parts.append(f"machine CPUs busy {busy / total:.3f}, "
                     f"steal {jiff.get('steal', 0) / total:.4f}")
    parts.append(f"gc {b['gc_n'] - a['gc_n']} passes {(b['gc_s'] - a['gc_s']) * 1e3:.1f} ms")
    parts.append(f"cpu {a.get('cpu')} -> {b.get('cpu')}")
    parts.append(f"load {os.getloadavg()[0]:.2f}")
    return ", ".join(parts)


def card_state() -> str:
    """The card's clocks, temperature, power and active throttle reasons."""
    q = ("clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu,power.draw,power.limit,"
         "clocks_throttle_reasons.active")
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip() or "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
