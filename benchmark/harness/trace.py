"""The device trace of a ``--trace 1`` run: torch.profiler over the window,
device activity only (CUPTI: kernels, copies, fills, and the CUDA runtime
calls that launched them), read back from its raw events.

Host operations are not recorded: on a host-paced loop that doubles a step's
time. The harness keeps its own host spans (``step``, ``collect``,
``submit``, ``traffic``) on its own clock and maps them onto the trace's:
the window opens and closes with a one-element fill on an idle device, the
first and the last device operation of the trace, so the first one's start
is the host's window start. From the trace: the window's length, the seconds
in which any device operation ran (the union of their intervals), device
seconds by operation name, and the idle gaps, each labelled by the harness
span and the CUDA runtime call running when it began.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

import numpy as np


class NoTrace:
    """The tracer of a ``--trace 0`` run: spans cost nothing."""

    def prime(self) -> None:
        pass

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def span(self, name: str):
        return contextlib.nullcontext()


class Tracer(NoTrace):
    def __init__(self):
        self.prof = None
        self.flag = None
        self.spans: List[Tuple[str, int, int]] = []
        self.t_open = 0

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CUDA])

    def prime(self) -> None:
        """A first profiler session over one device operation: the
        profiler's own start-up (CUPTI's) is paid in set-up, not in the
        window."""
        import torch

        self.flag = torch.zeros(1, device="cuda")
        with self._profile():
            self.flag.fill_(1.0)
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch

        self.prof = self._profile()
        self.prof.start()
        torch.cuda.synchronize()
        self.t_open = time.perf_counter_ns()
        self.flag.fill_(1.0)

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.flag.fill_(2.0)
        torch.cuda.synchronize()
        self.prof.stop()

    @contextlib.contextmanager
    def span(self, name: str):
        t = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.append((name, t, time.perf_counter_ns()))

    def summary(self) -> "TraceSummary":
        return TraceSummary.of(self.prof.profiler.kineto_results.events(), self.spans,
                               self.t_open)


def _times(e) -> Tuple[int, int]:
    """(start, end) of a raw event in ns."""
    if hasattr(e, "start_ns"):
        s = e.start_ns()
        return s, s + e.duration_ns()
    s = int(e.start_us() * 1000)
    return s, s + int(e.duration_us() * 1000)


class TraceSummary:
    def __init__(self, dev: List[Tuple[str, int, int]], runtime: List[Tuple[str, int, int]],
                 spans: List[Tuple[str, int, int]]):
        s = np.array([a for _, a, _ in dev], dtype=np.int64)
        e = np.array([b for _, _, b in dev], dtype=np.int64)
        self.w0, self.w1 = int(s.min()), int(e.max())
        self.window_s = (self.w1 - self.w0) / 1e9
        self.device_events = len(dev)
        self.by_name: Dict[str, float] = {}
        for (n, _, _), d in zip(dev, (e - s).tolist()):
            self.by_name[n] = self.by_name.get(n, 0.0) + d / 1e9
        self.gaps = self._gaps(s, e)
        self.busy_s = self.window_s - sum(b - a for a, b in self.gaps) / 1e9
        labels = spans + runtime
        self.label_names = [n for n, _, _ in labels]
        self.label_s = np.array([a for _, a, _ in labels], dtype=np.int64)
        self.label_e = np.array([b for _, _, b in labels], dtype=np.int64)

    @classmethod
    def of(cls, events, spans: List[Tuple[str, int, int]], t_open: int) -> "TraceSummary":
        """From the raw events and the harness's spans (host clock, shifted
        so that ``t_open`` falls on the first device operation's start)."""
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        dev, runtime = [], []
        for ev in events:
            s, e = _times(ev)
            (dev if ev.device_type() == cuda else runtime).append((ev.name(), s, e))
        if not dev:
            raise RuntimeError("the profiler recorded no device operation")
        shift = min(s for _, s, _ in dev) - t_open
        spans = [("span:" + n, a + shift, b + shift) for n, a, b in spans]
        return cls(dev, runtime, spans)

    def _gaps(self, s: np.ndarray, e: np.ndarray) -> List[Tuple[int, int]]:
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
        reach = np.maximum.accumulate(e)
        idle = s[1:] > reach[:-1]
        return list(zip(reach[:-1][idle].tolist(), s[1:][idle].tolist()))

    def kernel_seconds(self, part: str) -> float:
        """Device seconds of the operations whose name holds ``part``."""
        return sum(v for n, v in self.by_name.items() if part in n)

    def label(self, t: int) -> str:
        """What the host was doing at ``t``: the harness span, and the CUDA
        runtime call, running then."""
        span, call = "none", ""
        for i in np.nonzero((self.label_s <= t) & (self.label_e > t))[0].tolist():
            name = self.label_names[i]
            if name.startswith("span:"):
                span = name[5:]
            else:
                call = name
        return f"{span}/{call}" if call else span

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:top]
        longest = sorted(self.gaps, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:160], v] for n, v in ops],
                "idle_gaps": [[self.label(a), (b - a) / 1e9] for a, b in longest]}
