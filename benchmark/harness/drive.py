"""Drive the engine under a traffic plan and record what a user sees.

The harness talks to the engine as ``serving/server.py``'s scheduler loop
does: ``submit``, ``step``, then it reads each live request's tokens and
drains the finished ones (``collect_requests``). Every token is stamped with
the host time of the ``step()`` that emitted it; a step ends with the sampled
tokens on the host, so the stamp follows the device's work.

Records: each request (due, sent, token stamps, the engine's request once
finished) and each step (start, end, the prompts it admitted, the contexts
of the rows it decoded). The window opens at a step boundary: for a closed
loop once the first wave is admitted, for an open loop ``warm_seconds`` after
the schedule's origin; it closes ``seconds`` later. A traced run starts the
device trace ``trace_seconds`` before the close (at a step boundary), so the
window's first part runs as an untraced one does and the host-clock readings
come from it (:meth:`Record.untraced_steps`), the device's from the traced
part (:meth:`Record.traced_steps`). Requests due in the
window are all sent; after it closes no new request is sent and the engine
steps on until every request sent in the window has its first token (a
minute at most: one that never comes has failed).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from benchmark.harness.traffic import Plan, Planned

DRAIN_S = 60.0


@dataclass
class ReqRec:
    planned: Planned
    rid: int
    due: float
    sent: float
    in_window: bool
    times: List[float] = field(default_factory=list)
    finished_at: Optional[float] = None
    req: object = None  # the engine's request once finished: prompt, out, finish


@dataclass
class StepRec:
    t0: float
    t1: float
    admitted: List[int]   # prompt lengths whose first token this step emitted
    decoded: List[int]    # context (keys) of every row this step decoded
    useful: List[int]     # of those, rows whose token will be emitted
    waiting: int = 0      # requests sent and not yet admitted after the step


@dataclass
class Record:
    t_start: float = 0.0
    t_end: float = 0.0
    t_trace: Optional[float] = None  # the trace's start; None in an untraced run
    requests: List[ReqRec] = field(default_factory=list)
    steps: List[StepRec] = field(default_factory=list)
    counters_start: Dict[str, float] = field(default_factory=dict)
    counters_trace: Dict[str, float] = field(default_factory=dict)
    counters_end: Dict[str, float] = field(default_factory=dict)
    host_start: Dict[str, float] = field(default_factory=dict)
    host_trace: Dict[str, float] = field(default_factory=dict)

    def _steps(self, a: float, b: float) -> List[StepRec]:
        return [s for s in self.steps if a <= s.t0 < b]

    def window_steps(self) -> List[StepRec]:
        """Steps that started inside the window."""
        return self._steps(self.t_start, self.t_end)

    def host_end(self) -> float:
        """The end of the window's untraced part: the trace's start, or the
        window's close in an untraced run."""
        return self.t_end if self.t_trace is None else self.t_trace

    def untraced_steps(self) -> List[StepRec]:
        """Steps of the window that started before the trace (all of them in
        an untraced run)."""
        return self._steps(self.t_start, self.host_end())

    def traced_steps(self) -> List[StepRec]:
        """Steps that started inside the trace (none in an untraced run)."""
        return self._steps(self.host_end(), self.t_end) if self.t_trace is not None else []


def _counters(engine) -> Dict[str, float]:
    return {"decode_steps": engine.decode_steps, "decode_seconds": engine.decode_seconds}


class Driver:
    """``trace_seconds``: the traced part at the window's end (0: none);
    ``probe()``: a reading of the host's state, taken as the window opens
    and as the trace starts (or the window closes)."""

    def __init__(self, engine, plan: Plan, tracer, clock=time.perf_counter,
                 trace_seconds: float = 0.0, probe=dict):
        self.engine = engine
        self.plan = plan
        self.tracer = tracer
        self.clock = clock
        self.trace_seconds = trace_seconds
        self.probe = probe
        self.traced = False
        self.trace_due = 0.0
        self.rec = Record()
        self.by_rid: Dict[int, ReqRec] = {}
        self.next = 0  # next request of plan.stream

    def submit(self, p: Planned, due: float, in_window: bool) -> ReqRec:
        rid = self.engine.submit(self.plan.prompt(p), p.max_new)
        r = ReqRec(p, rid, due, self.clock(), in_window)
        self.by_rid[rid] = r
        self.rec.requests.append(r)
        return r

    def step(self) -> List[ReqRec]:
        """One engine step and what it emitted; returns the requests that
        finished in it."""
        eng = self.engine
        before = {r.rid: r.pos for r in eng._live if r is not None}
        t0 = self.clock()
        with self.tracer.span("step"):
            eng.step()
        t1 = self.clock()
        with self.tracer.span("collect"):
            finished = eng.collect_requests()
            rows = [r for r in eng._live if r is not None] + finished
            admitted, decoded, useful, done = [], [], [], []
            for r in rows:
                rec = self.by_rid[r.rid]
                if not rec.times and r.out:
                    admitted.append(len(r.prompt))
                rec.times.extend([t1] * (len(r.out) - len(rec.times)))
                pos0 = before.get(r.rid, len(r.prompt))
                if r.pos > pos0:
                    decoded.append(r.pos)
                    if not (r.done and r.finish == "length"):
                        useful.append(r.pos)
                if r.done:
                    rec.finished_at, rec.req = t1, r
                    done.append(rec)
            self.rec.steps.append(StepRec(t0, t1, admitted, decoded, useful,
                                          len(eng._pending)))
        return done

    # -- loops -----------------------------------------------------------------
    def run(self, seconds: float) -> Record:
        if self.plan.traffic["loop"] == "closed":
            self._closed(seconds)
        else:
            self._open(seconds)
        self._drain()
        return self.rec

    def _open_window(self, seconds: float) -> None:
        self.rec.host_start = self.probe()
        self.rec.t_start = self.clock()
        self.rec.t_end = self.rec.t_start + seconds
        self.trace_due = self.rec.t_end - min(self.trace_seconds, seconds)
        self.rec.counters_start = _counters(self.engine)

    def _maybe_trace(self) -> None:
        """At the first step boundary past the trace's due start: the host's
        part ends, the device trace begins."""
        if self.traced or self.trace_seconds <= 0 or self.clock() < self.trace_due:
            return
        self.rec.counters_trace = _counters(self.engine)
        self.rec.host_trace = self.probe()
        self.tracer.start()
        self.rec.t_trace = self.clock()
        self.traced = True

    def _close_window(self) -> None:
        if self.traced:
            self.tracer.stop()
        else:
            self.rec.counters_trace = _counters(self.engine)
            self.rec.host_trace = self.probe()
        self.rec.counters_end = _counters(self.engine)

    def _closed(self, seconds: float) -> None:
        first = [self.submit(p, self.clock(), False) for p in self.plan.first_wave]
        while not all(r.times for r in first):
            self._resubmit(self.step(), in_window=False)
        self._open_window(seconds)
        while self.clock() < self.rec.t_end:
            self._maybe_trace()
            self._resubmit(self.step(), in_window=True)
        self._close_window()

    def _resubmit(self, done: List[ReqRec], in_window: bool) -> None:
        with self.tracer.span("submit"):
            for _ in done:
                p = self.plan.stream[self.next]
                self.next += 1
                self.submit(p, self.clock(), in_window)

    def _open(self, seconds: float) -> None:
        stream = self.plan.stream
        origin = self.clock()
        warm_end = origin + self.plan.traffic.get("warm_seconds", 0.0)
        opened = False
        while True:
            now = self.clock()
            if not opened and now >= warm_end:
                self._open_window(seconds)
                opened = True
            if opened and now >= self.rec.t_end:
                break
            if opened:
                self._maybe_trace()
            self._send_due(origin, now, opened)
            if self.engine.has_work():
                self.step()
            else:
                nxt = origin + stream[self.next].due
                edge = warm_end if not opened else (
                    self.rec.t_end if self.traced or self.trace_seconds <= 0 else self.trace_due)
                until = min(nxt, edge)
                with self.tracer.span("traffic"):
                    time.sleep(max(0.0, until - self.clock()))
        # requests due before the close were due in the window: send them
        self._send_due(origin, self.rec.t_end, opened)
        self._close_window()

    def _send_due(self, origin: float, now: float, opened: bool) -> None:
        stream = self.plan.stream
        with self.tracer.span("submit"):
            while origin + stream[self.next].due <= now:
                due = origin + stream[self.next].due
                self.submit(stream[self.next], due, opened and due >= self.rec.t_start)
                self.next += 1

    def _drain(self) -> None:
        limit = self.clock() + DRAIN_S
        waiting = [r for r in self.rec.requests if r.in_window and not r.times]
        while waiting and self.engine.has_work() and self.clock() < limit:
            self.step()
            waiting = [r for r in waiting if not r.times]
