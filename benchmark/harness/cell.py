"""One run of one cell: set-up, the window, the metrics, the check."""

from __future__ import annotations

import gc
import math
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

from benchmark.harness import check, hoststate, port
from benchmark.harness.drive import Driver, Record
from benchmark.harness.spec import Cell
from benchmark.harness.trace import NoTrace, Tracer, TraceSummary
from benchmark.harness.traffic import Plan, Planned, pages_per_seq
from benchmark.harness.weights import head_dim, make_weights, shapes_of, weight_bytes
from benchmark.metrics import reader
from benchmark.metrics.yardstick import ModelCounts, peaks, projection_macs

FORBIDDEN = ("jax", "jaxlib", "flax", "grasp_tpu")
TRACE_S = 10.0  # a traced run's device trace: the window's last seconds


@dataclass
class Run:
    """What a metric reader reads."""
    rec: Record
    seconds: float
    setup_s: float
    model: ModelCounts
    lowrank: List[Tuple[int, int, int]]
    trace: Optional[TraceSummary]
    peaks: Optional[dict]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def model_counts(cfg: dict, w) -> ModelCounts:
    return ModelCounts(projection_macs(shapes_of(w, cfg)), cfg["num_hidden_layers"],
                       cfg["num_attention_heads"], cfg["num_key_value_heads"], head_dim(cfg),
                       cfg["hidden_size"], cfg["vocab_size"], cfg.get("sliding_window"),
                       port.quantized_kv(cfg))


def warm(engine, plan: Plan) -> None:
    """Admit one request at every padded prompt length the plan holds, and
    decode it twice: every shape of the cell runs once before the window."""
    ps = plan.traffic["page_size"]
    for i, pad in enumerate(plan.distinct_pads()):
        p = Planned((1 << 40) + i, pad - ps // 2, 2)  # indices no real request has
        engine.submit(plan.prompt(p), p.max_new)
    engine.run()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_process: float, limit_table: Optional[dict] = None, drive_hook=None,
             check_output: bool = True, control: bool = False) -> Tuple[dict, Run]:
    """(the result line's object, the run its metrics were read from).
    ``drive_hook(engine)`` may wrap the engine before the window (the
    harness's fault tests break the timed path so); ``check_output=False``
    skips the reference (rate sweeps); ``control`` adds the control's reading
    to the checks (calibration)."""
    import torch

    torch.set_num_threads(2)
    cfg, traffic = cell.config, cell.traffic
    cuda = device == "cuda"
    marks = [("start", t_process), ("imports", time.perf_counter())]
    w = make_weights(cfg, seed, device)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("weights", time.perf_counter()))
    pages = pages_per_seq(traffic)
    engine = port.make_engine(cfg, w, device=device, max_batch=traffic["max_batch"],
                              pages_per_seq=pages, page_size=traffic["page_size"])
    marks.append(("engine", time.perf_counter()))
    say(f"gbench: {cell.name}: {weight_bytes(w)} weight bytes, {traffic['max_batch']} rows, "
        f"{pages} pages of {traffic['page_size']} a row, decode route {engine.route}")
    if engine.route[0] != "kernel":
        raise RuntimeError(f"{cell.name}: decode would take the {engine.route[0]} route, "
                           f"not the paged kernel: {engine.route[1]}")
    plan = Plan(traffic, seed, cfg["vocab_size"])
    warm(engine, plan)
    if drive_hook is not None:
        drive_hook(engine)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("warm", time.perf_counter()))
    tracer = Tracer() if trace else NoTrace()
    tracer.prime()
    marks.append(("profiler", time.perf_counter()))
    probe = hoststate.HostProbe()
    probe.start()
    try:
        rec = Driver(engine, plan, tracer, trace_seconds=TRACE_S if trace else 0.0,
                     probe=probe).run(seconds)
    finally:
        probe.stop()
    marks.append(("ramp", rec.t_start))
    setup_s = rec.t_start - t_process
    say("gbench: set-up s by part: " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:])))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    summary = tracer.summary() if trace else None
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    lowrank = [s for s in shapes_of(w, cfg) if len(s) == 3]
    run = Run(rec, seconds, setup_s, model_counts(cfg, w), lowrank, summary, peaks(kind))
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if trace:  # the end-to-end numbers of the traced run, for comparison only
        for m in cell.end_to_end:
            v = reader(m["name"])(run)
            say(f"gbench: traced run's {m['name']} {v}")
    sent = [r for r in rec.requests if r.in_window]
    late = sorted(r.sent - r.due for r in sent)
    if late:
        say(f"gbench: generator lateness over {len(late)} requests: median "
            f"{late[len(late) // 2] * 1e3:.3f} ms, max {late[-1] * 1e3:.3f} ms")
    say(f"gbench: window {len(rec.window_steps())} steps ({len(rec.untraced_steps())} "
        f"before the trace), engine counters {rec.counters_start} -> {rec.counters_trace} -> "
        f"{rec.counters_end}, {port.kernel_counters()}")
    say("gbench: host over the window" + (" before the trace" if trace else "") + ": "
        + hoststate.describe(rec.host_start, rec.host_trace))
    steps_ms = sorted((s.t1 - s.t0) * 1e3 for s in rec.untraced_steps())
    if steps_ms:
        q = [steps_ms[int(f * (len(steps_ms) - 1))] for f in (0.1, 0.5, 0.9)]
        say(f"gbench: step ms p10 {q[0]:.2f} p50 {q[1]:.2f} p90 {q[2]:.2f}")
    if cuda:
        say(f"gbench: card after the window: {hoststate.card_state()}")
    engine = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = {}
    if check_output:
        checks = check.judge(rec, w, cfg, cell.name, seed, traffic["check_requests"],
                             limit_table, control)
        say(f"gbench: reference check took {time.perf_counter() - t0:.3f} s")
    result = {
        "correct": check_output and check.passed(checks),
        "attempted": len(sent),
        "failed": sum(1 for r in sent if not r.times),
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": cell.chips if cuda else 0, "memory_peak_bytes": peak,
                   "power_limit": card_line() if cuda else "none"},
    }
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
        say(f"gbench: trace: {summary.device_events} device operations in "
            f"{summary.window_s} s, busy {summary.busy_s} s")
    result["checks"] = {k: {"value": _num(v["value"]), "limit": v["limit"]}
                        for k, v in checks.items()}
    return result, run


def _num(v):
    return None if v is None or (isinstance(v, float) and math.isnan(v)) else v
