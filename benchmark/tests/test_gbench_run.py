"""A run's guards and its comparison: the whole-name check for JAX, no
result without a card, and at a size the CPU holds the rest of a run with
the timed path broken underneath (``correct`` comes out false) and with the
control in the program's place (its reading passes the limit)."""

import gc
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness import cell as cellmod
from benchmark.harness import check
from benchmark.harness.spec import ROOT
from benchmark.tests import tiny

# The tiny cell's limit, set as the cells' are (PERF.md): sound runs of the
# program read at most 0.0055 over seeds 1-3 and 2**31 + 5 (both loops), the
# control 0.041 to 0.136.
TINY = {"max_logit_gap": {"limit": 0.015}}
SEEDS = (1, 2, 3)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    base = set(cellmod.forbidden_modules())
    for name in ("grasp_tpu_torch", "grasp_tpu_torch.ops", "jax_like", "jaxfoo.bar"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert set(cellmod.forbidden_modules()) == base
    for name in ("grasp_tpu", "grasp_tpu.ops.x", "jax.numpy", "jaxlib", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert {"grasp_tpu", "grasp_tpu.ops.x", "jax.numpy", "jaxlib", "flax.linen"} <= \
        set(cellmod.forbidden_modules())


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: run.py would run")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                          "--workload", "mistral-7b-grasp.batch", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def _run(loop, seed, hook=None, control=False):
    return cellmod.run_cell(tiny.cell(loop), seed, 2.0, False, "cpu", time.perf_counter(),
                            limit_table=TINY, drive_hook=hook, control=control)


@pytest.mark.parametrize("loop", ["open", "closed"])
def test_a_sound_run_is_correct(loop):
    result, _ = _run(loop, SEEDS[0])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    json.dumps(result)


def _alter_tokens(engine):
    """A token altered where it is produced: the sampler's pick for row 0
    is moved to the next id every third call."""
    from grasp_tpu_torch.serving import paged

    orig, calls = paged.sample_tokens, [0]

    def altered(logits, reqs):
        toks = orig(logits, reqs)
        calls[0] += 1
        if calls[0] % 3 == 0:
            toks[0] = (toks[0] + 1) % logits.shape[-1]
        return toks

    paged.sample_tokens = altered
    return lambda: setattr(paged, "sample_tokens", orig)


def _state_unchanged(engine):
    """A step that returns its state unchanged: the decode writes its new
    K/V into copies of the pools, so the pools stay as they were."""
    orig = engine._decode

    def unchanged(params, toks, k_pages, v_pages, *rest):
        return orig(params, toks, k_pages.clone(), v_pages.clone(), *rest)

    engine._decode = unchanged
    return lambda: None


@pytest.mark.parametrize("fault", [_alter_tokens, _state_unchanged])
def test_a_broken_timed_path_is_not_correct(fault):
    undo = []
    try:
        result, _ = _run("open", SEEDS[0], hook=lambda e: undo.append(fault(e)))
    finally:
        for u in undo:
            u()
    assert not result["correct"], result["checks"]
    assert result["checks"]["max_logit_gap"]["value"] > TINY["max_logit_gap"]["limit"]


def test_the_control_in_the_programs_place_is_not_correct():
    for seed in SEEDS:
        result, run = _run("open", seed, control=True)
        assert result["correct"]
        control = result["checks"]["fp8_max_logit_gap"]
        assert control["limit"] == TINY["max_logit_gap"]["limit"]
        assert control["value"] > control["limit"], (seed, control)
        assert not check.control_passed(result["checks"]), (seed, control)


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                          "--workload", "mistral-7b-grasp.rag", "--seed", str(2**31 + 7),
                          "--seconds", "5", "--trace", "1"],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    checks = result["checks"]  # a 5-s window compares fewer tokens than a run's minimum
    assert checks["unanswered"]["value"] == 0 and checks["short_answers"]["value"] == 0
    assert 0 < checks["tokens_compared_min"]["value"]
    assert checks["max_logit_gap"]["value"] <= checks["max_logit_gap"]["limit"]
    assert result["device"]["busy_s"] > 0 and result["metrics"]
    assert list(result)[-1] == "checks"


class _StubTracer:
    """Records when the trace would start and stop (host clock)."""

    def __init__(self):
        self.started = self.stopped = None

    def start(self):
        self.started = time.perf_counter()

    def stop(self):
        self.stopped = time.perf_counter()

    def span(self, name):
        import contextlib

        return contextlib.nullcontext()


@pytest.mark.parametrize("loop", ["open", "closed"])
def test_a_traced_run_traces_only_the_windows_last_seconds(loop):
    from benchmark.harness import hoststate, port
    from benchmark.harness.drive import Driver
    from benchmark.harness.traffic import Plan, pages_per_seq
    from benchmark.harness.weights import make_weights

    c = tiny.cell(loop)
    t = c.traffic
    engine = port.make_engine(c.config, make_weights(c.config, 4, "cpu"), device="cpu",
                              max_batch=t["max_batch"], pages_per_seq=pages_per_seq(t),
                              page_size=t["page_size"])
    tracer, probe = _StubTracer(), hoststate.HostProbe()
    probe.start()
    try:
        rec = Driver(engine, Plan(t, 4, c.config["vocab_size"]), tracer, trace_seconds=1.0,
                     probe=probe).run(3.0)
    finally:
        probe.stop()
    assert gc.callbacks.count(probe._on_gc) == 0
    assert rec.t_start + 2.0 <= tracer.started <= rec.t_trace < rec.t_end <= tracer.stopped
    before, inside = rec.untraced_steps(), rec.traced_steps()
    assert before and inside and len(before) + len(inside) == len(rec.window_steps())
    assert all(s.t0 < rec.t_trace for s in before) and all(s.t0 >= rec.t_trace for s in inside)
    assert rec.counters_start["decode_steps"] <= rec.counters_trace["decode_steps"] \
        <= rec.counters_end["decode_steps"]
    assert "wall" in rec.host_start and "wall" in rec.host_trace
    assert hoststate.describe(rec.host_start, rec.host_trace) != "not read"


def test_the_page_dtype_is_read_and_what_the_engine_lacks_refused():
    from benchmark.harness import port

    assert not port.quantized_kv({"port": {"dtype": "bfloat16", "kv_pages": "bfloat16"}})
    assert not port.quantized_kv({"port": {"dtype": "bfloat16"}})
    assert port.quantized_kv({"port": {"dtype": "bfloat16", "kv_pages": "int8"}})
    for pages in ("float8_e4m3fn", "float32", "int4"):
        with pytest.raises(ValueError, match="kv_pages"):
            port.quantized_kv({"port": {"dtype": "bfloat16", "kv_pages": pages}})
    for name in ("mistral-7b-grasp", "phi-3-mini-grasp"):
        with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
            assert not port.quantized_kv(json.load(f))
