"""The frozen arithmetic: FLOPs against the port's own count where the two
definitions meet, whole-window tails, every request in a percentile."""

import math

import numpy as np
import pytest

from benchmark.harness.cell import Run, model_counts
from benchmark.harness.drive import Record, ReqRec, StepRec
from benchmark.harness.traffic import Planned
from benchmark.harness.weights import make_weights, shapes_of
from benchmark.metrics import reader
from benchmark.metrics.yardstick import (kv_bytes, least_seconds, lowrank_cost,
                                         paged_decode_bytes, percentile, peaks)
from benchmark.tests import tiny


@pytest.mark.parametrize("s", [1, 37, 512])
def test_prefill_flops_agree_with_the_ports_count(s):
    from grasp_tpu_torch.perf import estimate_forward_flops
    from benchmark.harness import port

    cfg = dict(tiny.CONFIG, sliding_window=None)
    w = make_weights(cfg, 3, "cpu")
    params = port.params_of(w, cfg["num_hidden_layers"])
    ours = model_counts(cfg, w).prefill_flops(s, lm_positions=s)
    theirs = estimate_forward_flops(params, port.model_config(cfg), seq_len=s)["flops"]
    assert ours == pytest.approx(theirs, rel=1e-12)


def test_decode_flops_count_each_tokens_own_context():
    cfg = dict(tiny.CONFIG, sliding_window=None)
    m = model_counts(cfg, make_weights(cfg, 3, "cpu"))
    per_key = 2 * 2 * m.num_heads * m.head_dim * m.num_layers
    assert m.decode_flops(101) - m.decode_flops(100) == per_key
    windowed = model_counts(tiny.CONFIG, make_weights(tiny.CONFIG, 3, "cpu"))
    assert windowed.decode_flops(10_000) == windowed.decode_flops(tiny.CONFIG["sliding_window"])


def test_kernel_bytes_and_bound():
    assert kv_bytes(10, 8, 128) == 2 * 10 * 8 * 256
    assert kv_bytes(10, 8, 128, quantized=True) == 2 * 10 * 8 * 132
    m = model_counts(tiny.CONFIG, make_weights(tiny.CONFIG, 3, "cpu"))
    assert paged_decode_bytes(m, 50) == m.num_layers * (kv_bytes(50, 2, 64) + 4 * 4 * 64)
    pk = peaks("NVIDIA H100 80GB HBM3")
    nbytes, flops = lowrank_cost(2048, 2048, 150, 5632)
    assert least_seconds(nbytes, flops, pk) == max(nbytes / 3.35e12, flops / 989e12)
    assert peaks("a card the table does not hold") is None


def _record(gaps_s, ttfts_s):
    """A window of 10 s: one request per TTFT, due at t = 1 + i; one with
    tokens spaced by ``gaps_s``."""
    rec = Record(t_start=0.0, t_end=10.0)
    for i, t in enumerate(ttfts_s):
        due = 1.0 + i * 0.01
        rec.requests.append(ReqRec(Planned(i, 10, 2), i, due, due, True,
                                   [] if t is None else [due + t]))
    times = list(np.cumsum([0.5] + list(gaps_s)))
    rec.requests.append(ReqRec(Planned(99, 10, 2), 99, 0.1, 0.1, False, times))
    return rec


def _read(name, rec):
    run = Run(rec=rec, seconds=10.0, setup_s=1.0, model=None, lowrank=[],
              trace=None, peaks=None)
    return reader(name)(run)


def test_a_stall_moves_the_tails():
    steady = _record([0.05] * 100, [0.2] * 50)
    base_itl, base_ttft = _read("itl_p95_ms", steady), _read("ttft_p90_ms", steady)
    assert base_itl == pytest.approx(50.0) and base_ttft == pytest.approx(200.0)
    stalled = _record([0.05] * 90 + [0.8] * 10, [0.2] * 40 + [1.5] * 10)
    assert _read("itl_p95_ms", stalled) > 10 * base_itl
    assert _read("ttft_p90_ms", stalled) > 5 * base_ttft
    failed = _record([0.05] * 100, [0.2] * 45 + [None] * 5)
    assert _read("ttft_p90_ms", failed) == math.inf


def test_percentiles_take_every_request_not_chunk_medians():
    values = [1.0] * 80 + [100.0] * 20
    assert percentile(values, 90) == pytest.approx(100.0)
    chunks = [values[i:i + 10] for i in range(0, 100, 10)]
    assert np.median([percentile(c, 90) for c in chunks]) == pytest.approx(1.0)
    rng = np.random.default_rng(0)
    xs = list(rng.lognormal(size=501))
    assert percentile(xs, 95) == pytest.approx(float(np.percentile(xs, 95)))


def test_rates_cover_the_whole_window():
    rec = _record([0.05] * 100, [0.2] * 50)
    inside = sum(1 for r in rec.requests for t in r.times if 0.0 < t <= 10.0)
    assert _read("output_tok_s", rec) == pytest.approx(inside / 10.0)


class _Trace:
    window_s, busy_s = 10.0, 4.0

    def kernel_seconds(self, part):
        return 0.5


def test_the_trace_metrics_read_nothing_where_there_is_nothing():
    rec = _record([0.05] * 10, [0.2] * 5)
    rec.steps.append(StepRec(1.0, 1.1, [10], [11, 12], [11, 12]))
    for name in ("k3_roofline", "k2_roofline", "mfu", "idle_pct"):
        assert _read(name, rec) is None
    rec.t_trace = 0.5  # the trace holds the step
    cfg = tiny.CONFIG
    w = make_weights(cfg, 3, "cpu")
    run = Run(rec=rec, seconds=10.0, setup_s=1.0, model=model_counts(cfg, w),
              lowrank=[s for s in shapes_of(w, cfg) if len(s) == 3], trace=_Trace(),
              peaks=peaks("NVIDIA H100 80GB HBM3"))
    for name in ("k3_roofline", "k2_roofline", "mfu"):
        assert reader(name)(run) > 0
    rec.steps[:] = [StepRec(1.0, 1.1, [], [], [])]  # a window in which nothing ran
    for name in ("k3_roofline", "k2_roofline", "mfu"):
        assert reader(name)(run) is None
