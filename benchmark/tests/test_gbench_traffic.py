"""The traffic generator: the same seed gives the same requests, every seed
the same sizes, all within the mix's stated ranges; the served models' mixes
stay inside the tables and windows that keep decode on the paged kernel."""

import json
import os
import re

import numpy as np
import pytest

from benchmark.harness.spec import ROOT, load_cell, reports
from benchmark.harness.traffic import POOL, Plan, max_lengths, pages_per_seq

CELLS = ("mistral-7b-grasp.batch", "phi-3-mini-grasp.chat", "mistral-7b-grasp.rag")
BIG_SEED = 2**31 + 12345


def _sizes(plan, n):
    return [(p.prompt_len, p.max_new) for p in plan.first_wave + plan.stream[:n]]


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_requests(name):
    cell = load_cell(name)
    a = Plan(cell.traffic, BIG_SEED, cell.config["vocab_size"])
    b = Plan(cell.traffic, BIG_SEED, cell.config["vocab_size"])
    assert _sizes(a, POOL) == _sizes(b, POOL)
    assert [p.due for p in a.stream] == [p.due for p in b.stream]
    for p, q in zip(a.stream[:5], b.stream[:5]):
        np.testing.assert_array_equal(a.prompt(p), b.prompt(q))
    c = Plan(cell.traffic, BIG_SEED + 1, cell.config["vocab_size"])
    assert not np.array_equal(a.prompt(a.stream[0]), c.prompt(c.stream[0]))


@pytest.mark.parametrize("name", CELLS)
def test_every_seed_does_the_same_work(name):
    cell = load_cell(name)
    plans = [Plan(cell.traffic, s, cell.config["vocab_size"]) for s in (1, 99, BIG_SEED)]
    for p in plans[1:]:
        assert _sizes(p, POOL) == _sizes(plans[0], POOL)
        assert [q.due for q in p.stream] == [q.due for q in plans[0].stream]


@pytest.mark.parametrize("name", CELLS)
def test_sizes_within_stated_ranges(name):
    cell = load_cell(name)
    t = cell.traffic
    plan = Plan(t, 7, cell.config["vocab_size"])
    for p in plan.stream:
        assert t["prompt"]["min"] <= p.prompt_len <= t["prompt"]["max"]
        assert t["output"]["min"] <= p.max_new <= t["output"]["max"]
        assert p.prompt_len + p.max_new <= max_lengths(t)
        ids = plan.prompt(p) if p.index < 3 else None
        if ids is not None:
            assert ids.min() >= 0 and ids.max() < cell.config["vocab_size"]
    if t["loop"] == "open":
        gaps = np.diff([p.due for p in plan.stream])
        assert abs(1.0 / gaps.mean() - t["rate"]) < 0.1 * t["rate"]
    else:
        lo, hi = t["first_wave_output"]["uniform"]
        assert all(lo <= p.max_new <= hi for p in plan.first_wave)
        assert len(plan.first_wave) == t["clients"] == t["max_batch"]


def test_phi3_within_its_window_and_mistral_tables_within_32_pages():
    chat = load_cell("phi-3-mini-grasp.chat")
    assert max_lengths(chat.traffic) <= 2047
    assert max_lengths(chat.traffic) <= chat.config["sliding_window"]
    assert pages_per_seq(chat.traffic) * chat.traffic["page_size"] <= 2047
    plan = Plan(chat.traffic, 3, chat.config["vocab_size"])
    assert max(p.prompt_len + p.max_new for p in plan.stream) <= 2047
    for name in ("mistral-7b-grasp.batch", "mistral-7b-grasp.rag"):
        cell = load_cell(name)
        assert pages_per_seq(cell.traffic) <= 32
        assert pages_per_seq(cell.traffic) * cell.traffic["page_size"] <= \
            cell.config["sliding_window"]


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_its_shape_and_names_what_the_harness_finds():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    from benchmark.metrics import reader

    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    cells = {w["name"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert os.path.exists(os.path.join(ROOT, c["file"])) and len(c["why"]) <= 200
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        for w in m["workloads"]:
            assert w in cells and reports(e2e[m["moves"]], w), (m["name"], w)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert callable(reader(m["name"]))
    for name in cells:
        cell = load_cell(name)
        assert cell.per_layer and len(cell.end_to_end) >= 2
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("name", [c for c in CELLS if "burst_cv" in load_cell(c).traffic])
def test_bursty_arrivals_keep_their_rate_and_spread(name):
    t = load_cell(name).traffic
    gaps = np.diff([p.due for p in Plan(t, 5, 1000).stream])
    assert abs(1.0 / gaps.mean() - t["rate"]) < 0.1 * t["rate"]
    assert abs(gaps.std() / gaps.mean() - t["burst_cv"]) < 0.15 * t["burst_cv"]
    steady = dict(t)
    del steady["burst_cv"]
    poisson = np.diff([p.due for p in Plan(steady, 5, 1000).stream])
    assert abs(poisson.std() / poisson.mean() - 1.0) < 0.1
