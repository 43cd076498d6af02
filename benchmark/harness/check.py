"""Whether the timed path served the right tokens.

After the window has closed, the program's state freed: a sample of the
requests finished in the window, drawn from the run's seed with the longest
one in it and the others from as many of the engine's rows as it can, goes
through the plain fp32 reference (``benchmark/reference``), one request at
a time. Each served token's reference logit is compared with
the reference's best at its position; the widest gap over the sample is held
to the cell's limit (``benchmark/limits/<workload>.json``). Every request
sent in the window has to have answered, and every finished one with all the
tokens it asked for.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from benchmark.harness.drive import Record, ReqRec
from benchmark.harness.spec import BENCH_DIR
from benchmark.reference.model import plain_fp32, served_gaps


def limits(workload: str) -> dict:
    """The cell's limits (``benchmark/limits/<workload>.json``), or none."""
    path = os.path.join(BENCH_DIR, "limits", workload + ".json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def sample(rec: Record, seed: int, k: int, min_tokens: int = 0) -> List[ReqRec]:
    """The longest request finished in the window and k - 1 others drawn
    from the seed: rows first (each row of the engine once, rows other than
    the longest's first), then one of the row's requests; where fewer rows
    than k - 1 served, the rest drawn from what is left. Where the sample
    holds fewer than ``min_tokens`` served tokens, further requests drawn
    so join it until it does (or none is left)."""
    done = [r for r in rec.requests
            if r.req is not None and rec.t_start <= r.finished_at <= rec.t_end]
    if not done:
        return []
    done.sort(key=lambda r: r.req.rid)
    longest = max(done, key=lambda r: (len(r.req.prompt) + len(r.req.out), -r.req.rid))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([int(seed) % (1 << 64), 2])
    by_row: Dict[int, List[ReqRec]] = {}
    for r in rest:
        by_row.setdefault(r.req.row, []).append(r)
    rows = sorted(by_row, key=lambda row: (row == longest.req.row, row))
    order = rng.permutation(len(rows) - (longest.req.row in by_row))
    rows = [rows[i] for i in order] + rows[len(order):]
    pick = [by_row[row][int(rng.integers(len(by_row[row])))] for row in rows[:k - 1]]
    left = [r for r in rest if all(r is not p for p in pick)]
    left = [left[i] for i in rng.permutation(len(left))]
    tokens = sum(len(r.req.out) for r in pick) + len(longest.req.out)
    while left and (len(pick) < k - 1 or tokens < min_tokens):
        pick.append(left.pop(0))
        tokens += len(pick[-1].req.out)
    return [longest] + sorted(pick, key=lambda r: r.req.rid)


def gaps(w, cfg: dict, reqs: List[ReqRec], precision: str = "fp32") -> List[float]:
    plain_fp32()
    out: List[float] = []
    for r in reqs:
        out += served_gaps(w, cfg, r.req.prompt.tolist(), list(r.req.out), precision)
    return out


def judge(rec: Record, w, cfg: dict, workload: str, seed: int, k: int,
          limit_table: Optional[dict] = None, control: bool = False) -> Dict[str, dict]:
    """Each number compared with its limit: ``{"name": {"value", "limit"}}``.
    ``control``: also, on the same sample, the control's reading (the
    reference in fp8 in the program's place), held to the same limit
    (:func:`control_passed`), and a witness's, with no limit (the reference
    with bf16 products, the program's precision)."""
    table = limits(workload) if limit_table is None else limit_table
    sent = [r for r in rec.requests if r.in_window]
    unanswered = sum(1 for r in sent if not r.times)
    finished = [r for r in rec.requests if r.req is not None]
    short = sum(1 for r in finished
                if r.req.finish != "length" or len(r.req.out) != r.planned.max_new)
    reqs = sample(rec, seed, k, table.get("tokens_compared_min", 0))
    g = gaps(w, cfg, reqs)
    gap_limit = table.get("max_logit_gap", {}).get("limit")
    out = {
        "unanswered": {"value": unanswered, "limit": 0},
        "short_answers": {"value": short, "limit": 0},
        "tokens_compared_min": {"value": len(g), "limit": table.get("tokens_compared_min", 1)},
        "max_logit_gap": {"value": max(g) if g else None, "limit": gap_limit},
    }
    if control:
        for precision, limit in (("fp8", gap_limit), ("bf16", None)):
            c = gaps(w, cfg, reqs, precision)
            out[f"{precision}_max_logit_gap"] = {"value": max(c) if c else None, "limit": limit}
    return out


def control_passed(checks: Dict[str, dict]) -> bool:
    """Whether the control, its reading in the program's place, would pass
    (it has to fail)."""
    return passed({**checks, "max_logit_gap": checks["fp8_max_logit_gap"]})


def passed(checks: Dict[str, dict]) -> bool:
    c = checks
    return (c["unanswered"]["value"] <= 0 and c["short_answers"]["value"] <= 0
            and c["tokens_compared_min"]["value"] >= c["tokens_compared_min"]["limit"]
            and c["max_logit_gap"]["value"] is not None
            and c["max_logit_gap"]["limit"] is not None
            and c["max_logit_gap"]["value"] <= c["max_logit_gap"]["limit"])
