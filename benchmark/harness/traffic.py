"""The one traffic generator: every mix is a data file of parameters
(``benchmark/traffic/<name>.json``) that this module reads.

Keys of a traffic file:

- ``loop``: ``"closed"`` (``clients`` callers, each sending its next request
  when its last one finishes; the first wave is sent during set-up) or
  ``"open"`` (arrivals on a schedule, whether or not earlier requests have
  finished: ``rate`` requests a second, starting ``warm_seconds`` before the
  window opens). The gaps between arrivals are exponential (Poisson
  arrivals), or with ``burst_cv`` Gamma-distributed with that coefficient of
  variation at the same mean: above 1, arrivals come in bursts with quiet
  stretches between them.
- ``prompt``, ``output``, and for a closed loop ``first_wave_output``:
  length distributions, ``{"median", "sigma", "min", "max"}`` (lognormal,
  rounded and clipped) or ``{"uniform": [lo, hi]}``; ``max_total`` caps
  prompt + output by shortening the output.
- ``max_batch``, ``page_size``: the engine's rows and page size; the table of
  a row is the fewest pages that hold the longest request the mix can draw.
- ``length_seed``: every run draws the same sizes and arrival times, in the
  same order, from ``length_seed``; the run's seed draws the prompt tokens
  (and the weights), so runs on different seeds do the same work.
- ``check_requests``: finished requests compared with the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

POOL = 4096  # requests in the fixed list (far more than a window sends)


@dataclass
class Planned:
    index: int
    prompt_len: int
    max_new: int
    due: float = 0.0  # seconds after the schedule's origin (open loop)


def _lengths(dist: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    if "uniform" in dist:
        lo, hi = dist["uniform"]
        return rng.integers(lo, hi + 1, size=n)
    x = np.exp(rng.normal(np.log(dist["median"]), dist["sigma"], size=n))
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


def max_lengths(traffic: dict) -> int:
    """The longest prompt + output the mix can draw."""
    def top(d):
        return d["uniform"][1] if "uniform" in d else d["max"]
    outs = [top(traffic["output"])] + ([top(traffic["first_wave_output"])]
                                        if "first_wave_output" in traffic else [])
    total = top(traffic["prompt"]) + max(outs)
    cap = traffic.get("max_total")
    return total if cap is None else min(total, cap)


def pages_per_seq(traffic: dict) -> int:
    return -(-max_lengths(traffic) // traffic["page_size"])


class Plan:
    """The run's requests in the order they are sent: ``first_wave`` (closed
    loop) and ``stream``, with their sizes, due times (open loop) and prompt
    tokens (:meth:`prompt`)."""

    def __init__(self, traffic: dict, seed: int, vocab: int):
        self.traffic = traffic
        self.seed = int(seed) % (1 << 64)
        self.vocab = vocab
        base = np.random.default_rng(traffic["length_seed"])
        prompts = _lengths(traffic["prompt"], POOL, base)
        outs = _lengths(traffic["output"], POOL, base)
        cap = traffic.get("max_total")
        if cap is not None:
            outs = np.minimum(outs, cap - prompts)
        self.first_wave: List[Planned] = []
        if traffic["loop"] == "closed":
            n = traffic["clients"]
            fw_p = _lengths(traffic["prompt"], n, base)
            fw_o = _lengths(traffic["first_wave_output"], n, base)
            if cap is not None:
                fw_o = np.minimum(fw_o, cap - fw_p)
            self.first_wave = [Planned(POOL + j, int(fw_p[j]), int(fw_o[j])) for j in range(n)]
        due = np.zeros(POOL)
        if traffic["loop"] == "open":
            cv = traffic.get("burst_cv")
            if cv is None:
                gaps = base.exponential(1.0 / traffic["rate"], size=POOL)
            else:
                shape = 1.0 / cv ** 2
                gaps = base.gamma(shape, 1.0 / (traffic["rate"] * shape), size=POOL)
            due = np.cumsum(gaps) - gaps[0]
        self.stream = [Planned(i, int(prompts[i]), int(outs[i]), float(due[i]))
                       for i in range(POOL)]

    def prompt(self, p: Planned) -> np.ndarray:
        """The request's prompt tokens, uniform over the vocabulary, from the
        run's seed and the request's index alone."""
        return np.random.default_rng([self.seed, 1, p.index]).integers(
            0, self.vocab, size=p.prompt_len, dtype=np.int64)

    def distinct_pads(self) -> List[int]:
        """Every prompt length padded to whole pages that the plan holds."""
        ps = self.traffic["page_size"]
        reqs = self.first_wave + self.stream
        return sorted({-(-p.prompt_len // ps) * ps for p in reqs})
