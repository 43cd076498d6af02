"""The benchmark's own arithmetic: model FLOPs, kernel bytes and operations,
device peaks, whole-window rates and percentiles.

This is a frozen copy, so that a change to the program cannot move the
yardstick. The FLOP count follows ``grasp_tpu_torch.perf.estimate_forward_flops``
(a dense projection in * out MACs a token, a low-rank one r * (in + out), the
lm head d * V, attention's score and value products 2 * nh * hd MACs a token
per key), corrected for serving: a decode token attends over its own context,
a prefill counts its real prompt tokens over the causal half (S / 2 keys a
token, as that function counts them), and the lm head counts once per sampled
token. The bytes of the paged decode kernel and the bound follow
``chip_smoke.py``'s ``_kv_bytes`` and ``_bound``.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Iterable, List, Optional, Sequence

_PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def peaks(kind: str) -> Optional[Dict[str, float]]:
    """Published peaks of the device named ``kind`` (``torch.cuda.get_device_name``),
    or None for a device the table does not hold."""
    with open(_PEAKS) as f:
        table = json.load(f)
    return table.get(kind)


# -- model FLOPs ---------------------------------------------------------------

def projection_macs(shapes: Iterable[Sequence[int]]) -> int:
    """MACs a token of the projections given as (in, out) for a dense kernel or
    (in, rank, out) for a low-rank pair."""
    total = 0
    for s in shapes:
        if len(s) == 2:
            total += s[0] * s[1]
        else:
            total += s[1] * (s[0] + s[2])
    return total


class ModelCounts:
    """What the arithmetic needs of a model: its projections' MACs a token
    (all layers), heads, head size, layers, width, vocabulary and window."""

    def __init__(self, proj_macs: int, num_layers: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, hidden: int, vocab: int, window: Optional[int] = None,
                 quantized_kv: bool = False):
        self.proj_macs = proj_macs
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.hidden = hidden
        self.vocab = vocab
        self.window = window
        self.quantized_kv = quantized_kv

    def _keys(self, ctx: float) -> float:
        return ctx if self.window is None else min(ctx, self.window)

    def attention_macs(self, keys: float) -> float:
        """Score and value products of one query over ``keys`` keys, all layers."""
        return 2 * self.num_heads * self.head_dim * keys * self.num_layers

    def prefill_flops(self, s: int, lm_positions: int = 1) -> float:
        """A causal prefill of ``s`` real tokens, with the lm head at
        ``lm_positions`` of them (1 in serving: the sampled position)."""
        macs = (self.proj_macs + self.attention_macs(self._keys(s / 2))) * s
        macs += self.hidden * self.vocab * lm_positions
        return 2.0 * macs

    def decode_flops(self, ctx: int) -> float:
        """One decode token whose query attends over ``ctx`` keys (itself
        included), and its sampled lm head."""
        macs = self.proj_macs + self.attention_macs(self._keys(ctx)) + self.hidden * self.vocab
        return 2.0 * macs


# -- kernel bytes and operations -----------------------------------------------

def kv_bytes(rows: int, nkv: int, hd: int, quantized: bool = False) -> int:
    """Bytes of ``rows`` live K and V rows of every kv head: bf16, or int8
    with an fp32 scale a row (chip_smoke.py's ``_kv_bytes``)."""
    return 2 * rows * nkv * (hd + 4 if quantized else hd * 2)


def paged_decode_bytes(m: ModelCounts, ctx: int) -> int:
    """Bytes the paged decode kernel needs for one query row of every layer:
    the row's live K/V over its own context (bf16, or int8 pages with their
    scales), Q read and the output written once, bf16."""
    q_out = 2 * m.num_heads * m.head_dim * 2
    kv = kv_bytes(m._keys(ctx), m.num_kv_heads, m.head_dim, m.quantized_kv)
    return m.num_layers * (kv + q_out)


def lowrank_cost(rows: int, k: int, r: int, n: int, elem: int = 2):
    """(bytes, flops) of y = (x @ A) @ B over ``rows`` rows: x, A, B and y
    moved once, 2 rows r (k + n) operations."""
    nbytes = elem * (rows * k + k * r + r * n + rows * n)
    return nbytes, 2.0 * rows * r * (k + n)


def least_seconds(nbytes: float, flops: float, pk: Dict[str, float]) -> float:
    """The least time the device could take: the larger of bytes over the
    memory rate and operations over the bf16 rate (chip_smoke.py's ``_bound``)."""
    return max(nbytes / pk["hbm_bytes_per_s"], flops / pk["bf16_flops_per_s"])


# -- whole-window statistics ---------------------------------------------------

def percentile(values: List[float], p: float) -> float:
    """The ``p``-th percentile of every value, by linear interpolation between
    order statistics (numpy's default). An infinite value (a request that
    failed) sorts last and can be the answer."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * p / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    """A count over the whole window's seconds."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return count / seconds
