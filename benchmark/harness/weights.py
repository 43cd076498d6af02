"""The served model's weights, made on the device from the run's seed.

A configuration file holds the model's published ``config.json`` keys and a
``grasp`` group: the layers whose seven projections are GRASP low-rank pairs
and the compression ratio that sets each pair's rank (``rank`` below, the
port's ``preserve_rank``). Weights are random: a dense matrix and the first
factor of a pair are N(0, 0.02^2); the second factor is N(0, 1 / r), so that a
pair's output has a dense projection's scale; norms are ones. They are made in
bf16, the type they are served in, in a few large draws from one
``torch.Generator`` on the device, and both sides read the same tensors: the
program through :mod:`benchmark.harness.port`, the reference directly.

Names: ``embed`` [V, d], ``lm_head`` [d, V], ``norm`` [d]; for layer i
``i.in_norm``, ``i.post_norm`` [d], and per projection ``i.<p>`` [in, out]
or ``i.<p>.a`` [in, r] with ``i.<p>.b`` [r, out], p in q k v o gate up down.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

PROJS = ("q", "k", "v", "o", "gate", "up", "down")
_ALIGN = 64  # elements: every tensor starts on a 128-byte boundary
_DRAW = 1 << 30  # elements a draw


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]


def rank(in_f: int, out_f: int, ratio: float) -> int:
    """GRASP's rank for a projection: (1 - ratio) of the dense parameters."""
    return int(in_f * out_f * (1 - ratio) / (in_f + out_f))


def proj_shapes(cfg: dict) -> Dict[str, Tuple[int, int]]:
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    q = cfg["num_attention_heads"] * head_dim(cfg)
    kv = cfg["num_key_value_heads"] * head_dim(cfg)
    return {"q": (d, q), "k": (d, kv), "v": (d, kv), "o": (q, d),
            "gate": (d, f), "up": (d, f), "down": (f, d)}


def layout(cfg: dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, std) of every random tensor, in the order drawn."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    ratio = cfg.get("grasp", {}).get("compression_ratio")
    low = set(cfg.get("grasp", {}).get("layers_id", []))
    out = [("embed", (v, d), 0.02)]
    for i in range(cfg["num_hidden_layers"]):
        for p, (fi, fo) in proj_shapes(cfg).items():
            if i in low:
                r = rank(fi, fo, ratio)
                out += [(f"{i}.{p}.a", (fi, r), 0.02), (f"{i}.{p}.b", (r, fo), r ** -0.5)]
            else:
                out.append((f"{i}.{p}", (fi, fo), 0.02))
    out.append(("lm_head", (d, v), 0.02))
    return out


def make_weights(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Every weight of ``cfg`` from ``seed`` on ``device``: one flat buffer
    filled by a few normal draws, each tensor a view of it scaled to its std."""
    spec = layout(cfg)
    offsets, n = [], 0
    for _, shape, _ in spec:
        offsets.append(n)
        n += -(-math.prod(shape) // _ALIGN) * _ALIGN
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(n, dtype=dtype, device=device)
    for start in range(0, n, _DRAW):
        flat[start:start + _DRAW].normal_(generator=gen)
    w: Dict[str, torch.Tensor] = {}
    for (name, shape, std), off in zip(spec, offsets):
        t = flat[off:off + math.prod(shape)].view(shape)
        t.mul_(std)
        w[name] = t
    d = cfg["hidden_size"]
    ones = torch.ones((2 * cfg["num_hidden_layers"] + 1, d), dtype=dtype, device=device)
    w["norm"] = ones[-1]
    for i in range(cfg["num_hidden_layers"]):
        w[f"{i}.in_norm"], w[f"{i}.post_norm"] = ones[2 * i], ones[2 * i + 1]
    return w


def shapes_of(w: Dict[str, torch.Tensor], cfg: dict) -> List[Tuple[int, ...]]:
    """(in, out) or (in, r, out) of every projection, for the FLOP count."""
    out = []
    for i in range(cfg["num_hidden_layers"]):
        for p in PROJS:
            name = f"{i}.{p}"
            if name in w:
                out.append(tuple(w[name].shape))
            else:
                a, b = w[name + ".a"], w[name + ".b"]
                out.append((a.shape[0], a.shape[1], b.shape[1]))
    return out


def weight_bytes(w: Dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in w.values())
