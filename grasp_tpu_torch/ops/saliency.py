"""Saliency and rank-selection math (counterpart of grasp_tpu/ops/saliency.py).

Block influence scores rows by 1 - cos(in, out) directly, as the JAX package
does; the selection functions keep its tie order (lower index first).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


def _influence(x: torch.Tensor, y: torch.Tensor, angular: bool) -> torch.Tensor:
    """Row-wise influence of fp32 [..., N, D] pairs; NaN cosines count 0.5."""
    dot = torch.sum(x * y, dim=-1)
    norm = torch.linalg.vector_norm(x, dim=-1) * torch.linalg.vector_norm(y, dim=-1)
    sim = torch.nan_to_num(dot / norm, nan=0.5)
    if angular:
        return torch.arccos(torch.clamp(sim, -1.0, 1.0)) / math.pi
    return 1.0 - sim


def block_influence(input_hidden_state: torch.Tensor, output_hidden_state: torch.Tensor,
                    angular: bool = False) -> torch.Tensor:
    """Per-token block influence between two hidden states [..., D]: rows are
    flattened to (N, D); score_i = 1 - cos(in_i, out_i), or arccos(cos)/pi
    when angular. Returns [N] float32."""
    d = input_hidden_state.shape[-1]
    x = input_hidden_state.reshape(-1, d).float()
    y = output_hidden_state.reshape(-1, d).float()
    return _influence(x, y, angular)


def bi_from_hiddens(hiddens: Sequence[torch.Tensor], num_prune_layers: int = 1,
                    angular: bool = False) -> torch.Tensor:
    """Mean block influence of every layer from L+1 hidden states [B, S, D]:
    for i in [0, L+1-n), block_influence(h[i], h[i+n]) with n =
    num_prune_layers if angular else 1; angular keeps the last token only.
    Returns [L+1-n] float32; callers sum over batches."""
    n = num_prune_layers if angular else 1
    h = torch.stack(list(hiddens), dim=0)  # [L+1, B, S, D]
    if angular:
        h = h[:, :, -1:, :]
    d = h.shape[-1]
    x = h[:-n].reshape(h.shape[0] - n, -1, d).float()
    y = h[n:].reshape(h.shape[0] - n, -1, d).float()
    return _influence(x, y, angular).mean(dim=-1)


def choose_prune_layers(layer_importances, num_prune_layers: int, angular: bool = False) -> list:
    """Layers to compress from accumulated importances: angular picks the
    contiguous window starting at the argmin of the windowed scores, else
    the n individually lowest layers (stable order on ties)."""
    imp = np.asarray(layer_importances, dtype=np.float64)
    if angular:
        valid = imp[: len(imp) - num_prune_layers + 1] if num_prune_layers > 1 else imp
        start = int(np.argsort(valid, kind="stable")[0])
        return list(range(start, start + num_prune_layers))
    return np.argsort(imp, kind="stable")[:num_prune_layers].tolist()


def preserve_rank(in_features: int, out_features: int, compression_ratio: float) -> int:
    """Rank k keeping (1-ratio) of the dense parameter count:
    k = floor(in*out*(1-ratio) / (in+out))."""
    if compression_ratio is None:
        raise ValueError("Compression ratio should not be None")
    return int(in_features * out_features * (1 - compression_ratio) / (in_features + out_features))


def svd_saliency(grad: torch.Tensor, s: torch.Tensor, metric: str = "taylor") -> torch.Tensor:
    """Importance of each singular triplet: "gradient" -> |dL/dS|, "taylor"
    -> |S * dL/dS|."""
    if metric == "gradient":
        return torch.abs(grad)
    if metric == "taylor":
        return torch.abs(grad * s)
    raise ValueError(f"metric {metric!r} not supported (use 'gradient' or 'taylor')")


def select_topk(importance: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k most important singular values, in descending
    importance, the lower index first among equal values (``lax.top_k``'s
    order). ``torch.topk`` leaves the order of ties open, so this is a stable
    descending sort."""
    order = torch.sort(importance, dim=-1, descending=True, stable=True).indices
    return order[..., :k]


def adaptive_rank_selection(svd_importance, target_ratio: float) -> list:
    """Smallest descending-importance prefix whose mass reaches target_ratio
    (stable, lowest index first on ties); runs on the host in float64."""
    imp = np.asarray(svd_importance, dtype=np.float64)
    target = float(imp.sum()) * target_ratio
    order = np.argsort(-imp, kind="stable")
    csum = np.cumsum(imp[order])
    cutoff = int(np.searchsorted(csum, target, side="left")) + 1
    return order[:min(cutoff, len(imp))].tolist()
