"""Sampling filter (counterpart of grasp_tpu/eval/generate.py).

Only :func:`topk_topp_filter` is ported so far, for the serving sampler; the
batched generators come with the evaluation slice.
"""

from __future__ import annotations

from typing import Optional

import torch


def topk_topp_filter(scaled: torch.Tensor, ks: torch.Tensor, top_ps: torch.Tensor,
                     max_k: int, min_ps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched HF-semantics top-k / nucleus / min-p filter.

    scaled: [B, V] temperature-scaled logits. ks: [B] per-row k (0 = no
    top-k; at most max_k). top_ps: [B] nucleus threshold: keep the smallest
    prefix of the descending-prob distribution covering top_p, always at least
    one token. min_ps (optional, [B], 0 = off): drop tokens below min_p times
    the top probability. Filtered entries become the fp32 minimum."""
    neg = torch.finfo(torch.float32).min
    scaled = scaled.float()
    vals = torch.topk(scaled, max_k, dim=-1).values  # [B, max_k] descending
    kth = vals.gather(1, (ks[:, None].long() - 1).clamp(0, max_k - 1))
    filt = torch.where((ks[:, None] > 0) & (scaled < kth), neg, scaled)
    # nucleus: drop tokens whose preceding cumulative mass already covers top_p
    sorted_l, order = torch.sort(filt, dim=-1, descending=True, stable=True)
    probs = torch.softmax(sorted_l, dim=-1)
    drop_sorted = (torch.cumsum(probs, dim=-1) - probs) >= top_ps[:, None]
    drop = torch.empty_like(drop_sorted).scatter_(1, order, drop_sorted)
    out = torch.where(drop, neg, filt)
    if min_ps is not None:
        p = torch.softmax(out, dim=-1)
        low = p < min_ps[:, None] * p.max(dim=-1, keepdim=True).values
        keep_top = out >= out.max(dim=-1, keepdim=True).values
        out = torch.where(low & ~keep_top & (min_ps[:, None] > 0), neg, out)
    return out
