"""Rank arithmetic of GRASP (counterpart of grasp_tpu/ops/saliency.py).

Only :func:`preserve_rank` is ported so far; the saliency scoring and top-k
selection come with the compression engine.
"""

from __future__ import annotations


def preserve_rank(in_features: int, out_features: int, compression_ratio: float) -> int:
    """Rank k keeping (1-ratio) of the dense parameter count:
    k = floor(in*out*(1-ratio) / (in+out))."""
    if compression_ratio is None:
        raise ValueError("Compression ratio should not be None")
    return int(in_features * out_features * (1 - compression_ratio) / (in_features + out_features))
