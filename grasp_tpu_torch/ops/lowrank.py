"""Projection apply functions (counterpart of grasp_tpu/ops/lowrank.py).

Kernels keep the JAX package's [in, out] layout, so ``y = x @ kernel``. Both
functions are plain matrix products, as they are plain XLA dots in JAX; the
fused low-rank Pallas kernel (grasp_tpu/ops/pallas_lowrank.py) is not ported
yet, and the full-SVD form comes with the compression engine.
"""

from __future__ import annotations

from typing import Optional

import torch


def dense_apply(x: torch.Tensor, kernel: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ kernel (+ bias); kernel is [in, out]."""
    y = torch.matmul(x, kernel)
    return y + bias if bias is not None else y


def lowrank_apply(x: torch.Tensor, in_kernel: torch.Tensor, out_kernel: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Compiled GRASP low-rank projection: y = (x @ in_kernel) @ out_kernel
    (+ bias); in_kernel [in, r], out_kernel [r, out] with sigma fused in."""
    y = torch.matmul(torch.matmul(x, in_kernel), out_kernel)
    return y + bias if bias is not None else y
