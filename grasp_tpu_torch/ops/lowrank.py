"""Projection apply functions (counterpart of grasp_tpu/ops/lowrank.py).

Kernels keep the JAX package's [in, out] layout, so ``y = x @ kernel``. All
three functions are plain matrix products, as they are plain XLA dots in JAX;
the fused low-rank Pallas kernel (grasp_tpu/ops/pallas_lowrank.py) is not
ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch


def dense_apply(x: torch.Tensor, kernel: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ kernel (+ bias); kernel is [in, out]."""
    y = torch.matmul(x, kernel)
    return y + bias if bias is not None else y


def svd_apply(x: torch.Tensor, u: torch.Tensor, s: torch.Tensor, vh: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-SVD projection with trainable S: y = ((x @ Vh^T) * S) @ U^T
    (+ bias); U [out, r], S [r], Vh [r, in]. The factors are cast to x's
    dtype, as the JAX dots cast theirs."""
    h = torch.matmul(x, vh.to(x.dtype).T)
    h = h * s.to(h.dtype)
    y = torch.matmul(h, u.to(x.dtype).T)
    return y + bias if bias is not None else y


def lowrank_apply(x: torch.Tensor, in_kernel: torch.Tensor, out_kernel: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Compiled GRASP low-rank projection: y = (x @ in_kernel) @ out_kernel
    (+ bias); in_kernel [in, r], out_kernel [r, out] with sigma fused in."""
    y = torch.matmul(torch.matmul(x, in_kernel), out_kernel)
    return y + bias if bias is not None else y
