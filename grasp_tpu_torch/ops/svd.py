"""SVD factorisation, truncation and low-rank compilation (counterpart of
grasp_tpu/ops/svd.py).

Weights are factored in the row-major layout ``W: [out, in]`` (forward
``y = x @ W.T``), so U [out, r], S [r], Vh [r, in] have the JAX package's
shapes. The SVD and the sigma-gradient einsum are library calls here as they
are in JAX (no Pallas kernel computes them). The gram / U-free methods of the
JAX package are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_UNPORTED_METHODS = ("gram", "gram_device")


def _host_svd(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """LAPACK SVD on the host, matrix by matrix over any leading axes."""
    if w.ndim == 2:
        u, s, vh = np.linalg.svd(w, full_matrices=False)
        return u.astype(w.dtype), s.astype(w.dtype), vh.astype(w.dtype)
    parts = [_host_svd(m) for m in w]
    return tuple(np.stack([p[i] for p in parts]) for i in range(3))


def svd(w: torch.Tensor, method: str = "auto") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Thin SVD of ``w`` ([..., out, in]) in float32, on ``w``'s device.

    method: "device" — ``torch.linalg.svd`` where the tensor lives (batched
    over leading axes); "host" — numpy LAPACK, results moved back; "auto" —
    "device". The gram methods raise NotImplementedError."""
    w = w.float()
    if method == "auto":
        method = "device"
    if method == "device":
        u, s, vh = torch.linalg.svd(w, full_matrices=False)
        return u, s, vh
    if method == "host":
        u, s, vh = _host_svd(w.detach().cpu().numpy())
        return tuple(torch.from_numpy(x).to(w.device) for x in (u, s, vh))
    if method in _UNPORTED_METHODS:
        raise NotImplementedError(f"grasp_tpu_torch does not support svd method {method!r} yet")
    raise ValueError(f"unknown svd method {method!r}")


def truncate_svd(u: torch.Tensor, s: torch.Tensor, vh: torch.Tensor,
                 indices: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slice the kept singular triplets, preserving index order
    (S[idx], U[:, idx], Vh[idx, :])."""
    indices = torch.as_tensor(indices, dtype=torch.long, device=s.device)
    return u[..., :, indices], s[..., indices], vh[..., indices, :]


def lowrank_factors(u: torch.Tensor, s: torch.Tensor, vh: torch.Tensor,
                    sigma_fuse: str = "UV") -> Tuple[torch.Tensor, torch.Tensor]:
    """(in_kernel [in, r], out_kernel [r, out]) with the singular values fused
    in: "UV" puts sqrt(S) into both factors, "U" puts S into the out factor."""
    if sigma_fuse == "UV":
        sq = torch.sqrt(s)
        in_kernel = (vh * sq[..., :, None]).transpose(-1, -2)
        out_kernel = (u * sq[..., None, :]).transpose(-1, -2)
    elif sigma_fuse == "U":
        in_kernel = vh.transpose(-1, -2)
        out_kernel = (u * s[..., None, :]).transpose(-1, -2)
    else:
        raise ValueError(f"sigma_fuse {sigma_fuse!r} not supported (use 'UV' or 'U')")
    return in_kernel, out_kernel


def sigma_gradients(u: torch.Tensor, vh: torch.Tensor, grad_w: torch.Tensor) -> torch.Tensor:
    """Project a dense weight gradient onto the singular directions:
    dL/dsigma_i = u_i^T (dL/dW) vh_i, in float32. u [out, r], vh [r, in],
    grad_w [out, in]. Computed as sum_o u * (grad_w @ vh^T), which never
    forms an [out, in, r] intermediate."""
    u, vh, grad_w = u.float(), vh.float(), grad_w.float()
    return torch.sum(u * torch.matmul(grad_w, vh.transpose(-1, -2)), dim=-2)


def merge_svd(u: torch.Tensor, s: torch.Tensor, vh: torch.Tensor) -> torch.Tensor:
    """Re-materialise the dense product W = U diag(S) Vh ([out, in])."""
    return torch.matmul(u * s[..., None, :], vh)
