"""SVD factorisation, truncation and low-rank compilation (counterpart of
grasp_tpu/ops/svd.py).

Weights are factored in the row-major layout ``W: [out, in]`` (forward
``y = x @ W.T``), so U [out, r], S [r], Vh [r, in] have the JAX package's
shapes. The SVD, the Gram-matrix products and the sigma-gradient einsum are
library calls here as they are in JAX (no Pallas kernel computes them).

The gram methods factor through the Gram matrix of the smaller side: its
eigendecomposition gives S and one singular basis, and the other factor is
recovered by one product. The U-free functions (:func:`gram_basis`,
:func:`ufree_sigma_saliency`, :func:`ufree_truncate`) select from that basis
without forming the larger factor, through u_i = W v_i / sigma_i:

    dL/dsigma_i = u_i^T G v_i = v_i^T (W^T G) v_i / sigma_i

(and the mirror identity on the output side), so the Taylor importance
|sigma_i dL/dsigma_i| is |diag(V^T (W^T G) V)|. Every product of these paths
runs in true fp32 (:func:`_fp32_products`), as JAX's ``Precision.HIGHEST``.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch


def _host_svd(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """LAPACK SVD on the host, matrix by matrix over any leading axes."""
    if w.ndim == 2:
        u, s, vh = np.linalg.svd(w, full_matrices=False)
        return u.astype(w.dtype), s.astype(w.dtype), vh.astype(w.dtype)
    parts = [_host_svd(m) for m in w]
    return tuple(np.stack([p[i] for p in parts]) for i in range(3))


@contextlib.contextmanager
def _fp32_products():
    """fp32 matmuls in true fp32 (no TF32 on the card) for the duration, the
    caller's setting restored after: the gram paths square the spectrum, and
    TF32's 10-bit mantissa would cost the small singular values their digits."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def _descending_sqrt(lam, vecs):
    """Eigenpairs in ascending order -> (singular values, basis) descending."""
    return lam.flip(-1).clamp(min=0.0).sqrt(), vecs.flip(-1)


def _s_floor(s: torch.Tensor) -> torch.Tensor:
    """The smallest divisor a singular value may be: 1e-7 of the largest."""
    return (s.max(dim=-1, keepdim=True).values + 1e-30) * 1e-7


def _gram(wf: torch.Tensor) -> torch.Tensor:
    """The fp32 Gram matrix of the smaller side of ``wf`` ([..., out, in])."""
    if wf.shape[-2] <= wf.shape[-1]:
        return torch.matmul(wf, wf.transpose(-1, -2))  # [.., out, out]: basis of U
    return torch.matmul(wf.transpose(-1, -2), wf)  # [.., in, in]: basis of V


def _gram_svd(wf: torch.Tensor, on_device: bool) -> Tuple[torch.Tensor, torch.Tensor,
                                                           torch.Tensor]:
    """Thin SVD through the Gram matrix of the smaller side. ``on_device``:
    ``torch.linalg.eigh`` in fp32 where ``wf`` lives ("gram_device"); else the
    eigendecomposition runs in fp64 numpy on the host ("gram"). Singular
    values have a relative error of about eps * (s_max / s_i)^2: the large
    ones GRASP keeps are exact to fp32, the smallest are not."""
    with _fp32_products():
        g = _gram(wf)
        if on_device:
            s, basis = _descending_sqrt(*torch.linalg.eigh(g))
        else:
            lam, vecs = np.linalg.eigh(g.detach().cpu().numpy().astype(np.float64))
            s64, b64 = _descending_sqrt(torch.from_numpy(lam), torch.from_numpy(vecs))
            s, basis = s64.float().to(wf.device), b64.float().to(wf.device)
        s_safe = torch.maximum(s, _s_floor(s))
        if wf.shape[-2] <= wf.shape[-1]:  # basis = U
            vh = torch.matmul(basis.transpose(-1, -2), wf) / s_safe[..., :, None]
            return basis, s, vh
        u = torch.matmul(wf, basis) / s_safe[..., None, :]  # basis = V
        return u, s, basis.transpose(-1, -2)


def svd(w: torch.Tensor, method: str = "auto",
        mesh=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Thin SVD of ``w`` ([..., out, in]) in float32, on ``w``'s device.

    method: "device" — ``torch.linalg.svd`` where the tensor lives (batched
    over leading axes; in float64 on a CUDA device); "host" — numpy LAPACK,
    results moved back; "gram" — the Gram matrix on the device, its
    eigendecomposition in fp64 on the host; "gram_device" — the same with the
    eigendecomposition in fp32 on the device; "auto" — "device".

    On CUDA the fp32 SVD that cuSOLVER runs by default left factors orthogonal
    to only about 1e-3 at the TinyLlama-1.1B projection shapes, and up to 6%
    of a projection's selected indices unlike an fp64 SVD's; the float64 SVD
    selects as fp64 does and took less time than fp32 ``gesvd``
    (scripts/svd_agreement_torch.py, NVIDIA H100 80GB HBM3 at 700 W). The JAX
    package likewise never auto-chooses its imprecise on-device SVD.

    ``mesh`` (parallel.mesh.Mesh): a stack of matrices is spread over every
    rank (:func:`_svd_sharded`), each factored by the same method."""
    if mesh is not None and mesh.size > 1 and w.dim() > 2:
        return _svd_sharded(w, method, mesh)
    w = w.float()
    if method == "auto":
        method = "device"
    if method == "device":
        if w.device.type == "cuda":
            u, s, vh = torch.linalg.svd(w.double(), full_matrices=False)
            return u.float(), s.float(), vh.float()
        u, s, vh = torch.linalg.svd(w, full_matrices=False)
        return u, s, vh
    if method == "host":
        u, s, vh = _host_svd(w.detach().cpu().numpy())
        return tuple(torch.from_numpy(x).to(w.device) for x in (u, s, vh))
    if method in ("gram", "gram_device"):
        return _gram_svd(w, on_device=method == "gram_device")
    raise ValueError(f"unknown svd method {method!r}")


def _svd_sharded(w: torch.Tensor, method: str,
                 mesh) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`svd` of a stack [..., out, in] with its matrices spread over
    every rank of ``mesh``: the stack (every rank holds all of it) is padded
    to a multiple of the ranks, rank r factors its contiguous share by the
    single-device method, and every rank gathers every share. Each matrix's
    factors are those :func:`svd` gives it in the unsharded call wherever a
    batched call factors its matrices one by one (LAPACK on the CPU)."""
    lead = w.shape[:-2]
    flat = w.reshape(-1, *w.shape[-2:])
    n, size = flat.shape[0], mesh.size
    per = -(-n // size)
    start = min(mesh.rank * per, n)
    mine = flat[start:min(start + per, n)]
    m, k = flat.shape[-2], flat.shape[-1]
    r = min(m, k)
    dev = w.device
    u = torch.zeros(per, m, r, dtype=torch.float32, device=dev)
    s = torch.zeros(per, r, dtype=torch.float32, device=dev)
    vh = torch.zeros(per, r, k, dtype=torch.float32, device=dev)
    if mine.shape[0]:
        u[:mine.shape[0]], s[:mine.shape[0]], vh[:mine.shape[0]] = svd(mine, method)
    parts = [torch.cat(mesh.all_gather(x, None), dim=0)[:n] for x in (u, s, vh)]
    return tuple(x.reshape(*lead, *x.shape[1:]) for x in parts)


def gram_basis(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, str]:
    """Singular values and the small-side singular basis of ``w`` ([out,
    in]), fp32 Gram and eigendecomposition on ``w``'s device: (s, basis,
    side), side "u" when the basis columns are left singular vectors
    (out <= in), "v" when they are right singular vectors."""
    wf = w.float()
    with _fp32_products():
        s, basis = _descending_sqrt(*torch.linalg.eigh(_gram(wf)))
    return s, basis, "u" if wf.shape[-2] <= wf.shape[-1] else "v"


def ufree_sigma_saliency(w: torch.Tensor, grad_w: torch.Tensor, s: torch.Tensor,
                         basis: torch.Tensor, side: str, metric: str = "taylor") -> torch.Tensor:
    """Importance of each singular direction from the gram basis, without the
    larger factor: "taylor" |sigma dL/dsigma|, "gradient" |dL/dsigma|. w and
    grad_w in the [out, in] layout; (s, basis, side) from :func:`gram_basis`."""
    if metric not in ("taylor", "gradient"):
        raise ValueError(f"unknown metric {metric!r}")
    wf, gf = w.float(), grad_w.float()
    with _fp32_products():
        if side == "v":  # q_i = v_i^T (W^T G) v_i
            m = torch.matmul(wf.transpose(-1, -2), gf)
        else:  # q_i = u_i^T (G W^T) u_i
            m = torch.matmul(gf, wf.transpose(-1, -2))
        q = torch.sum(basis * torch.matmul(m, basis), dim=-2)
    if metric == "taylor":
        return q.abs()
    return q.abs() / torch.maximum(s, _s_floor(s))


def _take(x: torch.Tensor, indices: torch.Tensor, dim: int) -> torch.Tensor:
    """x's entries along ``dim`` (-1 or -2) at ``indices``: one index list
    for every matrix ([k]), or one for each ([..., k], ``take_along_axis``)."""
    if indices.dim() == 1:
        return x[..., indices] if dim == -1 else x[..., indices, :]
    if x.dim() == indices.dim():  # the singular values [..., r]
        return torch.gather(x, -1, indices)
    if dim == -1:
        idx = indices[..., None, :].expand(*x.shape[:-1], indices.shape[-1])
    else:
        idx = indices[..., :, None].expand(*x.shape[:-2], indices.shape[-1], x.shape[-1])
    return torch.gather(x, dim, idx)


def ufree_truncate(w: torch.Tensor, s: torch.Tensor, basis: torch.Tensor, side: str,
                   indices) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kept triplets (u, s, vh), in the order of ``indices``, recovering
    only the kept columns of the larger factor. Batched (stacked experts):
    indices [..., k] pick each matrix's own columns."""
    indices = torch.as_tensor(indices, dtype=torch.long, device=s.device)
    sk = _take(s, indices, -1)
    s_safe = torch.maximum(sk, _s_floor(s))
    bk = _take(basis, indices, -1)
    wf = w.float()
    with _fp32_products():
        if side == "v":
            return torch.matmul(wf, bk) / s_safe[..., None, :], sk, bk.transpose(-1, -2)
        return bk, sk, torch.matmul(bk.transpose(-1, -2), wf) / s_safe[..., :, None]


def truncate_svd(u: torch.Tensor, s: torch.Tensor, vh: torch.Tensor,
                 indices: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slice the kept singular triplets, preserving index order
    (S[idx], U[:, idx], Vh[idx, :]). Batched (stacked experts): indices
    [..., k] pick each matrix's own triplets."""
    indices = torch.as_tensor(indices, dtype=torch.long, device=s.device)
    return _take(u, indices, -1), _take(s, indices, -1), _take(vh, indices, -2)


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
