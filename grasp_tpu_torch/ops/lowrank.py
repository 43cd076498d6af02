"""Projection apply functions (counterpart of grasp_tpu/ops/lowrank.py and
grasp_tpu/ops/pallas_lowrank.py).

Kernels keep the JAX package's [in, out] layout, so ``y = x @ kernel``. The
dense, full-SVD and two-product low-rank functions are plain matrix products,
as they are plain XLA dots in JAX. :func:`fused_lowrank` is the fused low-rank
kernel (csrc/lowrank_fused.cu): ``y = (x @ A) @ B`` with ``h = x @ A`` kept in
shared memory instead of written to device memory and read back. Its backward
is plain matrix products, as in the JAX package: the fusion is for inference
and for the forward of calibration sweeps, while the factors still get correct
gradients.
"""

from __future__ import annotations

from typing import Optional

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_FUSED_RANK = 256  # accumulator columns of csrc/lowrank_fused.cu
FUSED_MIN_ROWS = 256  # below this the two plain products stay (decode-sized calls)


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


def fused_lowrank_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_lowrank` with the kernel's
    casts: h = x @ a accumulated in fp32 and rounded to x's dtype, y = h @ b
    accumulated in fp32 and rounded to x's dtype. x [..., k]."""
    x2d = x.reshape(-1, x.shape[-1])
    h = torch.matmul(x2d.float(), a.float()).to(x.dtype)
    y = torch.matmul(h.float(), b.float()).to(x.dtype)
    return y.reshape(*x.shape[:-1], b.shape[1])


def _check_cuda_args(x, a, b) -> None:
    for name, t in (("a", a), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"x, a and b must share one dtype (x {x.dtype}, {name} {t.dtype})")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the fused low-rank kernel takes float32 or bfloat16, got {x.dtype}")
    for name, t in (("x", x), ("a", a), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() < 1 or a.dim() != 2 or b.dim() != 2 or x.shape[-1] != a.shape[0] \
            or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, a {tuple(a.shape)}, b {tuple(b.shape)}")
    if a.shape[1] > MAX_FUSED_RANK:
        raise NotImplementedError(
            f"the fused low-rank kernel takes ranks up to {MAX_FUSED_RANK}, got {a.shape[1]}")
    if min(x.numel(), a.numel(), b.numel()) == 0:
        raise ValueError("the fused low-rank kernel needs non-empty x, a and b")


def _forward_cuda(x2d: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    from grasp_tpu_torch.ops._build import load_library

    lib = load_library()
    m, k = x2d.shape
    r, n = b.shape
    y = torch.empty((m, n), dtype=x2d.dtype, device=x2d.device)
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        rc = lib.grasp_lowrank_fused(x2d.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(),
                                     m, k, r, n, _DTYPE_CODES[x2d.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"fused low-rank kernel launch failed: cudaError {rc}")
    fused_lowrank.launches += 1
    return y


class _FusedLowrank(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b):
        ctx.save_for_backward(x, a, b)
        y = _forward_cuda(x.reshape(-1, x.shape[-1]), a, b)
        return y.reshape(*x.shape[:-1], b.shape[1])

    @staticmethod
    def backward(ctx, g):
        # plain products with the JAX backward's casts: each accumulates in
        # fp32 and rounds once to the working dtype, h and gh included
        x, a, b = ctx.saved_tensors
        x2d = x.reshape(-1, x.shape[-1])
        g2d = g.reshape(-1, g.shape[-1]).to(x.dtype)
        need_x, need_a, need_b = ctx.needs_input_grad
        dx = da = db = None
        if need_x or need_a:
            gh = torch.matmul(g2d, b.T)
            if need_x:
                dx = torch.matmul(gh, a.T).reshape(x.shape)
            if need_a:
                da = torch.matmul(x2d.T, gh).to(a.dtype)
        if need_b:
            h = torch.matmul(x2d, a)
            db = torch.matmul(h.T, g2d).to(b.dtype)
        return dx, da, db


def fused_lowrank(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y = (x @ a) @ b with the intermediate kept on the chip. x [..., k],
    a [k, r], b [r, n], one dtype (fp32 or bf16), contiguous, r <= 256.

    CPU tensors take :func:`fused_lowrank_plain` (differentiated by
    autograd). CUDA tensors launch the kernel on the current stream, or
    raise; there is no fallback. The backward is plain matrix products.
    ``fused_lowrank.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return fused_lowrank_plain(x, a, b)
    if x.device.type != "cuda":
        raise ValueError(f"the fused low-rank kernel runs on cpu or cuda, not {x.device}")
    _check_cuda_args(x, a, b)
    return _FusedLowrank.apply(x, a, b)


fused_lowrank.launches = 0


def lowrank_apply(x: torch.Tensor, in_kernel: torch.Tensor, out_kernel: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, use_fused: bool = False) -> torch.Tensor:
    """Compiled GRASP low-rank projection: y = (x @ in_kernel) @ out_kernel
    (+ bias); in_kernel [in, r], out_kernel [r, out] with sigma fused in.

    use_fused=True sends calls of 256 rows or more on CUDA tensors through
    :func:`fused_lowrank` (a rank above its bound raises); decode-sized calls
    and CPU tensors keep the two plain products, where the flag is inert."""
    rows = x.numel() // max(x.shape[-1], 1)
    if use_fused and rows >= FUSED_MIN_ROWS and x.device.type == "cuda":
        # autograd and the model's views hand over strided tensors
        y = fused_lowrank(x.contiguous(), in_kernel.contiguous(), out_kernel.contiguous())
    else:
        y = torch.matmul(torch.matmul(x, in_kernel), out_kernel)
    return y + bias if bias is not None else y
