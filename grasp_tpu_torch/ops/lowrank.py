"""Projection apply functions (counterpart of grasp_tpu/ops/lowrank.py and
grasp_tpu/ops/pallas_lowrank.py).

Kernels keep the JAX package's [in, out] layout, so ``y = x @ kernel``. The
dense, full-SVD and two-product low-rank functions are plain matrix products,
as they are plain XLA dots in JAX. :func:`fused_lowrank` is the fused low-rank
kernel (csrc/lowrank_fused.cu): ``y = (x @ A) @ B`` with ``h = x @ A`` kept in
shared memory instead of written to device memory and read back; bf16 runs on
the tensor cores, fp32 on CUDA cores. A rank above 256 runs as chunks of at
most 256 ranks, one launch each, chained through an fp32 sum of y that is
rounded once. Its backward
is plain matrix products, as in the JAX package: the fusion is for inference
and for the forward of calibration sweeps, while the factors still get correct
gradients.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_FUSED_RANK = 256  # ranks of one launch of csrc/lowrank_fused.cu (a chunk)
FUSED_MIN_ROWS = 256  # below this the two plain products stay (decode-sized calls)
TILE_M, TILE_N = 64, 128  # rows a block, columns of an output tile (both bodies)
MAX_CLUSTER = 8  # blocks of a thread-block cluster (portable size), bf16 body


@dataclasses.dataclass(frozen=True)
class LowrankPlan:
    """How the fused kernel is launched: the rank padded to ``rank_pad``
    columns of h, a row tile's output tiles dealt to ``splits`` blocks of
    ``tiles_per_split`` each, ``grid`` = (row tiles, splits) of 256-thread
    blocks, and the dynamic shared memory a block takes."""
    rank_pad: int
    splits: int
    tiles_per_split: int
    grid: Tuple[int, int]
    smem_bytes: int


def pick_splits(row_tiles: int, n_tiles: int, k: int, sms: int, cluster: bool = False) -> int:
    """The number of blocks that share one row tile's output tiles: the
    count that minimises waves x (depth of h's product a block + columns per
    block), fewest splits on a tie. Without ``cluster`` (the fp32 body) every
    block computes h over all of k. With it (the bf16 body) the splits are one
    thread-block cluster of at most :data:`MAX_CLUSTER` that shares k's
    32-deep slices between them."""
    best, best_cost = 1, None
    for s in range(1, (min(n_tiles, MAX_CLUSTER) if cluster else n_tiles) + 1):
        per = -(-n_tiles // s)
        if -(-n_tiles // per) != s:  # the same split as a smaller s
            continue
        depth = -(-k // (32 * s)) * 32 if cluster else k
        cost = -(-(row_tiles * s) // sms) * (depth + per * TILE_N)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def rank_chunks(r: int) -> List[Tuple[int, int]]:
    """The rank columns [c0, c1) of each launch: chunks of
    :data:`MAX_FUSED_RANK`, the last one holding the rest."""
    return [(c0, min(c0 + MAX_FUSED_RANK, r)) for c0 in range(0, r, MAX_FUSED_RANK)]


def lowrank_plans(m: int, k: int, r: int, n: int, dtype: torch.dtype,
                  sms: int) -> List[LowrankPlan]:
    """One launch plan per rank chunk of :func:`rank_chunks`: the plan of
    ``r`` for one chunk; for more, every chunk takes the plan of 256 ranks
    (the last one's padded columns are zero-filled), so that the chained
    epilogue is compiled into one instance of the kernel and the others
    keep their registers."""
    if r <= 0:
        raise ValueError(f"the fused low-rank kernel needs a rank of 1 or more, got {r}")
    return [lowrank_plan(m, k, min(r, MAX_FUSED_RANK), n, dtype, sms)] * len(rank_chunks(r))


def lowrank_plan(m: int, k: int, r: int, n: int, dtype: torch.dtype, sms: int) -> LowrankPlan:
    """One launch's plan (``r`` at most 256, a rank chunk), a pure function
    of the shapes and the SM count; csrc/lowrank_fused.cu refuses any other. bf16
    (lowrank_fused_mma_kernel): rank padded to a multiple of 32, four
    pipeline stages (32-deep slices of x and A, or 64-deep slices of B), h and a y
    staging tile, all bf16 with rows padded by 8; the splits of a row tile
    are one cluster. fp32 (lowrank_fused_kernel):
    rank padded to 32, 64, 128, 192 or 256, fp32 h and staging tiles."""
    if not 0 < r <= MAX_FUSED_RANK:
        raise NotImplementedError(
            f"the fused low-rank kernel takes ranks 1 to {MAX_FUSED_RANK}, got {r}")
    if dtype == torch.bfloat16:
        rank_pad = 32 * -(-r // 32)
        stage = max(TILE_M * 40 + 32 * (rank_pad + 8), 64 * (TILE_N + 8))
        smem = 2 * (4 * stage + TILE_M * (rank_pad + 8) + TILE_M * (TILE_N + 8))
    else:
        rank_pad = next(c for c in (32, 64, 128, 192, 256) if r <= c)
        smem = 4 * (TILE_M * (rank_pad + 4) + max(TILE_M * 33 + 32 * rank_pad, 32 * TILE_N))
    row_tiles, n_tiles = -(-m // TILE_M), -(-n // TILE_N)
    splits = pick_splits(row_tiles, n_tiles, k, sms, cluster=dtype == torch.bfloat16)
    per = -(-n_tiles // splits)
    return LowrankPlan(rank_pad, splits, per, (row_tiles, splits), smem)


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
    if min(x.numel(), a.numel(), b.numel()) == 0:
        raise ValueError("the fused low-rank kernel needs non-empty x, a and b")


def _forward_cuda(x2d: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  plan: Optional[LowrankPlan] = None) -> torch.Tensor:
    """Launch the kernel once per rank chunk with the plans of
    :func:`lowrank_plans` for the card (``plan``: the plan of a call of a
    single chunk). A chunk adds the fp32 sum of the chunks before it; for
    bf16 all but the last write that sum to an fp32 buffer, and the last
    rounds it to y once; fp32 chains the sum through y itself."""
    from grasp_tpu_torch.ops._build import load_library

    lib = load_library()
    m, k = x2d.shape
    r, n = b.shape
    chunks = rank_chunks(r)
    if plan is not None and len(chunks) != 1:
        raise ValueError("a plan is given for a call of one rank chunk only")
    plans = [plan] if plan is not None else lowrank_plans(
        m, k, r, n, x2d.dtype, torch.cuda.get_device_properties(x2d.device).multi_processor_count)
    y = torch.empty((m, n), dtype=x2d.dtype, device=x2d.device)
    bf16_chain = x2d.dtype == torch.bfloat16 and len(chunks) > 1
    acc = torch.empty((m, n), dtype=torch.float32, device=x2d.device) if bf16_chain else y
    size = a.element_size()
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        for i, ((c0, c1), p) in enumerate(zip(chunks, plans)):
            out = acc if bf16_chain and i < len(chunks) - 1 else y
            rc = lib.grasp_lowrank_fused(
                x2d.data_ptr(), a.data_ptr() + c0 * size, b.data_ptr() + c0 * n * size,
                out.data_ptr(), acc.data_ptr() if i else None, m, k, c1 - c0, r, n,
                _DTYPE_CODES[x2d.dtype], int(out is not y), p.rank_pad, p.splits,
                p.tiles_per_split, p.smem_bytes, stream)
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
    a [k, r], b [r, n], one dtype (fp32 or bf16), contiguous; a rank above
    256 takes one launch per chunk of :func:`rank_chunks`.

    CPU tensors take :func:`fused_lowrank_plain` (differentiated by
    autograd). CUDA tensors launch the kernel on the current stream, or
    raise; there is no fallback. The backward is plain matrix products.
    ``fused_lowrank.launches`` counts kernel launches (one per rank chunk)."""
    if x.device.type == "cpu":
        return fused_lowrank_plain(x, a, b)
    if x.device.type != "cuda":
        raise ValueError(f"the fused low-rank kernel runs on cpu or cuda, not {x.device}")
    _check_cuda_args(x, a, b)
    return _FusedLowrank.apply(x, a, b)


fused_lowrank.launches = 0


def takes_fused(x: torch.Tensor, use_fused: bool) -> bool:
    """The dispatch rule of :func:`lowrank_apply`: the flag, 256 rows or
    more, CUDA tensors."""
    rows = x.numel() // max(x.shape[-1], 1)
    return use_fused and rows >= FUSED_MIN_ROWS and x.device.type == "cuda"


def lowrank_apply(x: torch.Tensor, in_kernel: torch.Tensor, out_kernel: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, use_fused: bool = False) -> torch.Tensor:
    """Compiled GRASP low-rank projection: y = (x @ in_kernel) @ out_kernel
    (+ bias); in_kernel [in, r], out_kernel [r, out] with sigma fused in.

    use_fused=True sends calls of 256 rows or more on CUDA tensors through
    :func:`fused_lowrank` (any rank); decode-sized calls
    and CPU tensors keep the two plain products, where the flag is inert."""
    if takes_fused(x, use_fused):
        # autograd and the model's views hand over strided tensors
        y = fused_lowrank(x.contiguous(), in_kernel.contiguous(), out_kernel.contiguous())
    else:
        y = torch.matmul(torch.matmul(x, in_kernel), out_kernel)
    return y + bias if bias is not None else y
