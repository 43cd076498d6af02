"""Causal flash attention: the CUDA kernels and their plain version.

Counterpart of grasp_tpu/ops/pallas_attention.py. The kernels
(csrc/flash_attention.cu: forward, dK/dV, dQ) stream K/V in tiles and never
write an [S, S] matrix to device memory; bf16 runs on the tensor cores, fp32 on
CUDA cores; the plain version materialises the fp32 scores the way the JAX
package's ``_xla_reference`` does.
:func:`flash_attention` is a ``torch.autograd.Function`` for CUDA tensors and
takes the plain version only for CPU tensors.

Unlike the JAX call site, which drops the model's attention scale, the scale
is a required argument here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 96, 128, 256)
_MAX_HEADS = 65535  # batch * heads is one grid axis of the kernels
_KEY_TILE = 64  # keys per tile in both forward bodies


def out_cols(hd: int, dtype: torch.dtype) -> int:
    """Output columns a block of the bf16 kernels owns (csrc/flash_attention.cu,
    out_cols): all of them up to head_dim 128, half at 256, where the
    accumulators of all 256 would not fit the registers; the fp32 bodies keep
    every column."""
    return 128 if hd > 128 and dtype == torch.bfloat16 else hd


def fp32_step(hd: int) -> int:
    """Rows of the fp32 backward's streamed tiles (csrc/flash_attention.cu,
    fp32_step): 64, and 32 at head_dim 256 for shared memory."""
    return 32 if hd > 128 else 64


@dataclasses.dataclass(frozen=True)
class FlashFwdPlan:
    """How the forward kernel is launched: ``block_m`` query rows a block,
    ``grid`` = (query tiles, batch * heads), ``col_blocks`` blocks of
    :func:`out_cols` columns each along a third grid axis, and the dynamic
    shared memory a block takes."""
    block_m: int
    grid: Tuple[int, int]
    smem_bytes: int
    col_blocks: int = 1


def flash_fwd_plan(batch: int, nh: int, s: int, hd: int, dtype: torch.dtype) -> FlashFwdPlan:
    """The forward's launch plan, a pure function of the shapes;
    csrc/flash_attention.cu refuses any other. Both bodies take 64
    query rows a block, longest first. fp32 (flash_fwd_kernel): 256 threads,
    fp32 Q, K, V and P tiles with rows padded by 4. bf16
    (flash_fwd_mma_kernel): 4 warps of 16 rows; a Q tile and two stages of K
    and V tiles in bf16 with rows padded by 8. The SM count does not enter:
    128 rows a block were slower on an H100 at the calibration shape, where
    they too filled the card (PERF.md, Findings). At head_dim 256 a bf16
    block owns half the output columns (:func:`out_cols`) and the fp32 tiles
    take 217,088 B, one block an SM."""
    block_m = 64
    if dtype == torch.float32:
        smem = (3 * block_m * (hd + 4) + block_m * (_KEY_TILE + 4)) * 4
    else:
        smem = (block_m + 4 * _KEY_TILE) * (hd + 8) * 2
    return FlashFwdPlan(block_m, (-(-s // block_m), batch * nh), smem,
                        hd // out_cols(hd, dtype))


@dataclasses.dataclass(frozen=True)
class FlashBwdPlan:
    """How the two backward kernels are launched. dQ: ``dq_block_m`` query
    rows a block, ``dq_block_n`` keys a step, ``dq_grid``, ``dq_threads``,
    ``dq_smem_bytes``. dK/dV: ``dkv_block_n`` keys a block, ``dkv_block_m``
    queries a step, ``dkv_grid``, ``dkv_threads``, ``dkv_smem_bytes``; then
    ``reduce_blocks`` blocks of ``reduce_threads`` that add each group's
    partials (0: the group is summed inside a block), from a workspace of
    ``workspace_bytes``. Grids are (x, y) as launched, with ``col_blocks``
    blocks of :func:`out_cols` columns along z in the bf16 kernels."""
    dq_block_m: int
    dq_block_n: int
    dq_grid: Tuple[int, int]
    dq_threads: int
    dq_smem_bytes: int
    dkv_block_n: int
    dkv_block_m: int
    dkv_grid: Tuple[int, int]
    dkv_threads: int
    dkv_smem_bytes: int
    reduce_blocks: int
    reduce_threads: int
    workspace_bytes: int
    col_blocks: int = 1


def flash_bwd_plan(batch: int, nh: int, nkv: int, s: int, hd: int,
                   dtype: torch.dtype) -> FlashBwdPlan:
    """The backward's launch plan, a pure function of the shapes;
    csrc/flash_attention.cu refuses any other. The SM count does not enter.

    bf16 (flash_dq_mma_kernel, flash_dkv_mma_kernel; 4 warps of 16 rows):
    dQ takes 64 query rows a block over (batch * heads, query tiles), key
    steps of 64 at hd 64 and 32 at hd 96 and 128 (the registers of 96 or 128
    dQ columns leave no room for a wider step); dK/dV takes 64 keys a block for one q
    head over (batch * heads, key tiles), query steps of the same widths,
    fp32 partials of every q head in a workspace of 2 x B * nh * S * hd
    floats, and a second pass that adds each group's partials, 4 values a
    thread. Shared memory: the resident tiles (Q and dO, or K and V) and two
    stages of the streamed ones, bf16 rows padded by 8, and for dK/dV the
    lse and di rows of both stages.
    fp32 (flash_dq_kernel, flash_dkv_kernel; 256 threads): resident tiles of
    64 rows and streamed ones of :func:`fp32_step` rows in fp32, the dK/dV
    block over (key tiles, batch * kv heads) summing its group itself.
    At head_dim 256 the bf16 blocks own half the dQ, dK and dV columns
    (``col_blocks`` 2, steps of 32)."""
    tiles = -(-s // 64)
    if dtype == torch.float32:
        nb = fp32_step(hd)
        return FlashBwdPlan(
            dq_block_m=64, dq_block_n=nb, dq_grid=(tiles, batch * nh), dq_threads=256,
            dq_smem_bytes=(2 * (64 + nb) * (hd + 4) + 64 * (nb + 4)) * 4,
            dkv_block_n=64, dkv_block_m=nb, dkv_grid=(tiles, batch * nkv), dkv_threads=256,
            dkv_smem_bytes=(2 * (64 + nb) * (hd + 4) + 2 * 64 * (nb + 4)) * 4,
            reduce_blocks=0, reduce_threads=0, workspace_bytes=0)
    step = 64 if hd == 64 else 32
    tiles_bytes = (2 * 64 + 4 * step) * (hd + 8) * 2
    total4 = batch * nkv * s * hd // 4
    return FlashBwdPlan(
        dq_block_m=64, dq_block_n=step, dq_grid=(batch * nh, tiles), dq_threads=128,
        dq_smem_bytes=tiles_bytes,
        dkv_block_n=64, dkv_block_m=step, dkv_grid=(batch * nh, tiles), dkv_threads=128,
        dkv_smem_bytes=tiles_bytes + 4 * step * 4,
        reduce_blocks=-(-total4 // 256), reduce_threads=256,
        workspace_bytes=2 * batch * nh * s * hd * 4, col_blocks=hd // out_cols(hd, dtype))


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              num_kv_groups: int, sm_scale: float) -> torch.Tensor:
    """Plain PyTorch version, differentiable by autograd: fp32 scores, causal
    mask, fp32 softmax, GQA by ``repeat_interleave``. q [B, nh, S, hd], k/v
    [B, nkv, S, hd]; returns [B, nh, S, hd] in q's dtype."""
    if num_kv_groups > 1:
        k = k.repeat_interleave(num_kv_groups, dim=1)
        v = v.repeat_interleave(num_kv_groups, dim=1)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    s = q.shape[-2]
    keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def _check_cuda_args(q, k, v, num_kv_groups: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"q, k and v must share one dtype (q {q.dtype}, {name} {t.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (16-byte loads)")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash attention kernels take float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, nh, s, hd = q.shape
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != hd:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} "
                         "(self-attention over one full sequence)")
    if hd not in _HEAD_DIMS:
        raise NotImplementedError(
            f"the flash attention kernels support head_dim {_HEAD_DIMS}, not {hd}")
    nkv = k.shape[1]
    if nh % nkv or nh // nkv != num_kv_groups:
        raise ValueError(f"{nh} query heads over {nkv} kv heads do not make "
                         f"num_kv_groups={num_kv_groups}")
    if b * nh > _MAX_HEADS:
        raise NotImplementedError(f"batch * heads = {b * nh} exceeds {_MAX_HEADS}")
    if b == 0 or s == 0:
        raise ValueError("flash attention needs a non-empty batch and sequence")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"flash attention {what} kernel launch failed: cudaError {rc}")


def _forward_cuda(q, k, v, sm_scale: float,
                  plan: Optional[FlashFwdPlan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel with ``plan`` (default: :func:`flash_fwd_plan`
    for the card). Returns (o, lse [B, nh, S] fp32)."""
    from grasp_tpu_torch.ops._build import load_library

    lib = load_library()
    b, nh, s, hd = q.shape
    if plan is None:
        plan = flash_fwd_plan(b, nh, s, hd, q.dtype)
    o = torch.empty_like(q)
    lse = torch.empty((b, nh, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.grasp_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, nh, k.shape[1], s, hd, _DTYPE_CODES[q.dtype], plan.block_m, plan.smem_bytes,
            float(sm_scale), stream)
    _raise_on(rc, "forward")
    flash_attention.launches["fwd"] += 1
    return o, lse


def _launch_dkv(lib, q, k, v, dout, lse, di, dk, dv, sm_scale: float, plan: FlashBwdPlan,
                workspace: Optional[torch.Tensor]) -> None:
    """The dK/dV kernel (and, for bf16, its group-sum pass) on the current
    stream; counts nothing."""
    b, nh, s, hd = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.grasp_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), di.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), None if workspace is None else workspace.data_ptr(),
        b, nh, k.shape[1], s, hd, _DTYPE_CODES[q.dtype], plan.dkv_block_n, plan.dkv_block_m,
        plan.dkv_smem_bytes, plan.reduce_blocks, float(sm_scale), stream)
    _raise_on(rc, "dK/dV")


def _launch_dq(lib, q, k, v, dout, lse, di, dq, sm_scale: float, plan: FlashBwdPlan) -> None:
    """The dQ kernel on the current stream; counts nothing."""
    b, nh, s, hd = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.grasp_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), di.data_ptr(),
        dq.data_ptr(), b, nh, k.shape[1], s, hd, _DTYPE_CODES[q.dtype], plan.dq_block_m,
        plan.dq_block_n, plan.dq_smem_bytes, float(sm_scale), stream)
    _raise_on(rc, "dQ")


def _backward_cuda(q, k, v, o, lse, dout, sm_scale: float, plan: Optional[FlashBwdPlan] = None):
    """di = sum(o * dO) in plain torch, as the JAX package leaves it to XLA,
    then the dK/dV and dQ kernels with ``plan`` (default:
    :func:`flash_bwd_plan`)."""
    from grasp_tpu_torch.ops._build import load_library

    lib = load_library()
    b, nh, s, hd = q.shape
    if plan is None:
        plan = flash_bwd_plan(b, nh, k.shape[1], s, hd, q.dtype)
    dout = dout.contiguous()
    if dout.dtype != q.dtype or dout.data_ptr() % 16:
        raise ValueError("the output gradient must have q's dtype and 16-byte alignment")
    di = (o.float() * dout.float()).sum(dim=-1).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    workspace = (torch.empty(plan.workspace_bytes // 4, dtype=torch.float32, device=q.device)
                 if plan.workspace_bytes else None)
    with torch.cuda.device(q.device):
        _launch_dkv(lib, q, k, v, dout, lse, di, dk, dv, sm_scale, plan, workspace)
        flash_attention.launches["dkv"] += 1
        _launch_dq(lib, q, k, v, dout, lse, di, dq, sm_scale, plan)
        flash_attention.launches["dq"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        o, lse = _forward_cuda(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward_cuda(q, k, v, o, lse, dout, ctx.sm_scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_kv_groups: int,
                    sm_scale: float) -> torch.Tensor:
    """Causal self-attention over one full sequence. q [B, nh, S, hd], k/v
    [B, nkv, S, hd] with nh = nkv * num_kv_groups; returns [B, nh, S, hd].

    CPU tensors take :func:`flash_attention_reference`. CUDA tensors launch
    the kernels on the current stream (forward now; dK/dV and dQ when
    autograd runs the backward), or raise; there is no fallback.
    ``flash_attention.launches`` counts launches of each kernel."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, num_kv_groups, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    _check_cuda_args(q, k, v, num_kv_groups)
    return _FlashAttention.apply(q, k, v, float(sm_scale))


flash_attention.launches = {"fwd": 0, "dkv": 0, "dq": 0}
