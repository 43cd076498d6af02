"""Fused nibble-packed int4 matmul for decode: the CUDA kernels and their plain version.

Counterpart of grasp_tpu/ops/pallas_int4.py. Decoding is bound by the weight
bytes read per token; a dequantize-then-multiply materialises the weight in
the activation dtype, four times the packed bytes. The kernels
(csrc/int4_matmul.cu) read the packed int8 once, expand the nibbles in
registers and apply the per-(group, column) scales to per-group partial sums:

    y[:, c] = sum_g (x_g @ nibbles_g[:, c]) * scale[g, c]

Layout contract (ops/quant.quantize_int4): the contraction dim is zero-padded
to a multiple of the group size ``gs``; byte i holds row 2i in its low nibble
and row 2i+1 in its high nibble. The kernels take at most 64 rows of x and
``gs % 128 == 0``; :func:`grasp_tpu_torch.ops.quant.quant_matmul_int4` sends
everything else to a dequantized dense product.

Two variants of one function, chosen by ``kernel`` or ``GRASP_INT4_KERNEL``:
``"grid"`` (default; any output width) and ``"dma"`` (chunks of whole groups
double-buffered into shared memory with ``cp.async``; output widths that are
multiples of 128, other widths take the grid kernel). :func:`int4_matmul`
launches a kernel for CUDA tensors and takes :func:`int4_matmul_plain` only for
CPU tensors.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from grasp_tpu_torch.ops.quant import (
    INT4_KERNEL_MAX_ROWS, int4_geometry, int4_group_size, unpack_int4)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {"grid": 0, "dma": 1}
_COLS_PER_BLOCK = 128
_TARGET_BLOCKS = 264  # two per SM of an H100: the contraction is split until then
# packed bytes one block of the dma variant buffers per chunk (it holds two):
# shared memory bounds it, where the TPU variant had a megabyte of VMEM
DMA_CHUNK_BYTES = 16384


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version with the kernels' order of operations: one fp32
    dot per contraction group, times the group's scales, summed over groups,
    cast to x's dtype. x [..., in]; returns [..., out]."""
    in_f = x.shape[-1]
    g, gs, in_pad = int4_geometry(in_f, packed, scale)
    out_f = packed.shape[1]
    xm = x.reshape(-1, in_f).float()
    if in_pad != in_f:
        xm = F.pad(xm, (0, in_pad - in_f))
    x3 = xm.reshape(-1, g, gs).transpose(0, 1)              # [g, m, gs]
    rhs = unpack_int4(packed).float().reshape(g, gs, out_f)
    pd = torch.bmm(x3, rhs)                                 # [g, m, out] fp32
    y = (pd * scale.float()[:, None, :]).sum(dim=0)
    return y.to(x.dtype).reshape(*x.shape[:-1], out_f)


def dma_chunking(g: int, gs: int) -> Tuple[int, int]:
    """(groups per chunk, chunks) of the dma variant: the largest divisor of
    ``g`` whose chunk (at 128 columns) stays within DMA_CHUNK_BYTES, at least
    one group."""
    bytes_per_group = (gs // 2) * _COLS_PER_BLOCK
    gpc = min(max(1, DMA_CHUNK_BYTES // bytes_per_group), g)
    while g % gpc:
        gpc -= 1
    return gpc, g // gpc


def _splits(pieces: int, col_tiles: int) -> int:
    """How many blocks share one column tile's contraction of ``pieces``
    whole groups (or chunks), evened out so that no split is empty."""
    want = min(pieces, max(1, -(-_TARGET_BLOCKS // col_tiles)))
    per = -(-pieces // want)
    return -(-pieces // per)


@functools.lru_cache(maxsize=None)
def _launch_plan(m: int, in_f: int, p_rows: int, out_f: int, g: int, variant: str,
                 aligned: bool) -> Tuple[int, str, int, int]:
    """(group size, variant that runs, splits, groups per chunk) for one
    call shape; cached, since a decode step repeats a handful of shapes and
    the step is bound by the host."""
    if variant not in _VARIANTS:
        raise ValueError(f"kernel must be one of {sorted(_VARIANTS)}, got {variant!r}")
    gs = int4_group_size(in_f, p_rows, g)
    if not 1 <= m <= INT4_KERNEL_MAX_ROWS:
        raise ValueError(f"int4 matmul kernels take 1 to {INT4_KERNEL_MAX_ROWS} rows, got {m}")
    if gs % 128:
        raise ValueError(f"int4 matmul kernels need a group size that is a multiple of 128, "
                         f"got {gs}")
    if variant == "dma" and (out_f % _COLS_PER_BLOCK or not aligned):
        variant = "grid"  # the grid kernel handles every shape
    col_tiles = -(-out_f // _COLS_PER_BLOCK)
    if variant == "dma":
        gpc, n_chunks = dma_chunking(g, gs)
        # at least two chunks per block where there are two, or nothing overlaps
        return gs, variant, _splits(max(1, n_chunks // 2), col_tiles), gpc
    return gs, variant, _splits(g, col_tiles), 0


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                kernel: Optional[str] = None) -> torch.Tensor:
    """y = x @ dequant(packed, scale); x [..., in] fp32 or bf16, packed int8
    [in_pad/2, out], scale fp32 [g, out]. Returns [..., out] in x's dtype.

    kernel: "grid" or "dma"; default the environment's GRASP_INT4_KERNEL,
    else "grid". CPU tensors take :func:`int4_matmul_plain`. CUDA tensors
    launch on the current stream, or raise; there is no fallback.
    ``int4_matmul.launches`` counts launches by variant."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int4 matmul runs on cpu or cuda, not {x.device}")
    for name, t, dtype in (("packed", packed, torch.int8), ("scale", scale, torch.float32)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"int4 matmul kernels take float32 or bfloat16, got {x.dtype}")
    for name, t in (("x", x), ("packed", packed), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if packed.dim() != 2 or scale.dim() != 2 or packed.shape[1] != scale.shape[1] \
            or x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, packed {tuple(packed.shape)}, "
                         f"scale {tuple(scale.shape)}")
    in_f = x.shape[-1]
    p_rows, out_f = packed.shape
    g = scale.shape[0]
    m = x.numel() // in_f
    gs, variant, splits, gpc = _launch_plan(
        m, in_f, p_rows, out_f, g, kernel or os.environ.get("GRASP_INT4_KERNEL", "grid"),
        packed.data_ptr() % 16 == 0)

    from grasp_tpu_torch.ops._build import load_library

    lib = load_library()
    y = torch.empty((*x.shape[:-1], out_f), dtype=x.dtype, device=x.device)
    partial = (torch.empty((splits, m, out_f), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    with torch.cuda.device(x.device):
        rc = lib.grasp_int4_matmul(
            x.data_ptr(), packed.data_ptr(), scale.data_ptr(), y.data_ptr(),
            partial.data_ptr() if partial is not None else None, m, in_f, out_f, g, gs,
            _DTYPE_CODES[x.dtype], _VARIANTS[variant], splits, gpc,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int4 matmul ({variant}) kernel launch failed: cudaError {rc}")
    int4_matmul.launches[variant] += 1
    return y


int4_matmul.launches = {"grid": 0, "dma": 0}
